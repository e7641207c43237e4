"""Key-driven camera navigation (``wasm_pathtracer_tpu.runtime.camera_controller``).

WASD translates across the plane, PageUp/PageDown moves vertically, the
arrow keys rotate.  A translation is rotated into the camera frame
(by ``rot_x``, then ``rot_y``) before it is applied, so "forward"
follows the view direction.  A key tick moves 0.03 units or turns
0.001 * pi radians; callers pass ``count`` for several ticks at once.
Any front end (a request handler, a notebook widget) can drive it.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from wasm_pathtracer_tpu_torch.models.camera import Camera
from wasm_pathtracer_tpu_torch.utils import vecmath as vm

_MOVE = 0.03
_ROT = 0.001 * np.pi

# key -> (translation vector | None, d_rot_x, d_rot_y)
_BINDINGS = {
    "w": ((0.0, 0.0, _MOVE), 0.0, 0.0),        # forward
    "s": ((0.0, 0.0, -_MOVE), 0.0, 0.0),       # backward
    "d": ((_MOVE, 0.0, 0.0), 0.0, 0.0),        # right
    "a": ((-_MOVE, 0.0, 0.0), 0.0, 0.0),       # left
    "pageup": ((0.0, _MOVE, 0.0), 0.0, 0.0),   # up
    "pagedown": ((0.0, -_MOVE, 0.0), 0.0, 0.0),
    "left": (None, 0.0, -_ROT),
    "right": (None, 0.0, _ROT),
    "up": (None, -_ROT, 0.0),
    "down": (None, _ROT, 0.0),
}


class CameraController:
    """Holds a camera and moves it by key; ``on_update`` is called with
    each new camera (not by :meth:`set_silent`).  Cameras are made on
    the device of the one given."""

    def __init__(self, camera: Camera,
                 on_update: Optional[Callable[[Camera], None]] = None):
        self._camera = camera
        self._on_update = on_update

    @property
    def camera(self) -> Camera:
        return self._camera

    def set(self, camera: Camera):
        self._camera = camera
        self._notify()

    def set_silent(self, camera: Camera):
        """Replace the camera without calling ``on_update``: for scene
        switches, where the session resets its own camera and a deferred
        camera update would clear the fresh accumulator."""
        self._camera = camera

    def key(self, name: str, count: int = 1):
        """Apply ``count`` ticks of the named key (see ``_BINDINGS``);
        an unknown key does nothing."""
        b = _BINDINGS.get(name.lower())
        if b is None:
            return
        trans, drx, dry = b
        c = self._camera
        rx = float(c.rot_x) + drx * count
        ry = float(c.rot_y) + dry * count
        loc = c.location.detach().cpu().numpy().astype(np.float32)
        if trans is not None:
            t = torch.tensor(trans, dtype=torch.float32) * count
            # rotate the step into the camera frame
            t = vm.rot_y(vm.rot_x(t, torch.tensor(rx, dtype=torch.float32)),
                         torch.tensor(ry, dtype=torch.float32))
            loc = loc + t.numpy()
        self._camera = Camera.create(loc, rx, ry, device=c.location.device)
        self._notify()

    def _notify(self):
        if self._on_update is not None:
            self._on_update(self._camera)
