"""Camera model and primary rays (``wasm_pathtracer_tpu.models.camera``).

The camera rotates around x, then around y, then translates; the virtual
screen sits at z = +0.8 with x scaled by the aspect ratio and y flipped
(pixel (0, 0) is top-left).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wasm_pathtracer_tpu_torch.utils import vecmath as vm
from wasm_pathtracer_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    location: torch.Tensor  # (3,) f32
    rot_x: torch.Tensor     # () f32
    rot_y: torch.Tensor     # () f32

    @staticmethod
    def create(location, rot_x=0.0, rot_y=0.0, device=None) -> "Camera":
        device = resolve_device(device)
        def f32(v):
            return torch.tensor(np.asarray(v, np.float32), device=device)
        return Camera(location=f32(location), rot_x=f32(rot_x),
                      rot_y=f32(rot_y))

    def to(self, device) -> "Camera":
        return Camera(self.location.to(device), self.rot_x.to(device),
                      self.rot_y.to(device))


def camera_from_numpy(location, rot_x, rot_y, device=None) -> Camera:
    """The port's camera from the JAX package's ``Camera`` fields read
    with ``np.asarray``."""
    return Camera.create(location, rot_x, rot_y, device=device)


def primary_rays(camera: Camera, px, py, jx, jy, width: int, height: int,
                 screen_z: float = 0.8):
    """Primary rays for pixel indices ``(px, py)`` with in-pixel jitter
    ``(jx, jy)`` in [0, 1):

      fx = ((x + jx) / w - 0.5) * aspect
      fy = 0.5 - (y + jy) / h
      dir = normalize((fx, fy, 0.8)).rot_x(cam.rot_x).rot_y(cam.rot_y)

    Returns (origins (..., 3), directions (..., 3)).
    """
    fw = np.float32(width)
    fh = np.float32(height)
    ar = float(fw / fh)
    fx = ((px.to(torch.float32) + jx) / float(fw) - 0.5) * ar
    fy = 0.5 - (py.to(torch.float32) + jy) / float(fh)
    pixel = torch.stack([fx, fy, torch.full_like(fx, screen_z)], dim=-1)
    d = vm.normalize(pixel)
    d = vm.rot_x(d, camera.rot_x)
    d = vm.rot_y(d, camera.rot_y)
    o = camera.location.expand(d.shape)
    return o, d


# Per-scene initial cameras.
INITIAL_CAMERAS = {
    0: dict(location=(0.0, 16.34, -23.76), rot_x=0.54, rot_y=0.0),   # museum
    1: dict(location=(-0.9, 5.4, 0.4), rot_x=0.58, rot_y=0.0),       # bunny (low)
    2: dict(location=(-0.9, 5.4, 0.4), rot_x=0.58, rot_y=0.0),       # bunny (high)
    3: dict(location=(0.0, 0.5, -2.0), rot_x=0.05, rot_y=0.0),
    4: dict(location=(0.0, 0.5, -2.0), rot_x=0.05, rot_y=0.0),
    5: dict(location=(0.0, 0.5, -2.0), rot_x=0.05, rot_y=0.0),
}


def initial_camera(scene_id: int, device=None) -> Camera:
    cfg = INITIAL_CAMERAS.get(scene_id, dict(location=(0.0, 0.0, 0.0),
                                             rot_x=0.0, rot_y=0.0))
    return Camera.create(**cfg, device=device)
