"""Camera and primary rays: a frozen copy of the port's
``models/camera.py``.  The camera rotates around x, then around y, then
translates; the virtual screen sits at z = +0.8 with x scaled by the
aspect ratio and y flipped (pixel (0, 0) is top-left)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import vecmath as vm


@dataclasses.dataclass(frozen=True)
class Camera:
    location: torch.Tensor  # (3,)
    rot_x: torch.Tensor     # ()
    rot_y: torch.Tensor     # ()

    @staticmethod
    def create(location, rot_x, rot_y, device) -> "Camera":
        def f32(v):
            return torch.tensor(np.asarray(v, np.float32), device=device)
        return Camera(f32(location), f32(rot_x), f32(rot_y))


# the upstream viewer's initial camera of each scene
INITIAL_CAMERAS = {
    0: dict(location=(0.0, 16.34, -23.76), rot_x=0.54, rot_y=0.0),
    3: dict(location=(0.0, 0.5, -2.0), rot_x=0.05, rot_y=0.0),
    4: dict(location=(0.0, 0.5, -2.0), rot_x=0.05, rot_y=0.0),
    5: dict(location=(0.0, 0.5, -2.0), rot_x=0.05, rot_y=0.0),
}


def initial_camera(scene_id: int, device) -> Camera:
    return Camera.create(**INITIAL_CAMERAS[scene_id], device=device)


def primary_rays(camera: Camera, px, py, jx, jy, width: int, height: int,
                 screen_z: float = 0.8):
    """(origins, directions) of the rays through pixels (px, py) with
    in-pixel jitter (jx, jy) in [0, 1)."""
    fw, fh = np.float32(width), np.float32(height)
    ar = float(fw / fh)
    fx = ((px.to(torch.float32) + jx) / float(fw) - 0.5) * ar
    fy = 0.5 - (py.to(torch.float32) + jy) / float(fh)
    pixel = torch.stack([fx, fy, torch.full_like(fx, screen_z)], dim=-1)
    d = vm.normalize(pixel)
    d = vm.rot_x(d, camera.rot_x)
    d = vm.rot_y(d, camera.rot_y)
    return camera.location.expand(d.shape), d
