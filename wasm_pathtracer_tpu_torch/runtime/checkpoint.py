"""Checkpoint and resume of a progressive render
(``wasm_pathtracer_tpu.runtime.checkpoint``).

The whole render state (accumulator, sample counts, sampling-density
view, round counters, the adaptive sampler's ledger, photon histograms,
camera) goes to one ``.npz``, so a long render can resume after a
restart.  The keys, shapes and dtypes are the JAX package's: a file
written by either package loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from wasm_pathtracer_tpu_torch.models.camera import Camera
from wasm_pathtracer_tpu_torch.ops import accum, photon

_HALVES = ("left", "right")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def save(path: str, session) -> None:
    data = dict(
        width=session.width,
        height=session.height,
        scene_id=session.scene_id,
        seed=session.seed,
        acc=_host(session.buffer.acc),
        count=_host(session.buffer.count),
        density=session.density,
        cam_location=_host(session.camera.location),
        cam_rot_x=_host(session.camera.rot_x),
        cam_rot_y=_host(session.camera.rot_y),
    )
    for name in _HALVES:
        inst = getattr(session, name)
        data[f"{name}_round"] = inst.round
        # the adaptive sampler's ledger: without it a resumed adaptive
        # render would bootstrap again and lose its sweep position
        data[f"{name}_rays_traced"] = inst._rays_traced
        # the sweep is int32 in the JAX package's files; before the first
        # adaptive batch the port holds None, which is position 0
        data[f"{name}_sweep"] = np.int32(0 if inst._sweep is None else int(inst._sweep))
        data[f"{name}_bvh_hits"] = inst.num_bvh_hits
        g = inst.photon_grid
        if g is not None:
            data[f"{name}_photon_bins"] = _host(g.bins)
            data[f"{name}_photon_lo"] = _host(g.lo)
            data[f"{name}_photon_hi"] = _host(g.hi)
            data[f"{name}_photon_n"] = np.int32(int(g.num_photons))
            data[f"{name}_photon_res"] = g.res
    np.savez_compressed(path, **data)


def load(path: str, session) -> None:
    """Restore the state into an existing session of the same viewport;
    a different scene id switches the session's scene first."""
    z = np.load(path)
    if int(z["width"]) != session.width or int(z["height"]) != session.height:
        raise ValueError(f"checkpoint viewport {int(z['width'])}x{int(z['height'])} "
                         f"does not match the session's {session.width}x{session.height}")
    if int(z["scene_id"]) != session.scene_id:
        session.update_scene(int(z["scene_id"]))
    dev = session.device

    def tensor(key, dtype=torch.float32):
        return torch.tensor(np.asarray(z[key]), dtype=dtype, device=dev)

    session.buffer = accum.AccumBuffer(acc=tensor("acc"), count=tensor("count"))
    session.density = np.array(z["density"], np.float32)
    session.camera = Camera.create(z["cam_location"], float(z["cam_rot_x"]),
                                   float(z["cam_rot_y"]), device=dev)
    for name in _HALVES:
        inst = getattr(session, name)
        inst.round = int(z[f"{name}_round"])
        # older files predate the adaptive ledger
        if f"{name}_rays_traced" in z:
            inst._rays_traced = int(z[f"{name}_rays_traced"])
            inst._sweep = tensor(f"{name}_sweep", torch.int64)
            inst.num_bvh_hits = int(z[f"{name}_bvh_hits"])
        key = f"{name}_photon_bins"
        if key in z:
            # a new grid: its sampling tables are built again at first use
            inst.photon_grid = photon.photon_grid_from_numpy(
                dict(bins=z[key], lo=z[f"{name}_photon_lo"], hi=z[f"{name}_photon_hi"],
                     num_photons=z[f"{name}_photon_n"]),
                int(z[f"{name}_photon_res"]), dev)
