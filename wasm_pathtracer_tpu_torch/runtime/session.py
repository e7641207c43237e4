"""Render session (``wasm_pathtracer_tpu.runtime.session``).

A viewport split into two halves, each a :class:`RenderInstance` with its
own estimator settings, accumulating into one shared buffer.  Each
compute step draws a batch of uniformly random pixels and path-traces
them through the regenerating wavefront: ``integrator.render_queue``,
or ``wavefront.render_queue_flat`` when the scene has a cluster
structure.  Finite families of at least ``bvh_min_triangles`` shapes are
clustered (every finite family with ``use_bvh=True``, none with
``use_bvh=False``).

Not ported yet, and rejected with ``NotImplementedError``: photon NEE
(PNEE) and adaptive sampling.
"""

from __future__ import annotations

import numpy as np
import torch

from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models import scenes as scene_registry
from wasm_pathtracer_tpu_torch.models.camera import Camera, initial_camera
from wasm_pathtracer_tpu_torch.ops import (accum, adaptive, bvh, integrator,
                                           trace, wavefront)
from wasm_pathtracer_tpu_torch.utils import rng as rnglib
from wasm_pathtracer_tpu_torch.utils.png import tonemap_u8


def fold_seed(seed: int, round_: int) -> int:
    """Per-round seed; a pure function of (session seed, round)."""
    x, _, _ = rnglib._pcg3d(int(seed) & 0xFFFFFFFF, int(round_) & 0xFFFFFFFF,
                            0x9E3779B9)
    return x


def resolve_device(device) -> torch.device:
    """The device to render on; asking for CUDA without a card raises
    (a render never moves to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is False")
    return dev


class RenderInstance:
    """One viewport region with its own estimator settings."""

    def __init__(self, session: "Session", x0: int, y0: int,
                 width: int, height: int, settings: RenderSettings):
        if settings.render_type == RenderType.PNEE:
            raise NotImplementedError("photon-guided NEE (PNEE) comes with a "
                                      "later slice of the port")
        if settings.adaptive:
            raise NotImplementedError("adaptive sampling comes with a later "
                                      "slice of the port")
        self.session = session
        self.x0, self.y0 = x0, y0
        self.width, self.height = width, height
        self.settings = settings
        self.round = 0
        self.num_bvh_hits = 0

    def compute(self, num_ticks: int) -> int:
        """Advance ``num_ticks`` paths (whole batches).  Returns the number
        of paths traced."""
        s = self.session
        st = self.settings
        W, H = s.width, s.height
        batch = st.ray_batch_size
        # lanes capped at a quarter of the batch (the session's queue is
        # one batch, so a wide wavefront pays its drain tail every step);
        # an explicit smaller regen_lanes is honoured
        lanes = min(st.regen_lanes, batch, max(1024, batch // 4))
        # decorrelates the halves' RNG streams under the same round seed
        rid_base = 0x40000000 if self.x0 > 0 or self.y0 > 0 else 0
        use_flat = s.prep.cluster is not None and st.use_flat_wavefront is not False
        queue_fn = wavefront.render_queue_flat if use_flat else integrator.render_queue
        traced = 0
        costs = []
        while traced < num_ticks:
            seed = fold_seed(s.seed, self.round)
            px, py = adaptive.random_pixels(batch, seed, self.x0, self.y0,
                                            self.width, self.height, s.device)
            acc_s, cnt_s, cost = queue_fn(
                s.prep, s.scene, st, s.camera, py * W + px, W, H, seed,
                lanes, rid_base=rid_base)
            accum.write_sums(s.buffer, acc_s, cnt_s)
            costs.append(cost.sum())
            self.round += 1
            traced += batch
        # one host read per compute() call, in int64
        if costs:
            self.num_bvh_hits += int(torch.stack(costs).sum())
        return traced

    def reset(self):
        self.num_bvh_hits = 0
        self.round = 0

    def resize(self, x0, y0, width, height):
        self.x0, self.y0, self.width, self.height = x0, y0, width, height
        self.reset()


class Session:
    """A rendering session over a width x height viewport.

    ``left``/``right`` default to NEE with uniform pixel sampling (the
    JAX session's right half defaults to PNEE + adaptive, which the port
    does not have yet).
    """

    def __init__(self, width: int, height: int, scene_id: int = 100,
                 camera: Camera | None = None,
                 left: RenderSettings | None = None,
                 right: RenderSettings | None = None,
                 seed: int = 0xBABABEBE,
                 use_bvh: bool | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.width, self.height = width, height
        self.seed = seed
        self.use_bvh = use_bvh
        self.meshes: dict[int, np.ndarray] = {}
        self.textures: dict[int, np.ndarray] = {}
        self._load_scene(scene_id)
        self.camera = (camera or initial_camera(scene_id)).to(self.device)
        self.buffer = accum.AccumBuffer.create(width, height, self.device)
        left = left or RenderSettings(render_type=RenderType.NORMAL_NEE)
        right = right or RenderSettings(render_type=RenderType.NORMAL_NEE)
        lw = width // 2
        self.left = RenderInstance(self, 0, 0, lw, height, left)
        self.right = RenderInstance(self, lw, 0, width - lw, height, right)

    def _load_scene(self, scene_id: int):
        self.scene = scene_registry.select_scene(scene_id, self.meshes,
                                                 self.textures, self.device)
        self.scene_id = scene_id
        self.prep = self._prepare(self.scene)

    def _prepare(self, scene):
        prep = trace.prepare(scene)
        if self.use_bvh is False:
            return prep
        defaults = RenderSettings()
        min_count = 1 if self.use_bvh else defaults.bvh_min_triangles
        return bvh.attach_clusters(prep, scene, num_bins=defaults.bvh_num_bins,
                                   min_count=min_count)

    def compute(self, num_samples: int) -> int:
        """Ticks split between the halves; returns paths traced."""
        n_left = num_samples // 2
        t = self.left.compute(n_left)
        t += self.right.compute(num_samples - n_left)
        return t

    def results(self) -> np.ndarray:
        """(H, W, 3) uint8 frame."""
        return tonemap_u8(accum.clamped_image(self.buffer).cpu().numpy())

    def image(self) -> np.ndarray:
        """Raw mean-radiance float image."""
        return accum.mean_image(self.buffer).cpu().numpy()

    def reset(self):
        self.buffer = self.buffer.clear()
        self.left.reset()
        self.right.reset()

    def update_scene(self, scene_id: int):
        self._load_scene(scene_id)
        self.reset()

    def update_settings(self, left: RenderSettings, right: RenderSettings):
        lw = self.width // 2
        self.left = RenderInstance(self, 0, 0, lw, self.height, left)
        self.right = RenderInstance(self, lw, 0, self.width - lw,
                                    self.height, right)
        self.buffer = self.buffer.clear()

    def update_viewport(self, width: int, height: int):
        self.width, self.height = width, height
        self.buffer = accum.AccumBuffer.create(width, height, self.device)
        lw = width // 2
        self.left.resize(0, 0, lw, height)
        self.right.resize(lw, 0, width - lw, height)
        self.reset()

    def update_camera(self, location, rot_x: float, rot_y: float):
        self.camera = Camera.create(location, rot_x, rot_y, device=self.device)
        self.reset()

    def store_mesh(self, mesh_id: int, vertices) -> bool:
        """Upload a mesh: ``vertices`` is (V, 3) or (T, 3, 3).  Returns
        True when the current scene uses the mesh (scene id = mesh id + 1)
        and was rebuilt with it."""
        v = np.asarray(vertices, np.float32)
        if v.ndim == 2:
            v = v.reshape(-1, 3, 3)
        if v.ndim != 3 or v.shape[1:] != (3, 3):
            raise ValueError(f"mesh vertices must be (V, 3) or (T, 3, 3), got "
                             f"{np.shape(vertices)}")
        self.meshes[mesh_id] = v
        if self.scene_id == mesh_id + 1:
            self.update_scene(self.scene_id)
            return True
        return False

    @property
    def num_bvh_hits(self) -> int:
        """Total primitive tests so far."""
        return self.left.num_bvh_hits + self.right.num_bvh_hits
