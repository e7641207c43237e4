"""Render session (``wasm_pathtracer_tpu.runtime.session``).

A viewport split into two halves, each a :class:`RenderInstance` with its
own estimator settings, accumulating into one shared buffer.  Each
compute step draws a batch of pixels, uniformly at random or by the
variance-guided allocator (``settings.adaptive``), and path-traces them
through the regenerating wavefront: ``integrator.render_queue``, or
``wavefront.render_queue_flat`` when the scene has a cluster structure.
A PNEE instance first spends its ticks on photons, ``photons_per_tick``
a tick, until its grid holds ``total_photons``.  Finite families of at
least ``bvh_min_triangles`` shapes are clustered (every finite family
with ``use_bvh=True``, none with ``use_bvh=False``).
"""

from __future__ import annotations

import numpy as np
import torch

from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models import scenes as scene_registry
from wasm_pathtracer_tpu_torch.models.camera import Camera, initial_camera
from wasm_pathtracer_tpu_torch.ops import (accum, adaptive, bvh, integrator,
                                           photon, trace, wavefront)
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
    """One viewport region with its own estimator settings, sampling
    strategy and, for PNEE, photon grid."""

    def __init__(self, session: "Session", x0: int, y0: int,
                 width: int, height: int, settings: RenderSettings):
        self.session = session
        self.x0, self.y0 = x0, y0
        self.width, self.height = width, height
        self.settings = settings
        self.photon_grid: photon.PhotonGrid | None = None
        if settings.render_type == RenderType.PNEE:
            self._init_photons()
        self.reset()

    # -- photon preprocessing ----------------------------------------------
    def _init_photons(self):
        s = self.session
        lo, hi = photon.grid_bounds_for_scene(s.scene, self.settings)
        self.photon_grid = photon.PhotonGrid.create(
            s.scene.num_lights, lo, hi, self.settings.photon_grid_res, s.device)

    def _photons_done(self) -> bool:
        if self.photon_grid is None:
            return True
        return int(self.photon_grid.num_photons) >= self.settings.total_photons

    # -- ray compute -------------------------------------------------------
    def compute(self, num_ticks: int) -> int:
        """Advance ``num_ticks`` (one tick is one path; a PNEE instance
        spends ticks on photons first).  Paths come in whole batches.
        Returns the number of paths traced."""
        s = self.session
        st = self.settings
        W, H = s.width, s.height
        batch = st.ray_batch_size
        ticks_left = num_ticks

        if st.render_type == RenderType.PNEE:
            while ticks_left > 0 and not self._photons_done():
                seed = fold_seed(s.seed, 0x50000000 + self.round)
                self.photon_grid = photon.emit_photons(
                    self.photon_grid, s.prep, s.scene, st, seed, batch)
                self.round += 1
                ticks_left -= max(batch // st.photons_per_tick, 1)
            if ticks_left <= 0:
                return 0

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
        last_density = None
        while ticks_left > 0:
            seed = fold_seed(s.seed, self.round)
            if st.adaptive:
                # the bootstrap decision comes from the host's own ledger
                # of paths traced: reading the buffer would wait for the
                # device every batch
                bootstrap = (self._rays_traced / max(self.width * self.height, 1)
                             < st.adaptive_bootstrap_spp)
                px, py, density, self._sweep = adaptive.pick_pixels(
                    s.buffer, batch, seed, bootstrap, st.adaptive_spp_scale,
                    self.x0, self.y0, self.width, self.height, sweep_pos=self._sweep)
                last_density = (density, bootstrap)
            else:
                px, py = adaptive.random_pixels(batch, seed, self.x0, self.y0,
                                                self.width, self.height, s.device)
            acc_s, cnt_s, cost = queue_fn(
                s.prep, s.scene, st, s.camera, py * W + px, W, H, seed,
                lanes, photon_grid=self.photon_grid, rid_base=rid_base)
            accum.write_sums(s.buffer, acc_s, cnt_s)
            costs.append(cost.sum())
            self.round += 1
            traced += batch
            self._rays_traced += batch
            ticks_left -= batch
        if last_density is not None:
            s.write_density(self.x0, self.y0, *last_density)
        # one host read per compute() call, in int64
        if costs:
            self.num_bvh_hits += int(torch.stack(costs).sum())
        return traced

    def reset(self):
        """Start the render over; the photons are kept."""
        self.num_bvh_hits = 0
        self.round = 0
        self._rays_traced = 0
        self._sweep = None   # adaptive floor-sweep position (device scalar)

    def update_scene(self):
        """A new scene drops the photon grid."""
        self.photon_grid = None
        if self.settings.render_type == RenderType.PNEE:
            self._init_photons()
        self.reset()

    def resize(self, x0, y0, width, height):
        self.x0, self.y0, self.width, self.height = x0, y0, width, height
        self.reset()


class Session:
    """A rendering session over a width x height viewport.

    ``left`` defaults to NEE with uniform pixel sampling, ``right`` to
    PNEE with adaptive sampling, as in the JAX session.
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
        self._clear_density()
        left = left or RenderSettings(render_type=RenderType.NORMAL_NEE)
        right = right or RenderSettings(render_type=RenderType.PNEE, adaptive=True)
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

    def _clear_density(self):
        """The sampling-density view at its "1 sample per pixel" blue."""
        self.density = np.zeros((self.height, self.width, 3), np.float32)
        self.density[..., 2] = 1.0

    def write_density(self, x0, y0, density, bootstrap):
        """Paint a region of the sampling-density view from its scaled
        error (blue throughout while the region bootstraps)."""
        h, w = density.shape
        self.density[y0:y0 + h, x0:x0 + w] = (0.0, 0.0, 1.0) if bootstrap else \
            accum.mix_color(density).cpu().numpy()

    def compute(self, num_samples: int) -> int:
        """Ticks split between the halves; returns paths traced."""
        n_left = num_samples // 2
        t = self.left.compute(n_left)
        t += self.right.compute(num_samples - n_left)
        return t

    def results(self, show_sampling: bool = False) -> np.ndarray:
        """(H, W, 3) uint8 frame, or the sampling-density view."""
        if show_sampling:
            return tonemap_u8(self.density)
        return tonemap_u8(accum.clamped_image(self.buffer).cpu().numpy())

    def image(self) -> np.ndarray:
        """Raw mean-radiance float image."""
        return accum.mean_image(self.buffer).cpu().numpy()

    def reset(self):
        self.buffer = self.buffer.clear()
        self._clear_density()
        self.left.reset()
        self.right.reset()

    def update_scene(self, scene_id: int):
        self._load_scene(scene_id)
        self.reset()
        self.left.update_scene()
        self.right.update_scene()

    def update_settings(self, left: RenderSettings, right: RenderSettings):
        lw = self.width // 2
        self.left = RenderInstance(self, 0, 0, lw, self.height, left)
        self.right = RenderInstance(self, lw, 0, self.width - lw,
                                    self.height, right)
        self.buffer = self.buffer.clear()
        self._clear_density()

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
