"""Render session (``wasm_pathtracer_tpu.runtime.session``).

A viewport split into two halves, each a :class:`RenderInstance` with its
own estimator settings, accumulating into one shared buffer.  Each
compute step draws a batch of pixels, uniformly at random or by the
variance-guided allocator (``settings.adaptive``), and path-traces them
through the regenerating wavefront: ``integrator.render_queue``, or
``wavefront.render_queue_flat`` when the scene has a cluster structure.
With ``use_regen`` or ``early_exit`` off it renders one sample a picked
pixel through ``integrator.render_pixels`` instead, as the JAX session
does.
A PNEE instance first spends its ticks on photons, ``photons_per_tick``
a tick, until its grid holds ``total_photons``.  Finite families of at
least ``bvh_min_triangles`` shapes are clustered (every finite family
with ``use_bvh=True``, none with ``use_bvh=False``).

Over a mesh of n ranks (``mesh``, ``parallel.shard.RayMesh``; one process
a card) a half's batch is n x ``ray_batch_size`` paths: every rank draws
the same picks from its copy of the buffer, traces its contiguous shard
of the queue through ``shard.render_queue_sharded`` (or
``render_queue_flat_sharded``) with global path keys, and adds the
all-reduced sums to its buffer, so the buffer, the picks, the photon
grids (emitted alike on every rank) and the ledger of paths stay equal
on every rank.  ``ray_batch_size`` is thus each rank's share, and the
session renders what one rank would with a batch n times as large.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models import scenes as scene_registry
from wasm_pathtracer_tpu_torch.models.camera import Camera, initial_camera
from wasm_pathtracer_tpu_torch.ops import (accum, adaptive, bvh, integrator,
                                           photon, trace, wavefront)
from wasm_pathtracer_tpu_torch.parallel import shard
from wasm_pathtracer_tpu_torch.utils import rng as rnglib
from wasm_pathtracer_tpu_torch.utils.device import resolve_device
from wasm_pathtracer_tpu_torch.utils.png import tonemap_u8
from wasm_pathtracer_tpu_torch.utils.spans import span


def fold_seed(seed: int, round_: int) -> int:
    """Per-round seed; a pure function of (session seed, round)."""
    x, _, _ = rnglib._pcg3d(int(seed) & 0xFFFFFFFF, int(round_) & 0xFFFFFFFF,
                            0x9E3779B9)
    return x


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
        with span("sync.photons_done"):
            return int(self.photon_grid.num_photons) >= self.settings.total_photons

    # -- ray compute -------------------------------------------------------
    def compute(self, num_ticks: int) -> int:
        """Advance ``num_ticks`` (one tick is one path; a PNEE instance
        spends ticks on photons first).  Paths come in whole batches.
        Returns the number of paths traced."""
        s = self.session
        st = self.settings
        W, H = s.width, s.height
        # the whole batch over every rank; each traces ray_batch_size of it
        batch = st.ray_batch_size * (1 if s.mesh is None else s.mesh.size)
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

        use_regen = st.use_regen and st.early_exit
        # lanes capped at a quarter of the batch (the session's queue is
        # one batch, so a wide wavefront pays its drain tail every step);
        # an explicit smaller regen_lanes is honoured
        lanes = min(st.regen_lanes, st.ray_batch_size, max(1024, st.ray_batch_size // 4))
        # decorrelates the halves' RNG streams under the same round seed
        # (the per-pixel route keys a path by its pixel, as in JAX)
        rid_base = 0x40000000 if self.x0 > 0 or self.y0 > 0 else 0
        use_flat = s.prep.cluster is not None and st.use_flat_wavefront is not False
        queue_fn = wavefront.render_queue_flat if use_flat else integrator.render_queue
        if s.mesh is not None:
            if not use_regen:
                raise ValueError("a session over a mesh renders through the "
                                 "regenerating queue (use_regen and early_exit on)")
            queue_fn = functools.partial(
                shard.render_queue_flat_sharded if use_flat else shard.render_queue_sharded,
                s.mesh, exact_lanes=True)
        traced = 0
        costs = []
        last_density = None
        half = "right" if rid_base else "left"
        route = "per_pixel" if not use_regen else "flat" if use_flat else "queue"
        while ticks_left > 0:
            with span("session.batch", {"half": half, "round": self.round, "route": route}):
                seed = fold_seed(s.seed, self.round)
                with span("session.pick"):
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
                if use_regen:
                    its = []
                    with span("queue"):
                        acc_s, cnt_s, cost = queue_fn(
                            s.prep, s.scene, st, s.camera, py * W + px, W, H, seed,
                            lanes, photon_grid=self.photon_grid, rid_base=rid_base,
                            iters_out=its)
                    self.num_queue_iters += sum(its)
                    accum.write_sums(s.buffer, acc_s, cnt_s)
                else:
                    with span("queue"), torch.no_grad():
                        col, cost = integrator.render_pixels(
                            s.prep, s.scene, st, s.camera, px, py, W, H, seed,
                            photon_grid=self.photon_grid)
                    accum.write_samples(s.buffer, px, py, col)
                costs.append(cost.sum())
                self.round += 1
                traced += batch
                self._rays_traced += batch
                ticks_left -= batch
        if last_density is not None:
            s.write_density(self.x0, self.y0, *last_density)
        # one host read per compute() call, in int64
        if costs:
            with span("sync.cost"):
                self.num_bvh_hits += int(torch.stack(costs).sum())
        return traced

    def round_samples(self) -> float:
        """Mean samples per pixel so far in this region."""
        s = self.session
        c = s.buffer.count[self.y0:self.y0 + self.height,
                           self.x0:self.x0 + self.width]
        return float(c.mean())

    def reset(self):
        """Start the render over; the photons are kept."""
        self.num_bvh_hits = 0
        self.num_queue_iters = 0    # regenerating-queue loop iterations
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
    PNEE with adaptive sampling, as in the JAX session.  ``mesh`` shards
    each batch's queue over its ranks (see the module's docstring); the
    session then renders on the mesh's device.
    """

    def __init__(self, width: int, height: int, scene_id: int = 100,
                 camera: Camera | None = None,
                 left: RenderSettings | None = None,
                 right: RenderSettings | None = None,
                 seed: int = 0xBABABEBE,
                 use_bvh: bool | None = None,
                 device=None, mesh: shard.RayMesh | None = None):
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None and device is None
                                     else device)
        self.width, self.height = width, height
        self.seed = seed
        self.use_bvh = use_bvh
        self.meshes: dict[int, np.ndarray] = {}
        self.textures: dict[int, np.ndarray] = {}
        self._load_scene(scene_id)
        self.camera = (initial_camera(scene_id, self.device) if camera is None
                       else camera.to(self.device))
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
        if bootstrap:
            self.density[y0:y0 + h, x0:x0 + w] = (0.0, 0.0, 1.0)
            return
        rgb = accum.mix_color(density)
        with span("sync.density"):
            self.density[y0:y0 + h, x0:x0 + w] = rgb.cpu().numpy()

    def compute(self, num_samples: int) -> int:
        """Ticks split between the halves; returns paths traced."""
        n_left = num_samples // 2
        t = self.left.compute(n_left)
        t += self.right.compute(num_samples - n_left)
        return t

    def results(self, show_sampling: bool = False) -> np.ndarray:
        """(H, W, 3) uint8 frame, or the sampling-density view."""
        with span("session.results"):
            if show_sampling:
                return tonemap_u8(self.density)
            img = accum.clamped_image(self.buffer)
            with span("sync.readout"):
                img = img.cpu().numpy()
            return tonemap_u8(img)

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

    def store_texture(self, tex_id: int, rgb) -> bool:
        """Upload a texture; it takes effect at the next
        :meth:`update_scene` (returns False: nothing was rebuilt)."""
        self.textures[tex_id] = np.asarray(rgb, np.float32)
        return False

    @property
    def num_bvh_hits(self) -> int:
        """Total primitive tests so far."""
        return self.left.num_bvh_hits + self.right.num_bvh_hits

    @property
    def num_queue_iters(self) -> int:
        """Regenerating-queue loop iterations so far (a host count; the
        per-pixel route adds none)."""
        return self.left.num_queue_iters + self.right.num_queue_iters
