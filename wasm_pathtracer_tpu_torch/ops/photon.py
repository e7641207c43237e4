"""Photon-guided next-event estimation on a flat grid
(``wasm_pathtracer_tpu.ops.photon``).

A dense grid of per-cell histograms over the light ids guides which
light NEE samples at a shading point:

- :func:`emit_photons` shoots a batch of photons from the area lights
  and adds each one that lands on a diffuse surface to its cell's
  histogram with one accumulating scatter;
- :func:`sample` picks, per axis, the point's own cell or the adjacent
  one with the linear interpolation weight ``1 - |u - 0.5|``, samples a
  light from the chosen cell's CDF, and returns the exact probability of
  that light as the trilinear combination over all 8 neighbour cells,
  so the estimator stays unbiased.

Histogram bins start at 1.0, so no light has probability zero.  The
per-cell tables that :func:`sample` reads (cumulative sums, totals,
normalised bins) are built once per grid, at the first ``sample``, not
once per call.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from wasm_pathtracer_tpu_torch.models.scene import MatKind, SceneData, finite_aabb
from wasm_pathtracer_tpu_torch.ops import intersect as isx
from wasm_pathtracer_tpu_torch.ops import trace as tr
from wasm_pathtracer_tpu_torch.utils import rng as rnglib
from wasm_pathtracer_tpu_torch.utils import vecmath as vm
from wasm_pathtracer_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class PhotonGrid:
    bins: torch.Tensor         # (res^3, L) f32 intensity histogram (init 1.0)
    lo: torch.Tensor           # (3,) grid lower corner
    hi: torch.Tensor           # (3,) grid upper corner
    num_photons: torch.Tensor  # () int64 photons deposited so far
    res: int = 32
    _tables: tuple | None = dataclasses.field(default=None, repr=False, compare=False)

    @staticmethod
    def create(num_lights: int, lo, hi, res: int = 32, device=None) -> "PhotonGrid":
        device = resolve_device(device)
        return PhotonGrid(
            bins=torch.ones((res ** 3, max(num_lights, 1)), dtype=torch.float32,
                            device=device),
            lo=torch.as_tensor(np.asarray(lo, np.float32), device=device),
            hi=torch.as_tensor(np.asarray(hi, np.float32), device=device),
            num_photons=torch.zeros((), dtype=torch.int64, device=device),
            res=res)

    def tables(self):
        """(cdf_tab (cells, L), norm_flat (cells * L,), corners (8, 3)):
        each cell's cumulative histogram, its bins over their sum, and
        the 0/1 offsets of a cell's 8 neighbours in (x, y, z)-major
        order; built at first use and kept with the grid."""
        if self._tables is None:
            cdf_tab = torch.cumsum(self.bins, dim=-1)
            sum_tab = torch.sum(self.bins, dim=-1)
            corners = torch.tensor([[dx, dy, dz] for dx in (0, 1) for dy in (0, 1)
                                    for dz in (0, 1)], device=self.bins.device)
            self._tables = (cdf_tab, (self.bins / sum_tab[:, None]).reshape(-1), corners)
        return self._tables


def photon_grid_from_numpy(arrays: dict, res: int, device=None) -> PhotonGrid:
    """A :class:`PhotonGrid` from a dict of arrays keyed ``bins``, ``lo``,
    ``hi`` and ``num_photons`` (e.g. the JAX package's grid read field by
    field with ``np.asarray``), so both packages sample identical
    histograms."""
    device = resolve_device(device)
    return PhotonGrid(
        bins=torch.from_numpy(np.array(arrays["bins"], np.float32)).to(device),
        lo=torch.from_numpy(np.array(arrays["lo"], np.float32)).to(device),
        hi=torch.from_numpy(np.array(arrays["hi"], np.float32)).to(device),
        num_photons=torch.tensor(int(arrays["num_photons"]), dtype=torch.int64,
                                 device=device),
        res=int(res))


_SLOT_EMIT_PICK = 0
_SLOT_EMIT_POINT = 1
_SLOT_EMIT_DIR = 2


def _cell_coords(grid: PhotonGrid, p):
    """Continuous grid coordinates and integer cell of a point."""
    u = (p - grid.lo) / (grid.hi - grid.lo) * grid.res          # (..., 3) in [0, res]
    c = torch.clamp(torch.floor(u).to(torch.int64), 0, grid.res - 1)
    return u, c


def _cell_index(grid: PhotonGrid, c):
    return (c[..., 0] * grid.res + c[..., 1]) * grid.res + c[..., 2]


def _uniform_hemisphere(n, u1, u2):
    """Uniform direction on the hemisphere around ``n``."""
    z = 2.0 * u1 - 1.0
    phi = 2.0 * math.pi * u2
    r = vm.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    v = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    flip = vm.dot(v, n) < 0.0
    return torch.where(flip[..., None], -v, v)


def emit_photons(grid: PhotonGrid, prep: tr.ScenePrep, scene: SceneData,
                 settings, seed, batch: int) -> PhotonGrid:
    """Shoot one batch of photons and add them to the grid: a random
    area light, a random point on it, a uniform hemisphere direction;
    trace; deposit ``(ln . dir) * max(intensity_rgb)`` at the hit point
    when the hit is diffuse.  Only photons that land are counted.

    The histogram is updated in place (``index_put_`` with accumulation,
    whose float sums may be taken in another order from run to run on
    the card) and returned in a new grid; ``grid`` itself must not be
    sampled afterwards.
    """
    dev = scene.device
    L = max(scene.num_lights, 1)
    pid = torch.arange(batch, dtype=torch.int64, device=dev)

    u_pick = rnglib.uniform3(seed, pid, _SLOT_EMIT_PICK)[0]
    lid = torch.clamp((u_pick * L).to(torch.int64), max=L - 1)
    lsid = scene.light_shape[lid].long()
    lrows = scene.params[lsid]
    s1, s2, s3 = rnglib.uniform3(seed, pid, _SLOT_EMIT_POINT)
    p_l, ln = isx.triangle_pick_random(lrows[:, 0:3], lrows[:, 3:6], lrows[:, 6:9],
                                       s1, s2, s3)
    d1, d2, _ = rnglib.uniform3(seed, pid, _SLOT_EMIT_DIR)
    d = _uniform_hemisphere(ln, d1, d2)
    o = p_l + d * settings.epsilon

    t, sid, hit, _ = tr.trace_scene(prep, scene, o, d)
    info = tr.hit_info(scene, o, d, torch.where(hit, t, 1.0), torch.clamp(sid, min=0))
    diffuse = hit & (info["kind"] == int(MatKind.DIFFUSE))

    # a miss lands nowhere: its weight is 0 and its cell is irrelevant
    hp = o + d * torch.where(hit, t, 0.0)[..., None] + info["n"] * settings.epsilon
    w = vm.dot(ln, d) * torch.amax(scene.emission[lsid], dim=-1)
    w = torch.where(diffuse, w, 0.0)

    _, c = _cell_coords(grid, hp)
    grid.bins.index_put_((_cell_index(grid, c), lid), w, accumulate=True)
    return dataclasses.replace(grid, num_photons=grid.num_photons + diffuse.sum(),
                               _tables=None)


def sample(grid: PhotonGrid, p, seed, ray_id, slot):
    """Sample a light id for the shading points ``p`` (R, 3); returns
    (lid (R,) int64, pdf (R,) float32, detached)."""
    L = grid.bins.shape[1]
    u, c = _cell_coords(grid, p)
    frac = u - c.to(torch.float32)                     # position in cell [0, 1]

    # own-cell weight per axis; adjacent offset direction per axis
    w_own = 1.0 - torch.abs(frac - 0.5)                # (R, 3)
    off = torch.where(frac > 0.5, 1, -1)

    u1, u2, u3 = rnglib.uniform3(seed, ray_id, slot)
    # slot + 2 (not + 1) keeps clear of the integrator's material slot
    u4 = rnglib.uniform3(seed, ray_id, slot + 2)[0]
    pick_own = torch.stack([u1, u2, u3], dim=-1) <= w_own

    c_sel = torch.clamp(c + torch.where(pick_own, 0, off), 0, grid.res - 1)
    cdf_tab, norm_flat, corners = grid.tables()
    cdf = cdf_tab[_cell_index(grid, c_sel)]            # (R, L)
    r = u4[..., None] * cdf[..., -1:]
    lid = torch.clamp(torch.sum(cdf < r, dim=-1), max=L - 1)

    # exact pdf over the 8 neighbours, all at once as (R, 8), then summed
    # neighbour by neighbour in the JAX package's order
    cc = torch.clamp(c[:, None, :] + off[:, None, :] * corners, 0, grid.res - 1)
    prob = norm_flat[_cell_index(grid, cc) * L + lid[:, None]]
    wa = torch.where(corners == 0, w_own[:, None, :], 1.0 - w_own[:, None, :])
    pw = prob * (wa[..., 0] * wa[..., 1] * wa[..., 2])
    pdf = pw[:, 0]
    for k in range(1, 8):
        pdf = pdf + pw[:, k]

    # outside the grid: uniform selection
    outside = torch.any((p < grid.lo) | (p > grid.hi), dim=-1)
    uni_lid = torch.clamp((u4 * L).to(torch.int64), max=L - 1)
    lid = torch.where(outside, uni_lid, lid)
    pdf = torch.where(outside, 1.0 / L, pdf)
    return lid, pdf.detach()


def grid_bounds_for_scene(scene: SceneData, settings):
    """Grid bounds: the scene's finite AABB padded on every axis by half
    its largest extent (at least 1 unit; most photons land on the
    infinite planes around it) when ``photon_grid_fit_scene`` is set,
    else the fixed +-``photon_world_size`` box."""
    if settings.photon_grid_fit_scene:
        lo, hi = finite_aabb(scene)
        pad = np.float32(max(0.5 * float(np.max(hi - lo)), 1.0))
        return lo - pad, hi + pad
    s = settings.photon_world_size
    return np.full(3, -s, np.float32), np.full(3, s, np.float32)
