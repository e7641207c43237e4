"""Photon-guided light selection on a flat grid: a frozen copy of the
port's ``ops/photon.py`` over the plain tracer.

:func:`emit_photons` shoots a batch of photons from the area lights and
adds each one that lands on a diffuse surface to its cell's histogram;
:func:`sample` picks a light from the histogram of the point's own cell
or an adjacent one and returns the exact trilinear probability of that
light.  Bins start at 1.0.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.reference import intersect as isx
from portbench.reference import rng as rnglib
from portbench.reference import tracer as tr
from portbench.reference import vecmath as vm
from portbench.reference.scene import MatKind, Scene, finite_aabb


@dataclasses.dataclass
class PhotonGrid:
    bins: torch.Tensor         # (res^3, L) f32, initialised to 1.0
    lo: torch.Tensor           # (3,)
    hi: torch.Tensor           # (3,)
    num_photons: int           # photons deposited so far
    res: int = 32

    def tables(self):
        cdf_tab = torch.cumsum(self.bins, dim=-1)
        sum_tab = torch.sum(self.bins, dim=-1)
        corners = torch.tensor([[dx, dy, dz] for dx in (0, 1) for dy in (0, 1)
                                for dz in (0, 1)], device=self.bins.device)
        return cdf_tab, (self.bins / sum_tab[:, None]).reshape(-1), corners


def grid_bounds(scene: Scene):
    """The scene's finite AABB padded on every axis by half its largest
    extent, at least 1 unit (``photon_grid_fit_scene``)."""
    lo, hi = finite_aabb(scene)
    pad = np.float32(max(0.5 * float(np.max(hi - lo)), 1.0))
    return lo - pad, hi + pad


def create(scene: Scene, res: int) -> PhotonGrid:
    lo, hi = grid_bounds(scene)
    dev = scene.device
    return PhotonGrid(
        bins=torch.ones((res ** 3, max(scene.num_lights, 1)), dtype=torch.float32, device=dev),
        lo=torch.as_tensor(np.asarray(lo, np.float32), device=dev),
        hi=torch.as_tensor(np.asarray(hi, np.float32), device=dev), num_photons=0, res=res)


def _cell_coords(grid: PhotonGrid, p):
    u = (p - grid.lo) / (grid.hi - grid.lo) * grid.res
    return u, torch.clamp(torch.floor(u).to(torch.int64), 0, grid.res - 1)


def _cell_index(grid: PhotonGrid, c):
    return (c[..., 0] * grid.res + c[..., 1]) * grid.res + c[..., 2]


def _uniform_hemisphere(n, u1, u2):
    z = 2.0 * u1 - 1.0
    phi = 2.0 * math.pi * u2
    r = vm.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    v = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    flip = vm.dot(v, n) < 0.0
    return torch.where(flip[..., None], -v, v)


def emit_photons(grid: PhotonGrid, scene: Scene, epsilon: float, seed, batch: int,
                 quant=lambda x: x) -> PhotonGrid:
    """One batch of photons added to ``grid`` (in place); returns it."""
    dev = scene.device
    L = max(scene.num_lights, 1)
    pid = torch.arange(batch, dtype=torch.int64, device=dev)
    u_pick = rnglib.uniform3(seed, pid, 0)[0]
    lid = torch.clamp((u_pick * L).to(torch.int64), max=L - 1)
    lsid = scene.light_shape[lid].long()
    lrows = scene.params[lsid]
    s1, s2, s3 = rnglib.uniform3(seed, pid, 1)
    p_l, ln = isx.triangle_pick_random(lrows[:, 0:3], lrows[:, 3:6], lrows[:, 6:9],
                                       s1, s2, s3)
    d1, d2, _ = rnglib.uniform3(seed, pid, 2)
    d = quant(_uniform_hemisphere(ln, d1, d2))
    o = quant(p_l + d * epsilon)
    t, sid, hit = tr.nearest(scene, o, d)
    t = quant(t)
    prow = tr.pack_hit_rows(scene)[torch.clamp(sid, min=0)]
    info = tr.hit_info(o, d, torch.where(hit, t, 1.0), prow)
    diffuse = hit & (info["kind"] == int(MatKind.DIFFUSE))
    hp = o + d * torch.where(hit, t, 0.0)[..., None] + info["n"] * epsilon
    w = vm.dot(ln, d) * torch.amax(scene.emission[lsid], dim=-1)
    w = torch.where(diffuse, w, 0.0)
    _, c = _cell_coords(grid, hp)
    grid.bins.index_put_((_cell_index(grid, c), lid), w, accumulate=True)
    grid.num_photons += int(diffuse.sum())
    return grid


def sample(grid: PhotonGrid, p, seed, ray_id, slot):
    """(light id (R,) int64, its probability (R,), detached)."""
    L = grid.bins.shape[1]
    u, c = _cell_coords(grid, p)
    frac = u - c.to(torch.float32)
    w_own = 1.0 - torch.abs(frac - 0.5)
    off = torch.where(frac > 0.5, 1, -1)
    u1, u2, u3 = rnglib.uniform3(seed, ray_id, slot)
    u4 = rnglib.uniform3(seed, ray_id, slot + 2)[0]
    pick_own = torch.stack([u1, u2, u3], dim=-1) <= w_own
    c_sel = torch.clamp(c + torch.where(pick_own, 0, off), 0, grid.res - 1)
    cdf_tab, norm_flat, corners = grid.tables()
    cdf = cdf_tab[_cell_index(grid, c_sel)]
    r = u4[..., None] * cdf[..., -1:]
    lid = torch.clamp(torch.sum(cdf < r, dim=-1), max=L - 1)
    cc = torch.clamp(c[:, None, :] + off[:, None, :] * corners, 0, grid.res - 1)
    prob = norm_flat[_cell_index(grid, cc) * L + lid[:, None]]
    wa = torch.where(corners == 0, w_own[:, None, :], 1.0 - w_own[:, None, :])
    pw = prob * (wa[..., 0] * wa[..., 1] * wa[..., 2])
    pdf = pw[:, 0]
    for k in range(1, 8):
        pdf = pdf + pw[:, k]
    outside = torch.any((p < grid.lo) | (p > grid.hi), dim=-1)
    uni_lid = torch.clamp((u4 * L).to(torch.int64), max=L - 1)
    return torch.where(outside, uni_lid, lid), torch.where(outside, 1.0 / L, pdf).detach()
