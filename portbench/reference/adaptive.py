"""Pixel picks and the frame readout: a frozen copy of the port's
``ops/adaptive.py`` (``random_pixels``, ``error_field``,
``pick_pixels``), ``ops/accum.py`` (the clamped mean image) and
``utils/png.py::tonemap_u8``."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import filters
from portbench.reference import rng as rnglib

SLOT_PIXEL = 0x7FFE0000


def clamped_image(acc, count):
    """Mean radiance of an (H, W, 3) sum and (H, W) count, clamped to
    [0, 1]; pixels without samples read 0."""
    return torch.clamp(acc / torch.clamp(count, min=1.0)[..., None], 0.0, 1.0)


def tonemap_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def error_field(acc, count):
    """Per-pixel scaled error in [0, 1], (H, W)."""
    img = clamped_image(acc, count)
    d3 = torch.sum((img - filters.gaussian3(img)) ** 2, dim=-1)
    d5 = torch.sum((img - filters.gaussian5(img)) ** 2, dim=-1)
    mse = torch.maximum(d3, d5)
    mse_avg, mse_min, mse_max = mse.mean(), mse.min(), mse.max()
    lo = 0.5 * (mse - mse_min) / torch.clamp(mse_avg - mse_min, min=1e-12)
    hi = 0.5 + 0.5 * (mse - mse_avg) / torch.clamp(mse_max - mse_avg, min=1e-12)
    scaled = torch.where(mse < mse_avg, lo, hi)
    return torch.where(mse_min == mse_max, 0.0, torch.clamp(scaled, 0.0, 1.0))


def pick_pixels(acc, count, batch: int, seed, bootstrap: bool, spp_scale: float,
                x0: int, y0: int, width: int, height: int, sweep_pos: int):
    """(px, py, new_sweep_pos) of a variance-guided batch over the region;
    ``acc`` and ``count`` are the whole frame's buffer, ``sweep_pos`` the
    cyclic sweep's position, ``new_sweep_pos`` the one after this batch."""
    hw = width * height
    dev = acc.device
    i = torch.arange(batch, dtype=torch.int64, device=dev)
    sweep_idx = (sweep_pos + i) % hw
    if bootstrap:
        idx = sweep_idx
        new_pos = (sweep_pos + batch) % hw
    else:
        density = error_field(acc[y0:y0 + height, x0:x0 + width],
                              count[y0:y0 + height, x0:x0 + width])
        flat = torch.ceil(1.0 + density * spp_scale).reshape(-1)
        total = torch.clamp(flat.sum(), min=1.0)
        n_floor = torch.clamp(torch.round(batch * hw / total).to(torch.int64), 1, batch)
        cdf = torch.cumsum(flat - 1.0, dim=0)
        etotal = cdf[-1]
        n_excess = torch.clamp(batch - n_floor, min=1).to(torch.float32)
        u = rnglib.uniform3(seed, i, SLOT_PIXEL)[0]
        j = (i - n_floor).to(torch.float32)
        targets = (j + u) / n_excess * torch.clamp(etotal, min=1e-12)
        cdf_idx = torch.clamp(torch.searchsorted(cdf, targets, right=True), max=hw - 1)
        idx = torch.where((i < n_floor) | (etotal <= 0.0), sweep_idx, cdf_idx)
        new_pos = (sweep_pos + int(n_floor)) % hw
    return idx % width + x0, idx // width + y0, new_pos


def random_pixels(batch: int, seed, x0: int, y0: int, width: int, height: int, device):
    i = torch.arange(batch, dtype=torch.int64, device=device)
    u1, u2, _ = rnglib.uniform3(seed, i, SLOT_PIXEL)
    px = x0 + torch.clamp((u1 * width).to(torch.int64), max=width - 1)
    py = y0 + torch.clamp((u2 * height).to(torch.int64), max=height - 1)
    return px, py
