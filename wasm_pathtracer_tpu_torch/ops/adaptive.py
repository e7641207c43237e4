"""Pixel selection (``wasm_pathtracer_tpu.ops.adaptive``).

:func:`random_pixels` draws uniformly.  :func:`pick_pixels` allocates a
fixed-size batch by variance: the per-pixel error is
``max(|mean - gauss3(mean)|^2, |mean - gauss5(mean)|^2)``, scaled
piecewise around its mean into [0, 1]; each pixel's weight is
``ceil(1 + error * spp_scale)``.  The uniform "+1" share of a batch runs
a cyclic sweep over the region (no pixel starves), the excess is drawn
by stratified inverse-CDF sampling.  Nothing here reads a value back to
the host: the sweep position is carried as a device scalar.
"""

from __future__ import annotations

import torch

from wasm_pathtracer_tpu_torch.ops import accum, filters
from wasm_pathtracer_tpu_torch.utils import rng as rnglib
from wasm_pathtracer_tpu_torch.utils.device import resolve_device

_SLOT_PIXEL = 0x7FFE0000


def error_field(buf: accum.AccumBuffer):
    """Per-pixel scaled error in [0, 1], (H, W)."""
    img = accum.clamped_image(buf)
    d3 = torch.sum((img - filters.gaussian3(img)) ** 2, dim=-1)
    d5 = torch.sum((img - filters.gaussian5(img)) ** 2, dim=-1)
    mse = torch.maximum(d3, d5)

    mse_avg, mse_min, mse_max = mse.mean(), mse.min(), mse.max()
    lo = 0.5 * (mse - mse_min) / torch.clamp(mse_avg - mse_min, min=1e-12)
    hi = 0.5 + 0.5 * (mse - mse_avg) / torch.clamp(mse_max - mse_avg, min=1e-12)
    scaled = torch.where(mse < mse_avg, lo, hi)
    return torch.where(mse_min == mse_max, 0.0, torch.clamp(scaled, 0.0, 1.0))


def target_spp(buf: accum.AccumBuffer, spp_scale: float = 32.0):
    """Relative samples-per-pixel weights."""
    return torch.ceil(1.0 + error_field(buf) * spp_scale)


def pick_pixels(buf: accum.AccumBuffer, batch: int, seed, bootstrap: bool,
                spp_scale: float = 32.0, x0: int = 0, y0: int = 0,
                width: int | None = None, height: int | None = None,
                sweep_pos=None):
    """Draw a batch of pixel coordinates for the region
    ``[x0, x0 + width) x [y0, y0 + height)``.

    ``bootstrap`` is the uniform first round, an exact cyclic sweep from
    ``sweep_pos``.  Otherwise ``round(batch * hw / total_weight)`` slots
    (at least 1) continue the sweep and the rest target the excess mass
    ``weight - 1``: slot j aims at ``(j + u_j) / n_excess`` of it, found
    with a right-sided search of the cumulative sum.  The weights are
    whole numbers of at most ``1 + spp_scale``, so the float32 cumulative
    sum is exact, in any order of addition, while its total stays below
    2^24.

    Returns (px, py, density, new_sweep_pos): int64 coordinates, the
    (height, width) scaled error for the sampling-density view, and the
    sweep position to pass to the next call (an int64 device scalar).
    """
    H, W = buf.acc.shape[:2]
    dev = buf.acc.device
    width = W - x0 if width is None else width
    height = H - y0 if height is None else height
    hw = width * height
    if sweep_pos is None:
        sweep_pos = torch.zeros((), dtype=torch.int64, device=dev)
    i = torch.arange(batch, dtype=torch.int64, device=dev)
    sweep_idx = (sweep_pos + i) % hw

    if bootstrap:
        density = torch.zeros((height, width), dtype=torch.float32, device=dev)
        idx = sweep_idx
        new_pos = (sweep_pos + batch) % hw
    else:
        sub = accum.AccumBuffer(acc=buf.acc[y0:y0 + height, x0:x0 + width],
                                count=buf.count[y0:y0 + height, x0:x0 + width])
        density = error_field(sub)
        flat = torch.ceil(1.0 + density * spp_scale).reshape(-1)
        total = torch.clamp(flat.sum(), min=1.0)
        n_floor = torch.clamp(torch.round(batch * hw / total).to(torch.int64), 1, batch)

        cdf = torch.cumsum(flat - 1.0, dim=0)
        etotal = cdf[-1]
        n_excess = torch.clamp(batch - n_floor, min=1).to(torch.float32)
        u = rnglib.uniform3(seed, i, _SLOT_PIXEL)[0]
        j = (i - n_floor).to(torch.float32)
        targets = (j + u) / n_excess * torch.clamp(etotal, min=1e-12)
        cdf_idx = torch.clamp(torch.searchsorted(cdf, targets, right=True), max=hw - 1)
        # a degenerate error field (no excess mass) keeps sweeping
        use_sweep = (i < n_floor) | (etotal <= 0.0)
        idx = torch.where(use_sweep, sweep_idx, cdf_idx)
        new_pos = (sweep_pos + n_floor) % hw

    return idx % width + x0, idx // width + y0, density, new_pos


def random_pixels(batch: int, seed, x0: int, y0: int, width: int, height: int,
                  device=None):
    """Uniform pixel selection: (px, py) int64 tensors of length ``batch``."""
    i = torch.arange(batch, dtype=torch.int64, device=resolve_device(device))
    u1, u2, _ = rnglib.uniform3(seed, i, _SLOT_PIXEL)
    px = x0 + torch.clamp((u1 * width).to(torch.int64), max=width - 1)
    py = y0 + torch.clamp((u2 * height).to(torch.int64), max=height - 1)
    return px, py
