"""Progressive accumulation buffers (``wasm_pathtracer_tpu.ops.accum``).

A per-pixel radiance sum and sample count whose mean is the displayed
image.  Writes update the buffer in place.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class AccumBuffer:
    acc: torch.Tensor     # (H, W, 3) f32 radiance sum
    count: torch.Tensor   # (H, W) f32 samples per pixel

    @staticmethod
    def create(width: int, height: int, device="cpu") -> "AccumBuffer":
        return AccumBuffer(
            acc=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
            count=torch.zeros((height, width), dtype=torch.float32, device=device),
        )

    def clear(self) -> "AccumBuffer":
        return AccumBuffer.create(self.acc.shape[1], self.acc.shape[0],
                                  self.acc.device)


def write_samples(buf: AccumBuffer, px, py, color) -> AccumBuffer:
    """Add a batch of samples at pixels (px, py)."""
    W = buf.acc.shape[1]
    flat = py.long() * W + px.long()
    buf.acc.view(-1, 3).index_add_(0, flat, color)
    buf.count.view(-1).index_add_(0, flat, torch.ones_like(color[:, 0]))
    return buf


def write_sums(buf: AccumBuffer, color_sum, counts) -> AccumBuffer:
    """Add full-frame sums from ``integrator.render_queue``:
    ``color_sum`` (H*W, 3) radiance totals and ``counts`` (H*W,)."""
    H, W, _ = buf.acc.shape
    buf.acc += color_sum.reshape(H, W, 3)
    buf.count += counts.reshape(H, W).to(torch.float32)
    return buf


def mean_image(buf: AccumBuffer) -> torch.Tensor:
    """Average radiance; pixels with zero samples read 0."""
    c = torch.clamp(buf.count, min=1.0)[..., None]
    return buf.acc / c


def clamped_image(buf: AccumBuffer) -> torch.Tensor:
    """Mean radiance clamped to [0, 1]."""
    return torch.clamp(mean_image(buf), 0.0, 1.0)


def mix_color(v):
    """Sampling-density false colour: green below average, blue at
    average (0.5), red above.  ``v`` (...) -> (..., 3)."""
    v = torch.clamp(v, 0.0, 1.0)[..., None]
    green = torch.tensor([0.0, 1.0, 0.0], device=v.device)
    blue = torch.tensor([0.0, 0.0, 1.0], device=v.device)
    red = torch.tensor([1.0, 0.0, 0.0], device=v.device)
    lo = green * (1.0 - 2.0 * v) + blue * (2.0 * v)
    hi = blue * (1.0 - 2.0 * (v - 0.5)) + red * (2.0 * (v - 0.5))
    return torch.where(v < 0.5, lo, hi)


def depth_image(t, max_t=None):
    """White-near / black-far tone mapping of hit distances for the depth
    debug view; a miss (+inf) reads black."""
    finite = torch.isfinite(t)
    if max_t is None:
        max_t = torch.where(finite, t, 0.0).max() + 1e-6
    g = torch.clamp(1.0 - t / max_t, 0.0, 1.0)
    g = torch.where(finite, g, 0.0)
    return torch.stack([g, g, g], dim=-1)
