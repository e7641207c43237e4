"""Pixel selection (``wasm_pathtracer_tpu.ops.adaptive``).

Only the uniform sampler is ported; the variance-guided allocator comes
with a later slice of the port.
"""

from __future__ import annotations

import torch

from wasm_pathtracer_tpu_torch.utils import rng as rnglib

_SLOT_PIXEL = 0x7FFE0000


def random_pixels(batch: int, seed, x0: int, y0: int, width: int, height: int,
                  device="cpu"):
    """Uniform pixel selection: (px, py) int64 tensors of length ``batch``."""
    i = torch.arange(batch, dtype=torch.int64, device=device)
    u1, u2, _ = rnglib.uniform3(seed, i, _SLOT_PIXEL)
    px = x0 + torch.clamp((u1 * width).to(torch.int64), max=width - 1)
    py = y0 + torch.clamp((u2 * height).to(torch.int64), max=height - 1)
    return px, py
