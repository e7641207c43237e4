"""The device an entry point renders on.

Every public function of the port that makes tensors from nothing (the
scene builders, cameras, buffers, photon grids, cluster tables, pixel
picks) takes ``device=None``, which means the card.  The CPU, where the
kernels' plain PyTorch versions run, is taken only when the caller asks
for it; a render never moves to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; asking for CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is False (pass device='cpu' to render on the CPU)")
    return dev
