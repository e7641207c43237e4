"""Edge-renormalised Gaussian filters: a frozen copy of the port's
``ops/filters.py``.

3x3 and 5x5 binomial kernels over an (H, W, C) image; taps that fall
outside the image contribute neither value nor weight.  The JAX version
is a depthwise convolution at ``Precision.HIGHEST``.  Here the 9 or 25
taps are summed as shifted slices of the zero-padded image, in float32
throughout: a cuDNN convolution would take TF32 on the card unless a
global flag said otherwise, and this function leans on no global flag.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

GAUSS3 = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32)
GAUSS5 = np.array(
    [[1, 4, 6, 4, 1],
     [4, 16, 24, 16, 4],
     [6, 24, 36, 24, 6],
     [4, 16, 24, 16, 4],
     [1, 4, 6, 4, 1]], np.float32)


def _conv2d_same(img, kernel):
    """(H, W, C) x (k, k) -> (H, W, C), zero-padded SAME correlation
    (the kernels are symmetric), taps added in row-major order."""
    k = kernel.shape[0]
    r = k // 2
    H, W = img.shape[:2]
    padded = F.pad(img, (0, 0, r, r, r, r))
    out = torch.zeros_like(img)
    for i in range(k):
        for j in range(k):
            out = out + float(kernel[i, j]) * padded[i:i + H, j:j + W]
    return out


def gaussian_renorm(img, kernel):
    """Edge-renormalised Gaussian blur of an (H, W, C) image."""
    num = _conv2d_same(img, kernel)
    ones = torch.ones((*img.shape[:2], 1), dtype=img.dtype, device=img.device)
    return num / _conv2d_same(ones, kernel)


def gaussian3(img):
    return gaussian_renorm(img, GAUSS3)


def gaussian5(img):
    return gaussian_renorm(img, GAUSS5)
