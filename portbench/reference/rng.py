"""Counter-based random numbers: a frozen copy of the port's ``utils/rng.py``.

Every draw is a pure function of ``(seed, ray_id, slot)`` through the
pcg3d hash, and reproduces the JAX package's streams bit for bit, so a
path draws the same numbers in both packages.

PyTorch's uint32 arithmetic is incomplete, so the hash runs on int64
holding values in [0, 2^32), masked back to 32 bits after every
multiply and add: a product of two such values may wrap past 2^63, and
the wrap (two's complement, on the CPU and on CUDA) keeps the low 32
bits intact.  The same code runs on Python ints, which the session uses
to fold seeds on the host; scalar arguments stay Python ints, so no
host-to-device copy is made for them.

``Xorshift32`` is the reference generator, host-side only: the museum's
light colours are shuffled with it.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_INV_2_24 = 1.0 / (1 << 24)


def _mul32(a, b):
    """``a * b mod 2**32`` for values in [0, 2**32)."""
    return (a * b) & _M32


def _pcg3d(x, y, z):
    """pcg3d hash on three uint32 values (int64 tensors or Python ints)."""
    m = 1664525
    a = 1013904223
    x = (_mul32(x, m) + a) & _M32
    y = (_mul32(y, m) + a) & _M32
    z = (_mul32(z, m) + a) & _M32
    x = (x + _mul32(y, z)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = (x + _mul32(y, z)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    return x, y, z


def _to_unit(u):
    """uint32 -> f32 in [0, 1) from the top 24 bits (exact in f32)."""
    return (u >> 8).to(torch.float32) * _INV_2_24


def _as_u32(v):
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & _M32
    return int(v) & _M32


def uniform3(seed, ray_id, slot):
    """Three independent U[0,1) float32 tensors per (seed, ray_id, slot).

    Arguments broadcast; each is a Python int, a numpy integer or an
    integer tensor holding a uint32 value, and ``ray_id`` is a tensor.
    """
    if not isinstance(ray_id, torch.Tensor):
        raise TypeError("ray_id must be a tensor")
    x, y, z = _pcg3d(_as_u32(ray_id), _as_u32(slot), _as_u32(seed))
    return _to_unit(x), _to_unit(y), _to_unit(z)


def uniform1(seed, ray_id, slot):
    return uniform3(seed, ray_id, slot)[0]


def uniform2(seed, ray_id, slot):
    u = uniform3(seed, ray_id, slot)
    return u[0], u[1]


class Xorshift32:
    """The reference's RNG, host-side only (museum colour shuffle)."""

    def __init__(self, state: int = 0xBABABEBE):
        self.state = np.uint32(state)

    def next_u32(self) -> int:
        x = self.state
        with np.errstate(over="ignore"):
            x ^= np.uint32((int(x) << 13) & 0xFFFFFFFF)
            x ^= x >> np.uint32(17)
            x ^= np.uint32((int(x) << 5) & 0xFFFFFFFF)
        self.state = x
        return int(x)

    def next(self) -> float:
        # f32 in [0,1]; the reference divides by 0xFFFFFFFF
        return float(np.float32(self.next_u32()) * np.float32(1.0 / 0xFFFFFFFF))

    def next_in_range(self, low: int, high: int) -> int:
        if high <= low:
            raise ValueError("Invalid range")
        if high == low + 1:
            return 0
        f = self.next()
        if f == 1.0:
            return high - 1
        return int(np.floor(np.float32(f) * np.float32(high - low))) + low

    def shuffle(self, xs: list) -> None:
        # swap each index with a random index
        for i in range(len(xs)):
            j = self.next_in_range(0, len(xs))
            xs[i], xs[j] = xs[j], xs[i]
