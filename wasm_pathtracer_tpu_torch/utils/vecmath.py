"""Vector math over trailing-axis-3 tensors (``wasm_pathtracer_tpu.utils.vecmath``).

Dot products are broadcast multiply + sum, never ``matmul``: a K = 3
product gains nothing from a matrix unit and, on a GPU, may run in TF32.

The port's square roots go through :func:`sqrt`, which is correctly
rounded on every host, as the JAX package's are: ATen's AVX-512 CPU
kernel for float32 ``torch.sqrt`` is not (it returns a result 1 ulp off
for about one input in six).  At a grazing angle one ulp in a ray
direction moves a far hit by 1e-4 relative, and one ulp in the torus
SDF moves the march's root.
"""

from __future__ import annotations

import torch


def dot(a, b):
    """Batched dot product -> ``(...)``."""
    return torch.sum(a * b, dim=-1)


def length_sq(v):
    return dot(v, v)


def sqrt(x):
    """Correctly rounded square root.  A float32 CPU tensor is rooted in
    float64 and rounded once, which is exact; CUDA's ``sqrt`` already is."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def length(v):
    return sqrt(length_sq(v))


def normalize(v, eps: float = 0.0):
    """Unit-scale ``v`` (v * 1/len, or v / len without ``eps``)."""
    if eps:
        return v * (1.0 / torch.clamp(length(v), min=eps))[..., None]
    return v / length(v)[..., None]


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def reflect(v, n):
    """Reflect ``v`` (pointing away from the surface) about ``n``."""
    return 2.0 * dot(v, n)[..., None] * n - v


def rot_x(v, angle):
    """Rotate about the x axis."""
    c, s = torch.cos(angle), torch.sin(angle)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([x, c * y - s * z, s * y + c * z], dim=-1)


def rot_y(v, angle):
    """Rotate about the y axis."""
    c, s = torch.cos(angle), torch.sin(angle)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([c * x + s * z, y, -s * x + c * z], dim=-1)


def orthogonal(v):
    """Some unit vector orthogonal to ``v`` (branch-free; the same three
    candidates and selection order as the JAX version)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]

    def safe(d):
        return torch.where(torch.abs(d) > 1e-12, d, 1.0)

    one = torch.ones_like(x)
    cand_z = torch.stack([one, one, -(x + y) / safe(z)], dim=-1)
    cand_x = torch.stack([-(y + z) / safe(x), one, one], dim=-1)
    cand_y = torch.stack([one, -(x + z) / safe(y), one], dim=-1)

    use_z = (torch.abs(z) > 0.1)[..., None]
    use_x = (torch.abs(x) > 0.1)[..., None]
    out = torch.where(use_z, cand_z, torch.where(use_x, cand_x, cand_y))
    return normalize(out)


def tangent_frame(n):
    """Tangent basis (t, b) around normal ``n``: t = orthogonal(n),
    b = n x t."""
    t = orthogonal(n)
    b = cross(n, t)
    return t, b
