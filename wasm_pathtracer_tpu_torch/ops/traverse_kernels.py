"""Dense ray x triangle nearest-hit sweep (``wasm_pathtracer_tpu.ops.traverse_pallas``).

One kernel, written in CUDA C++ for Hopper (``csrc/traverse_kernels.cu``):

- :func:`dense_tri_nearest` (K8) -> (t, slot): every ray against every
  triangle of a (T, 9) row table, the lexicographic (t, slot) minimum.

Beside it is its plain PyTorch version, :func:`dense_tri_nearest_reference`,
which walks the table in chunks so that the (R, chunk) candidate matrix
fits memory.  The wrapper takes the plain version for tensors on the
CPU; for CUDA tensors it launches the kernel, and raises if the kernel
does not build or launch.  It counts its launches in
``dense_tri_nearest.launches``.

The arithmetic is the TPU kernel's, not ``intersect.rays_vs_triangles``:
the plane normal stays unnormalised, ``n.d`` is clamped to 1e-30 where
it vanishes instead of rejecting the ray, ``rsqrt(max(n.n, 1e-30))``
scales only the edge slack, and a hit needs ``inside & (t > 0)``.  The
TPU kernel's padding (rays to 256, triangles to 512, SoA planes) has no
counterpart: the kernel masks its ragged ends.
"""

from __future__ import annotations

import torch

from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk

_EPS_SLACK = 0.1 * 2e-4
# elements of one (R, chunk) candidate matrix of the plain version
_REFERENCE_ELEMS = 1 << 22


def _chunk_distances(rows, o, d):
    """(R, n) distances of (R, 3) rays to the triangles ``rows`` (n, 9),
    +inf on a miss; componentwise, as the TPU kernel computes them."""
    v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z = rows.unbind(dim=1)
    e1x, e1y, e1z = v1x - v0x, v1y - v0y, v1z - v0z
    e2x, e2y, e2z = v2x - v0x, v2y - v0y, v2z - v0z
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    inv_len = torch.rsqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-30))
    orig = nx * v0x + ny * v0y + nz * v0z

    ox, oy, oz = (o[:, k, None] for k in range(3))
    dx, dy, dz = (d[:, k, None] for k in range(3))
    ndd = dx * nx + dy * ny + dz * nz
    ndd = torch.where(torch.abs(ndd) < 1e-30, 1e-30, ndd)
    ndo = ox * nx + oy * ny + oz * nz
    t = (orig - ndo) / ndd
    px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t

    def left_of(ax, ay, az, ex, ey, ez):
        wx, wy, wz = px - ax, py - ay, pz - az
        cx = ey * wz - ez * wy
        cy = ez * wx - ex * wz
        cz = ex * wy - ey * wx
        return (cx * nx + cy * ny + cz * nz) * inv_len + _EPS_SLACK >= 0.0

    inside = left_of(v0x, v0y, v0z, e1x, e1y, e1z)
    inside &= left_of(v1x, v1y, v1z, v2x - v1x, v2y - v1y, v2z - v1z)
    inside &= left_of(v2x, v2y, v2z, v0x - v2x, v0y - v2y, v0z - v2z)
    return torch.where(inside & (t > 0.0), t, torch.inf)


def dense_tri_nearest_reference(tri_rows, o, d, chunk: int | None = None):
    """Plain PyTorch version of :func:`dense_tri_nearest`: a running
    first minimum over triangle chunks (argmin within a chunk, strict <
    across chunks)."""
    R, T = o.shape[0], tri_rows.shape[0]
    if chunk is None:
        chunk = max(64, min(2048, _REFERENCE_ELEMS // max(R, 1)))
    best_t = torch.full((R,), torch.inf, dtype=torch.float32, device=o.device)
    best_slot = torch.full((R,), -1, dtype=torch.int32, device=o.device)
    for base in range(0, T, chunk):
        t = _chunk_distances(tri_rows[base:base + chunk], o, d)
        tloc, jloc = torch.min(t, dim=1)                 # first minimum
        better = tloc < best_t
        best_t = torch.where(better, tloc, best_t)
        best_slot = torch.where(better, (base + jloc).to(torch.int32), best_slot)
    return best_t, best_slot


def dense_tri_nearest(tri_rows, o, d):
    """Nearest hit of each ray over all triangles.

    Args:
      tri_rows: (T, 9) float32 rows v0 v1 v2 (T may be 0).
      o, d: (R, 3) float32 rays.

    Returns (t (R,) float32, +inf on a miss; slot (R,) int32 row of the
    hit, the lowest among equal distances, -1 on a miss).
    """
    if o.device.type == "cpu":
        return dense_tri_nearest_reference(tri_rows, o, d)
    from wasm_pathtracer_tpu_torch.ops import _build
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"the dense sweep runs on CUDA tensors, got {dev}")
    R, T = o.shape[0], tri_rows.shape[0]
    sk._check("o", o, (R, 3), torch.float32, dev)
    sk._check("d", d, (R, 3), torch.float32, dev)
    sk._check("tri_rows", tri_rows, (T, 9), torch.float32, dev)
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    slot = torch.empty((R,), dtype=torch.int32, device=dev)
    packed = torch.empty((R,), dtype=torch.int64, device=dev)   # merge scratch
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.wpt_dense_tri_nearest(
            tri_rows.data_ptr(), T, o.data_ptr(), d.data_ptr(), R,
            packed.data_ptr(), t.data_ptr(), slot.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    sk._raise_on(rc, "dense_tri_nearest")
    dense_tri_nearest.launches += 1
    return t, slot


dense_tri_nearest.launches = 0
