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

The CUDA kernel evaluates the same test from rows it stages once per
triangle (:func:`staged_rows`: the plane, and per edge the vector
``m_i = (n x e_i) / |n|`` with the offset ``k_i = slack - a_i . m_i``, so
that a half-space test is ``p . m_i + k_i >= 0``).
:func:`dense_tri_nearest_staged` is that arithmetic in plain PyTorch, for
the tests: it differs from the plain version by rounding in the inside
test, which only rays within rounding of an edge can feel.
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


def _first_minimum(distances, rows, o, d, chunk):
    """Running first minimum of ``distances(rows[chunk], o, d)`` over
    chunks of rows (argmin within a chunk, strict < across chunks)."""
    R, T = o.shape[0], rows.shape[0]
    if chunk is None:
        chunk = max(64, min(2048, _REFERENCE_ELEMS // max(R, 1)))
    best_t = torch.full((R,), torch.inf, dtype=torch.float32, device=o.device)
    best_slot = torch.full((R,), -1, dtype=torch.int32, device=o.device)
    for base in range(0, T, chunk):
        t = distances(rows[base:base + chunk], o, d)
        tloc, jloc = torch.min(t, dim=1)                 # first minimum
        better = tloc < best_t
        best_t = torch.where(better, tloc, best_t)
        best_slot = torch.where(better, (base + jloc).to(torch.int32), best_slot)
    return best_t, best_slot


def dense_tri_nearest_reference(tri_rows, o, d, chunk: int | None = None):
    """Plain PyTorch version of :func:`dense_tri_nearest`: a running
    first minimum over triangle chunks."""
    return _first_minimum(_chunk_distances, tri_rows, o, d, chunk)


def staged_rows(tri_rows):
    """(T, 16) rows as the CUDA kernel stages a triangle in shared
    memory: ``n.xyz, n.v0``, then for the edges v0->v1, v1->v2, v2->v0
    ``m_i.xyz, k_i`` with ``m_i = (n x e_i) * rsqrt(max(n.n, 1e-30))`` and
    ``k_i = slack - a_i . m_i`` (``a_i`` the edge's first vertex)."""
    v0, v1, v2 = tri_rows[:, 0:3], tri_rows[:, 3:6], tri_rows[:, 6:9]
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    inv_len = torch.rsqrt(torch.clamp((n * n).sum(-1, keepdim=True), min=1e-30))
    cols = [n, (n * v0).sum(-1, keepdim=True)]
    for a, e in ((v0, v1 - v0), (v1, v2 - v1), (v2, v0 - v2)):
        m = torch.linalg.cross(n, e) * inv_len
        cols += [m, _EPS_SLACK - (a * m).sum(-1, keepdim=True)]
    return torch.cat(cols, dim=1)


def _staged_distances(staged, o, d):
    """(R, n) distances from the staged rows, shared (n, 16) or one set
    per ray (R, n, 16), as the kernel's pair loop computes them (it
    contracts each chain to fused multiply-adds and takes an approximate
    reciprocal; this rounds every operation)."""
    nx, ny, nz, orig = staged[..., 0:4].unbind(dim=-1)
    ox, oy, oz = (o[:, k, None] for k in range(3))
    dx, dy, dz = (d[:, k, None] for k in range(3))
    ndd = dx * nx + dy * ny + dz * nz
    ndd = torch.where(torch.abs(ndd) < 1e-30, 1e-30, ndd)
    t = (orig - ox * nx - oy * ny - oz * nz) / ndd
    px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
    inside = t > 0.0
    for i in (4, 8, 12):
        mx, my, mz, k = staged[..., i:i + 4].unbind(dim=-1)
        inside = inside & (k + px * mx + py * my + pz * mz >= 0.0)
    return torch.where(inside, t, torch.inf)


def dense_tri_nearest_staged(tri_rows, o, d, chunk: int | None = None):
    """:func:`dense_tri_nearest` by the CUDA kernel's arithmetic in plain
    PyTorch (used by the tests only)."""
    return _first_minimum(_staged_distances, staged_rows(tri_rows), o, d, chunk)


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


def launch_shape(n_tris: int, n_rays: int) -> dict:
    """The kernel's launch grid for a (T, 9) table and R rays, and what
    the compiler gave the kernel (needs the built library, so a card's
    toolkit)."""
    import ctypes

    from wasm_pathtracer_tpu_torch.ops import _build
    out = (ctypes.c_int * 8)()
    sk._raise_on(_build.library().wpt_dense_tri_launch_shape(n_tris, n_rays, out),
                 "dense_tri_launch_shape")
    keys = ("grid_x", "grid_y", "threads_per_block", "rays_per_thread",
            "triangles_per_tile", "registers", "shared_bytes", "local_bytes")
    return dict(zip(keys, out))
