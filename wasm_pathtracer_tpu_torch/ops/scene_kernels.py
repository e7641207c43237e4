"""Whole-scene nearest-hit and any-hit kernels (``wasm_pathtracer_tpu.ops.scene_pallas``).

The scene's primitive families (plane, sphere, triangle, torus, aarect,
square) live in one concatenated float32 table, :class:`SceneTables`.
Two kernels, written in CUDA C++ for Hopper (``csrc/scene_kernels.cu``),
run every ray through every family:

- :func:`fused_nearest` -> (t, fam, slot): the nearest hit, first-minimum
  slot within a family, earliest family on ties across families;
- :func:`fused_occluded` -> occluded: the any-hit shadow predicate that
  ignores the sampled light's own shape.

Beside each is its plain PyTorch version (``*_reference``), built from
the (R, P) candidate matrices of ``ops.intersect``.  A wrapper takes the
plain version for tensors on the CPU; for CUDA tensors it launches the
kernel, and raises if the kernel does not build or launch.  Each
wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import dataclasses

import torch

from wasm_pathtracer_tpu_torch.ops import intersect as isx

SLOT_BITS = 20
_SLOT_MASK = (1 << SLOT_BITS) - 1

FAMILIES = ("plane", "sphere", "triangle", "torus", "aarect", "square")
FAM_PLANE, FAM_SPHERE, FAM_TRI, FAM_TORUS, FAM_AARECT, FAM_SQUARE = range(6)
# parameter columns each family's kernel reads, in FAMILIES order
WIDTHS = (6, 4, 9, 5, 6, 4)
# the kernels stage the whole table in shared memory: at most 227 KB a
# block on Hopper
MAX_TABLE_BYTES = 227 * 1024


@dataclasses.dataclass(frozen=True)
class SceneTables:
    """Per-family primitive rows, concatenated in FAMILIES order.

    ``flat`` is a contiguous (sum(n_f * K_f),) float32 tensor; family f
    holds ``counts[f]`` rows of ``WIDTHS[f]`` floats.
    """

    flat: torch.Tensor
    counts: tuple

    def family(self, fam: int) -> torch.Tensor:
        start = sum(n * k for n, k in zip(self.counts[:fam], WIDTHS))
        n, k = self.counts[fam], WIDTHS[fam]
        return self.flat[start:start + n * k].view(n, k)


def build_tables(index_sets, params) -> SceneTables:
    """Gather the family tables from the unified (N, 9) shape table;
    ``index_sets`` are the six per-family shape-id tensors."""
    rows = [params[idx][:, :k].reshape(-1) for idx, k in zip(index_sets, WIDTHS)]
    counts = tuple(int(idx.shape[0]) for idx in index_sets)
    return SceneTables(torch.cat(rows).contiguous(), counts)


def shape_codes(index_sets, n_shapes: int, device=None) -> torch.Tensor:
    """(N,) int32 map shape id -> ``fam << SLOT_BITS | slot`` (-2 where
    the shape is in no family; it matches no candidate).
    ``index_sets`` are the six per-family shape-id tensors."""
    code_of = torch.full((n_shapes,), -2, dtype=torch.int32, device=device)
    for fam, idx in enumerate(index_sets):
        n = idx.shape[0]
        if n:
            code_of[idx] = (fam << SLOT_BITS) + torch.arange(
                n, dtype=torch.int32, device=code_of.device)
    return code_of


def _family_distances(fam: int, rows, o, d):
    """(R, n) candidate distances of one family (inf = miss)."""
    if fam == FAM_PLANE:
        return isx.rays_vs_planes(o, d, rows[:, 0:3], rows[:, 3:6])
    if fam == FAM_SPHERE:
        return isx.rays_vs_spheres(o, d, rows[:, 0:3], rows[:, 3])
    if fam == FAM_TRI:
        return isx.rays_vs_triangles(o, d, rows[:, 0:3], rows[:, 3:6],
                                     rows[:, 6:9])
    if fam == FAM_TORUS:
        return isx.rays_vs_tori(o, d, rows[:, 0:3], rows[:, 3], rows[:, 4])
    if fam == FAM_AARECT:
        return isx.rays_vs_aarects(o, d, rows[:, 0:3], rows[:, 3:6])
    return isx.rays_vs_squares(o, d, rows[:, 0:3], rows[:, 3])


def fused_nearest_reference(tables: SceneTables, o, d):
    """Plain PyTorch version of :func:`fused_nearest`."""
    R = o.shape[0]
    best_t = torch.full((R,), float("inf"), dtype=torch.float32, device=o.device)
    best_code = torch.full((R,), -1, dtype=torch.int32, device=o.device)
    for fam in range(len(FAMILIES)):
        if tables.counts[fam] == 0:
            continue
        t = _family_distances(fam, tables.family(fam), o, d)
        tmin, slot = torch.min(t, dim=1)       # first minimum on ties
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_code = torch.where(better, (fam << SLOT_BITS) + slot.to(torch.int32),
                                best_code)
    fam = torch.where(best_code >= 0, best_code >> SLOT_BITS, -1)
    slot = torch.where(best_code >= 0, best_code & _SLOT_MASK, 0)
    return best_t, fam.to(torch.int32), slot.to(torch.int32)


def fused_occluded_reference(tables: SceneTables, o, d, dist, excl_code):
    """Plain PyTorch version of :func:`fused_occluded`."""
    R = o.shape[0]
    inf = float("inf")
    t_non = torch.full((R,), inf, dtype=torch.float32, device=o.device)
    t_exc = torch.full((R,), inf, dtype=torch.float32, device=o.device)
    for fam in range(len(FAMILIES)):
        n = tables.counts[fam]
        if n == 0:
            continue
        t = _family_distances(fam, tables.family(fam), o, d)
        code = (fam << SLOT_BITS) + torch.arange(n, dtype=torch.int32,
                                                 device=o.device)
        is_exc = code[None, :] == excl_code[:, None]
        t_non = torch.minimum(t_non, torch.where(is_exc, inf, t).amin(dim=1))
        t_exc = torch.minimum(t_exc, torch.where(is_exc, t, inf).amin(dim=1))
    return (t_non < dist) & (t_non < t_exc)


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_launch_inputs(tables: SceneTables, o, d):
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"scene kernels run on CUDA tensors, got {dev}")
    R = o.shape[0]
    _check("o", o, (R, 3), torch.float32, dev)
    _check("d", d, (R, 3), torch.float32, dev)
    n_floats = sum(n * k for n, k in zip(tables.counts, WIDTHS))
    _check("tables.flat", tables.flat, (n_floats,), torch.float32, dev)
    if 4 * n_floats > MAX_TABLE_BYTES:
        raise ValueError(
            f"scene tables of {4 * n_floats} bytes exceed the {MAX_TABLE_BYTES} "
            "bytes of shared memory a block can hold; scenes this large need "
            "the cluster structure of the mesh slice")
    return dev, R


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def fused_nearest(tables: SceneTables, o, d):
    """Nearest hit of each ray over the whole scene.

    Args:
      tables: ``ScenePrep.tables`` (:func:`build_tables`).
      o, d: (R, 3) float32 rays.

    Returns (t (R,) f32, fam (R,) i32 with -1 on a miss, slot (R,) i32).
    """
    if o.device.type == "cpu":
        return fused_nearest_reference(tables, o, d)
    from wasm_pathtracer_tpu_torch.ops import _build
    dev, R = _check_launch_inputs(tables, o, d)
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    fam = torch.empty((R,), dtype=torch.int32, device=dev)
    slot = torch.empty((R,), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.wpt_fused_nearest(
            tables.flat.data_ptr(), *tables.counts, o.data_ptr(), d.data_ptr(),
            R, t.data_ptr(), fam.data_ptr(), slot.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "fused_nearest")
    fused_nearest.launches += 1
    return t, fam, slot


fused_nearest.launches = 0


def fused_occluded(tables: SceneTables, o, d, dist, excl_code):
    """Occlusion predicate over the whole scene.

    Args:
      tables: ``ScenePrep.tables`` (:func:`build_tables`).
      o, d: (R, 3) float32 shadow rays (d normalized toward the light).
      dist: (R,) float32 distance to the light sample point.
      excl_code: (R,) int32 ``fam << SLOT_BITS | slot`` code of the
        sampled light shape (it does not occlude), -1 for none.

    Returns (R,) bool: occluded iff the nearest non-light candidate is
    nearer than both the light point and the light shape's own nearest
    candidate.
    """
    if o.device.type == "cpu":
        return fused_occluded_reference(tables, o, d, dist, excl_code)
    from wasm_pathtracer_tpu_torch.ops import _build
    dev, R = _check_launch_inputs(tables, o, d)
    _check("dist", dist, (R,), torch.float32, dev)
    _check("excl_code", excl_code, (R,), torch.int32, dev)
    occ = torch.empty((R,), dtype=torch.bool, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.wpt_fused_occluded(
            tables.flat.data_ptr(), *tables.counts, o.data_ptr(), d.data_ptr(),
            dist.data_ptr(), excl_code.data_ptr(), R, occ.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "fused_occluded")
    fused_occluded.launches += 1
    return occ


fused_occluded.launches = 0


def trace_scene_fused(prep, scene, o, d):
    """Nearest hit with the ``trace.trace_scene`` contract:
    (t, shape_id, hit_mask, cost); cost is the per-ray primitive-test
    count (every family tests all its primitives)."""
    tables = prep.tables
    t, fam, slot = fused_nearest(tables, o.contiguous(), d.contiguous())
    hit = torch.isfinite(t)
    sid = prep.sid_of_slot[prep.fam_offset[torch.clamp(fam, min=0)] + slot]
    sid = torch.where(hit, sid, -1)
    cost = torch.full((o.shape[0],), sum(tables.counts), dtype=torch.int64,
                      device=o.device)
    return torch.where(hit, t, float("inf")), sid, hit, cost


def occluded_fused(prep, scene, o, d, dist, light_sid):
    """Any-hit shadow query; the sampled light shape does not occlude.

    Returns (occluded (R,) bool, cost (R,) int64).
    """
    tables = prep.tables
    excl = prep.code_of[torch.clamp(light_sid, min=0)]
    excl = torch.where(light_sid >= 0, excl, -1).to(torch.int32).contiguous()
    occ = fused_occluded(tables, o.contiguous(), d.contiguous(),
                         dist.contiguous(), excl)
    cost = torch.full((o.shape[0],), sum(tables.counts), dtype=torch.int64,
                      device=o.device)
    return occ, cost
