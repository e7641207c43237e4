"""Whole-scene nearest-hit and any-hit kernels (``wasm_pathtracer_tpu.ops.scene_pallas``).

The scene's primitive families (plane, sphere, triangle, torus, aarect,
square) live in one concatenated float32 table, :class:`SceneTables`.
Two kernels, written in CUDA C++ for Hopper (``csrc/scene_kernels.cu``),
run every ray through every family:

- :func:`fused_nearest` -> (t, shape id): the nearest hit, first-minimum
  slot within a family, earliest family on ties across families, mapped
  to its shape id in the kernel;
- :func:`fused_occluded` -> occluded: the any-hit shadow predicate that
  ignores the sampled light's own shape (the kernel maps the light's
  shape id to its family code).

Beside each is its plain PyTorch version (``*_reference``), built from
the (R, P) candidate matrices of ``ops.intersect``.  A wrapper takes the
plain version for tensors on the CPU; for CUDA tensors it launches the
kernel, and raises if the kernel does not build or launch.  Each
wrapper counts its launches in ``<wrapper>.launches``.

The kernels test triangles in the staged form of the dense sweep
(``ops.traverse_kernels.staged_rows``), and K2 decides by the limit
min(dist, t_exc) at which its lanes stop: :func:`fused_nearest_staged`
and :func:`fused_occluded_staged` are that arithmetic in plain PyTorch,
for the tests.  They differ from the plain versions by rounding in the
triangles' inside test, which only rays within rounding of an edge can
feel.  (The kernels' torus marches take approximate square roots; that
is left to the checks on the card.)
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from wasm_pathtracer_tpu_torch.ops import intersect as isx

SLOT_BITS = 20
_SLOT_MASK = (1 << SLOT_BITS) - 1

FAMILIES = ("plane", "sphere", "triangle", "torus", "aarect", "square")
FAM_PLANE, FAM_SPHERE, FAM_TRI, FAM_TORUS, FAM_AARECT, FAM_SQUARE = range(6)
# parameter columns each family's kernel reads, in FAMILIES order
WIDTHS = (6, 4, 9, 5, 6, 4)
# the kernels stage the whole table in shared memory, a triangle in the
# staged form (four float4): at most 227 KB a block on Hopper
MAX_TABLE_BYTES = 227 * 1024
TRI_STAGE_BYTES = 64


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
    ``index_sets`` are the six per-family shape-id tensors; the map lands
    on ``device``, by default theirs."""
    device = index_sets[0].device if device is None else device
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


def _staged_family_distances(fam: int, rows, o, d):
    """:func:`_family_distances` with the triangles as the kernels test
    them (the staged form)."""
    if fam == FAM_TRI:
        from wasm_pathtracer_tpu_torch.ops import traverse_kernels as tk
        return tk._staged_distances(tk.staged_rows(rows), o, d)
    return _family_distances(fam, rows, o, d)


def _sid_of_codes(tables: SceneTables, code, sid_of_slot):
    """(R,) int64 shape id of each ``fam << SLOT_BITS | slot`` code, -1
    for -1."""
    offsets = [sum(tables.counts[:f]) for f in range(len(FAMILIES))]
    hit = code >= 0
    fam = torch.where(hit, code >> SLOT_BITS, 0).long()
    slot = torch.where(hit, code & _SLOT_MASK, 0).long()
    idx = torch.as_tensor(offsets, device=code.device)[fam] + slot
    return torch.where(hit, sid_of_slot[idx], -1)


def _nearest(tables: SceneTables, o, d, sid_of_slot, distances):
    R = o.shape[0]
    best_t = torch.full((R,), float("inf"), dtype=torch.float32, device=o.device)
    best_code = torch.full((R,), -1, dtype=torch.int32, device=o.device)
    for fam in range(len(FAMILIES)):
        if tables.counts[fam] == 0:
            continue
        t = distances(fam, tables.family(fam), o, d)
        tmin, slot = torch.min(t, dim=1)       # first minimum on ties
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_code = torch.where(better, (fam << SLOT_BITS) + slot.to(torch.int32),
                                best_code)
    return best_t, _sid_of_codes(tables, best_code, sid_of_slot)


def fused_nearest_reference(tables: SceneTables, o, d, sid_of_slot):
    """Plain PyTorch version of :func:`fused_nearest`."""
    return _nearest(tables, o, d, sid_of_slot, _family_distances)


def fused_nearest_staged(tables: SceneTables, o, d, sid_of_slot):
    """:func:`fused_nearest` by the CUDA kernel's arithmetic in plain
    PyTorch (used by the tests only)."""
    return _nearest(tables, o, d, sid_of_slot, _staged_family_distances)


def _excl_codes(light_sid, code_of):
    """(R,) int32 family code of each light shape id, -1 for -1."""
    return torch.where(light_sid >= 0, code_of[torch.clamp(light_sid, min=0)],
                       -1).to(torch.int32)


def _candidates(tables: SceneTables, o, d, excl, distances):
    """[(t (R, n), is_exc (R, n))] per non-empty family: candidate
    distances and which of them is the light's own primitive."""
    out = []
    for fam in range(len(FAMILIES)):
        n = tables.counts[fam]
        if n == 0:
            continue
        t = distances(fam, tables.family(fam), o, d)
        code = (fam << SLOT_BITS) + torch.arange(n, dtype=torch.int32,
                                                 device=o.device)
        out.append((t, code[None, :] == excl[:, None]))
    return out


def fused_occluded_reference(tables: SceneTables, o, d, dist, light_sid, code_of):
    """Plain PyTorch version of :func:`fused_occluded`: the TPU kernel's
    t_non < dist & t_non < t_exc."""
    R = o.shape[0]
    inf = float("inf")
    t_non = torch.full((R,), inf, dtype=torch.float32, device=o.device)
    t_exc = torch.full((R,), inf, dtype=torch.float32, device=o.device)
    excl = _excl_codes(light_sid, code_of)
    for t, is_exc in _candidates(tables, o, d, excl, _family_distances):
        t_non = torch.minimum(t_non, torch.where(is_exc, inf, t).amin(dim=1))
        t_exc = torch.minimum(t_exc, torch.where(is_exc, t, inf).amin(dim=1))
    return (t_non < dist) & (t_non < t_exc)


def fused_occluded_staged(tables: SceneTables, o, d, dist, light_sid, code_of):
    """:func:`fused_occluded` as the CUDA kernel decides it, in plain
    PyTorch (used by the tests only): the light's own distance t_exc
    first, then occluded iff some other candidate has
    t < min(dist, t_exc), the test at which the kernel's lanes stop."""
    R = o.shape[0]
    inf = float("inf")
    excl = _excl_codes(light_sid, code_of)
    cands = _candidates(tables, o, d, excl, _staged_family_distances)
    t_exc = torch.full((R,), inf, dtype=torch.float32, device=o.device)
    for t, is_exc in cands:
        t_exc = torch.minimum(t_exc, torch.where(is_exc, t, inf).amin(dim=1))
    limit = torch.minimum(dist, t_exc)
    occ = torch.zeros((R,), dtype=torch.bool, device=o.device)
    for t, is_exc in cands:
        occ |= (~is_exc & (t < limit[:, None])).any(dim=1)
    return occ


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def table_bytes(counts) -> int:
    """Shared memory the kernels take for a scene of these family counts."""
    n_raw = sum(n * k for f, (n, k) in enumerate(zip(counts, WIDTHS)) if f != FAM_TRI)
    return TRI_STAGE_BYTES * counts[FAM_TRI] + 4 * n_raw


def _check_launch_inputs(tables: SceneTables, o, d):
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"scene kernels run on CUDA tensors, got {dev}")
    R = o.shape[0]
    _check("o", o, (R, 3), torch.float32, dev)
    _check("d", d, (R, 3), torch.float32, dev)
    n_floats = sum(n * k for n, k in zip(tables.counts, WIDTHS))
    _check("tables.flat", tables.flat, (n_floats,), torch.float32, dev)
    if table_bytes(tables.counts) > MAX_TABLE_BYTES:
        raise ValueError(
            f"scene tables of {table_bytes(tables.counts)} bytes of shared memory "
            f"exceed the {MAX_TABLE_BYTES} bytes a block can hold; scenes this "
            "large need the cluster structure of the mesh slice")
    return dev, R


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def fused_nearest(tables: SceneTables, o, d, sid_of_slot):
    """Nearest hit of each ray over the whole scene.

    Args:
      tables: ``ScenePrep.tables`` (:func:`build_tables`).
      o, d: (R, 3) float32 rays.
      sid_of_slot: int64 map from a slot of the concatenated families
        (family order) to its shape id (``ScenePrep.sid_of_slot``).

    Returns (t (R,) f32, +inf on a miss; shape id (R,) i64, -1 on a miss).
    """
    if o.device.type == "cpu":
        return fused_nearest_reference(tables, o, d, sid_of_slot)
    from wasm_pathtracer_tpu_torch.ops import _build
    dev, R = _check_launch_inputs(tables, o, d)
    _check("sid_of_slot", sid_of_slot, (sid_of_slot.shape[0],), torch.int64, dev)
    if sid_of_slot.shape[0] < sum(tables.counts):
        raise ValueError(f"sid_of_slot has {sid_of_slot.shape[0]} entries for "
                         f"{sum(tables.counts)} slots")
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    sid = torch.empty((R,), dtype=torch.int64, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.wpt_fused_nearest(
            tables.flat.data_ptr(), *tables.counts, o.data_ptr(), d.data_ptr(),
            sid_of_slot.data_ptr(), R, t.data_ptr(), sid.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "fused_nearest")
    fused_nearest.launches += 1
    return t, sid


fused_nearest.launches = 0


def fused_occluded(tables: SceneTables, o, d, dist, light_sid, code_of):
    """Occlusion predicate over the whole scene.

    Args:
      tables: ``ScenePrep.tables`` (:func:`build_tables`).
      o, d: (R, 3) float32 shadow rays (d normalized toward the light).
      dist: (R,) float32 distance to the light sample point.
      light_sid: (R,) int64 shape id of the sampled light (it does not
        occlude), -1 for none.
      code_of: (N,) int32 map from a shape id to its
        ``fam << SLOT_BITS | slot`` code (``ScenePrep.code_of``).

    Returns (R,) bool: occluded iff the nearest non-light candidate is
    nearer than both the light point and the light shape's own nearest
    candidate.
    """
    if o.device.type == "cpu":
        return fused_occluded_reference(tables, o, d, dist, light_sid, code_of)
    from wasm_pathtracer_tpu_torch.ops import _build
    dev, R = _check_launch_inputs(tables, o, d)
    _check("dist", dist, (R,), torch.float32, dev)
    _check("light_sid", light_sid, (R,), torch.int64, dev)
    _check("code_of", code_of, (code_of.shape[0],), torch.int32, dev)
    occ = torch.empty((R,), dtype=torch.bool, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.wpt_fused_occluded(
            tables.flat.data_ptr(), *tables.counts, o.data_ptr(), d.data_ptr(),
            dist.data_ptr(), light_sid.data_ptr(), code_of.data_ptr(), R,
            occ.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "fused_occluded")
    fused_occluded.launches += 1
    return occ


fused_occluded.launches = 0


def launch_shape() -> dict:
    """What K1 and K2 were built with: lanes per ray, threads per block,
    registers and spill bytes (needs the built library, so a card's
    toolkit)."""
    import ctypes

    from wasm_pathtracer_tpu_torch.ops import _build
    out = (ctypes.c_int * 8)()
    _raise_on(_build.library().wpt_scene_launch_shape(out), "scene_launch_shape")
    keys = ("lanes", "threads_per_block", "registers", "local_bytes")
    return {"fused_nearest": dict(zip(keys, out[:4])),
            "fused_occluded": dict(zip(keys, out[4:]))}


@functools.lru_cache(maxsize=16)
def _cost(total: int, R: int, device) -> torch.Tensor:
    """The constant per-ray primitive-test count; shared, so read-only."""
    return torch.full((R,), total, dtype=torch.int64, device=device)


def trace_scene_fused(prep, scene, o, d):
    """Nearest hit with the ``trace.trace_scene`` contract:
    (t, shape_id, hit_mask, cost); cost is the per-ray primitive-test
    count (every family tests all its primitives), a shared tensor that
    callers do not change in place."""
    t, sid = fused_nearest(prep.tables, o.contiguous(), d.contiguous(), prep.sid_of_slot)
    return t, sid, torch.isfinite(t), _cost(sum(prep.tables.counts), o.shape[0], o.device)


def occluded_fused(prep, scene, o, d, dist, light_sid):
    """Any-hit shadow query; the sampled light shape does not occlude.

    Returns (occluded (R,) bool, cost (R,) int64, shared as in
    :func:`trace_scene_fused`).
    """
    occ = fused_occluded(prep.tables, o.contiguous(), d.contiguous(), dist.contiguous(),
                         light_sid.contiguous(), prep.code_of)
    return occ, _cost(sum(prep.tables.counts), o.shape[0], o.device)
