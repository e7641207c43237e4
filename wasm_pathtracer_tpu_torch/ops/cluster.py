"""Cluster-dense traversal for scenes with many finite primitives
(``wasm_pathtracer_tpu.ops.cluster``).

Primitives of any finite family are grouped into fixed-size clusters of
G shapes: contiguous runs of a BVH's leaf order (``ops.bvh``), so each
cluster is spatially tight.  A ray finds its nearest hit by probing
clusters in ascending (entry distance, cluster id) order, testing all G
primitives of a cluster with a masked type switch, and stops once the
next cluster's entry lies beyond its best hit.

:func:`trace_clusters` is the lockstep form of that loop (one probe
round for every ray at a time, through the probe kernel of
``ops.probe_kernels``); ``ops.wavefront.render_queue_flat`` folds the
same visit order into the path loop.  The ``_*_block_test`` functions
are the per-family tests on per-ray (R, G, 9) blocks: the plain
versions behind the probe kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wasm_pathtracer_tpu_torch.models.scene import PrimType
from wasm_pathtracer_tpu_torch.ops import intersect as isx
from wasm_pathtracer_tpu_torch.ops import traverse_kernels as tk
from wasm_pathtracer_tpu_torch.utils import vecmath as vm
from wasm_pathtracer_tpu_torch.utils.device import resolve_device
from wasm_pathtracer_tpu_torch.utils.spans import span

CLUSTER_SIZE = 128   # primitives per cluster (G)
# the probe kernels' table rows: params 0-8, PrimType code, shape id
TABLE_ROWS = 11


@dataclasses.dataclass(frozen=True)
class ClusterSet:
    """The cluster tables, and the three packed layouts the kernels read.

    ``table`` (C, 11, G) f32 holds, per cluster, the parameter rows
    transposed (row k = parameter k of the G slots), then the PrimType
    code (-1 on padding) and the shape id (-1 on padding) as f32 (exact
    below 2^24).  ``staged`` (C, 4, G, 4) f32 holds the triangle slots in
    the dense sweep's staged form (``traverse_kernels.staged_rows``: the
    plane ``n | n.v0``, then ``m_i | k_i`` per edge), row q of every slot
    together, so that a lane group reads row q of its slots as one
    contiguous run of float4; it is zero, and so never hit, on every
    other slot.  ``aabbs`` (6, C) f32 holds lo.xyz then hi.xyz, one row
    per coordinate.
    """

    lo: torch.Tensor           # (C, 3) f32 cluster AABB min
    hi: torch.Tensor           # (C, 3) f32 cluster AABB max
    blocks: torch.Tensor       # (C, G, 9) f32 primitive rows, zero padding
    btype: torch.Tensor        # (C, G) int32 PrimType, -1 = padding
    slot_to_sid: torch.Tensor  # (C * G,) int64 slot -> shape id, -1 = padding
    families: tuple            # PrimType codes present, ascending
    table: torch.Tensor        # (C, 11, G) f32, see above
    staged: torch.Tensor       # (C, 4, G, 4) f32, see above
    aabbs: torch.Tensor        # (6, C) f32, see above
    # the lockstep trace probes with the unreduced kernel and takes the
    # first minimum outside it (the form of the JAX lockstep trace); set
    # with dataclasses.replace
    unreduced_probe: bool = False
    # whether an area light is baked into the tables: light-geometry
    # training must then refuse the prep, since a moved light would stay
    # where the tables hold it (``ops.bvh.attach_clusters`` sets it;
    # ``exclude_lights=True`` keeps the lights in the dense remainder)
    has_baked_lights: bool = True

    @property
    def num_clusters(self) -> int:
        return self.blocks.shape[0]

    @property
    def group(self) -> int:
        return self.blocks.shape[1]


# ClusterSet's array fields, as the JAX package's ClusterSet names them
ARRAY_FIELDS = ("lo", "hi", "blocks", "btype", "slot_to_sid")


def cluster_from_numpy(arrays: dict, families, device=None) -> ClusterSet:
    """A :class:`ClusterSet` from a dict of arrays keyed by
    :data:`ARRAY_FIELDS` (e.g. the JAX package's ``ClusterSet`` read
    field by field with ``np.asarray``) and the static family tuple."""
    device = resolve_device(device)
    lo = np.asarray(arrays["lo"], np.float32)
    hi = np.asarray(arrays["hi"], np.float32)
    blocks = np.asarray(arrays["blocks"], np.float32)
    btype = np.asarray(arrays["btype"], np.int32)
    sids = np.asarray(arrays["slot_to_sid"]).astype(np.int64)
    C, G, _ = blocks.shape
    table = np.concatenate(
        [blocks.transpose(0, 2, 1), btype[:, None, :].astype(np.float32),
         sids.reshape(C, 1, G).astype(np.float32)], axis=1)
    aabbs = np.concatenate([lo.T, hi.T], axis=0)

    def t(a):
        return torch.from_numpy(np.array(a, order="C")).to(device)   # a writable copy

    blocks_t, btype_t = t(blocks), t(btype)
    return ClusterSet(lo=t(lo), hi=t(hi), blocks=blocks_t, btype=btype_t,
                      slot_to_sid=t(sids), families=tuple(int(f) for f in families),
                      table=t(table), staged=staged_table(blocks_t, btype_t),
                      aabbs=t(aabbs))


def staged_table(blocks, btype):
    """(C, 4, G, 4) f32: the triangle slots of (C, G, 9) ``blocks`` in the
    staged form, computed once on their own device, zero on every slot
    that is not a triangle (see :class:`ClusterSet`)."""
    C, G, _ = blocks.shape
    rows = tk.staged_rows(blocks.reshape(C * G, 9))
    rows = torch.where(btype.reshape(C * G, 1) == int(PrimType.TRIANGLE), rows, 0.0)
    return rows.view(C, G, 4, 4).transpose(1, 2).contiguous()


def prim_aabbs(rows: np.ndarray, ptypes: np.ndarray):
    """Host-side AABBs of a (N, 9) parameter-row table of finite
    primitives, padded by the triangle slack 0.1 * EPSILON."""
    rows = np.asarray(rows, np.float32)
    ptypes = np.asarray(ptypes)
    n = rows.shape[0]
    lo = np.zeros((n, 3), np.float32)
    hi = np.zeros((n, 3), np.float32)

    m = ptypes == int(PrimType.TRIANGLE)
    if m.any():
        v = rows[m, :9].reshape(-1, 3, 3)
        lo[m], hi[m] = v.min(1), v.max(1)
    m = ptypes == int(PrimType.SPHERE)
    if m.any():
        c, r = rows[m, 0:3], rows[m, 3:4]
        lo[m], hi[m] = c - r, c + r
    m = ptypes == int(PrimType.TORUS)
    if m.any():
        c = rows[m, 0:3]
        ext = np.stack([rows[m, 3] + rows[m, 4], rows[m, 4],
                        rows[m, 3] + rows[m, 4]], axis=-1)
        lo[m], hi[m] = c - ext, c + ext
    m = ptypes == int(PrimType.AARECT)
    if m.any():
        lo[m], hi[m] = rows[m, 0:3], rows[m, 3:6]
    m = ptypes == int(PrimType.SQUARE)
    if m.any():
        c, s = rows[m, 0:3], rows[m, 3]
        half = np.stack([s / 2, np.zeros_like(s), s / 2], axis=-1)
        lo[m], hi[m] = c - half, c + half

    pad = np.float32(0.1 * 2e-4)
    return lo - pad, hi + pad


def build_clusters(rows: np.ndarray, ptypes: np.ndarray, prim_index: np.ndarray,
                   group: int = CLUSTER_SIZE, device=None) -> ClusterSet:
    """Partition leaf-ordered finite primitives into clusters of
    ``group``: ``rows`` (T, 9) parameter rows, ``ptypes`` (T,) PrimType
    codes and ``prim_index`` (T,) shape ids, all in leaf order."""
    device = resolve_device(device)
    rows = np.asarray(rows, np.float32)
    ptypes = np.asarray(ptypes, np.int32)
    prim_index = np.asarray(prim_index, np.int64)
    T = rows.shape[0]
    pad = (-T) % group
    C = (T + pad) // group
    lo_t, hi_t = prim_aabbs(rows, ptypes)
    lo_p = np.pad(lo_t, ((0, pad), (0, 0)), constant_values=1e30)
    hi_p = np.pad(hi_t, ((0, pad), (0, 0)), constant_values=-1e30)
    arrays = dict(
        lo=lo_p.reshape(C, group, 3).min(axis=1),
        hi=hi_p.reshape(C, group, 3).max(axis=1),
        blocks=np.pad(rows, ((0, pad), (0, 0))).reshape(C, group, 9),
        btype=np.pad(ptypes, (0, pad), constant_values=-1).reshape(C, group),
        slot_to_sid=np.pad(prim_index, (0, pad), constant_values=-1))
    return cluster_from_numpy(arrays, sorted(int(t) for t in np.unique(ptypes)),
                              device)


def _rays_vs_boxes(o, d, lo, hi):
    """(R, 3) rays x (C, 3) boxes -> (R, C) entry distance (0 when the
    origin is inside), +inf on a miss."""
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-30, 1e-30, d)
    t1 = (lo[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    t2 = (hi[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = (tmax >= tmin) & (tmax > 0.0)
    return torch.where(hit, torch.clamp(tmin, min=0.0), torch.inf)


# ---------------------------------------------------------------------------
# Per-family tests of (R, 3) rays against per-ray (R, G, 9) blocks
# ---------------------------------------------------------------------------

def _tri_block_test(o, d, block):
    v0, v1, v2 = block[..., 0:3], block[..., 3:6], block[..., 6:9]
    n = vm.cross(v1 - v0, v2 - v0)                        # (R, G, 3)
    ndd = torch.sum(n * d[:, None, :], -1)
    ndd = torch.where(torch.abs(ndd) < 1e-30, 1e-30, ndd)
    t = (torch.sum(n * v0, -1) - torch.sum(n * o[:, None, :], -1)) / ndd
    nn = n * torch.rsqrt(torch.clamp(torch.sum(n * n, -1), min=1e-30))[..., None]
    p = o[:, None, :] + d[:, None, :] * t[..., None]
    inside = torch.ones(t.shape, dtype=torch.bool, device=t.device)
    for a, b in ((v0, v1), (v1, v2), (v2, v0)):
        c = vm.cross(b - a, p - a)
        inside &= torch.sum(c * nn, -1) + 0.1 * 2e-4 >= 0.0
    return torch.where(inside & (t > 0.0), t, torch.inf)


def _sphere_block_test(o, d, block):
    oc = o[:, None, :] - block[..., 0:3]
    rad = block[..., 3]
    b = 2.0 * torch.sum(oc * d[:, None, :], -1)
    c = torch.sum(oc * oc, -1) - rad * rad
    disc = b * b - 4.0 * c
    sq = vm.sqrt(torch.where(disc > 0.0, disc, 1.0))
    sq = torch.where(disc > 0.0, sq, 0.0)
    t0 = (-b + sq) * 0.5
    t1 = (-b - sq) * 0.5
    tn, tf = torch.minimum(t0, t1), torch.maximum(t0, t1)
    t = torch.where(tn > 0.0, tn, tf)
    return torch.where((disc >= 0.0) & (t > 0.0) & (rad > 0.0), t, torch.inf)


def _aarect_block_test(o, d, block):
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-30, 1e-30, d)
    t1 = (block[..., 0:3] - o[:, None, :]) * inv_d[:, None, :]
    t2 = (block[..., 3:6] - o[:, None, :]) * inv_d[:, None, :]
    tmin = torch.amax(torch.minimum(t1, t2), -1)
    tmax = torch.amin(torch.maximum(t1, t2), -1)
    t = torch.where(tmin > 0.0, tmin, tmax)
    return torch.where((tmin < tmax) & (t > 0.0), t, torch.inf)


def _square_block_test(o, d, block):
    dy = d[:, None, 1]
    ndd = torch.where(torch.abs(dy) < 1e-30, 1e-30, dy)
    t = (block[..., 1] - o[:, None, 1]) / ndd
    px = o[:, None, 0] + d[:, None, 0] * t
    pz = o[:, None, 2] + d[:, None, 2] * t
    size = block[..., 3]
    inside = (2.0 * torch.abs(px - block[..., 0]) < size) \
        & (2.0 * torch.abs(pz - block[..., 2]) < size)
    return torch.where(inside & (t > 0.0) & (dy != 0.0), t, torch.inf)


def _torus_block_test(o, d, block):
    lo = o[:, None, :] - block[..., 0:3]
    return isx.tori_march(lo, d[:, None, :], block[..., 3], block[..., 4])


_BLOCK_TESTS = {
    int(PrimType.TRIANGLE): _tri_block_test,
    int(PrimType.SPHERE): _sphere_block_test,
    int(PrimType.TORUS): _torus_block_test,
    int(PrimType.AARECT): _aarect_block_test,
    int(PrimType.SQUARE): _square_block_test,
}


def _block_test(o, d, block, btype, families):
    """Masked type-switched test of per-ray (R, G, 9) blocks with (R, G)
    type codes -> (R, G) distances, +inf on a miss or padding.  Only the
    families present are evaluated."""
    t = torch.full(btype.shape, torch.inf, dtype=torch.float32, device=o.device)
    for fam in families:
        t = torch.where(btype == fam, _BLOCK_TESTS[fam](o, d, block), t)
    return t


def trace_clusters(cs: ClusterSet, o, d, t_init):
    """Nearest hit through the cluster structure, all rays in lockstep:
    each round, every ray whose nearest unprobed cluster enters before
    its best hit probes that cluster, then retires it.  A round is
    ``probe_kernels.probe_min``, or with ``cs.unreduced_probe`` the JAX
    lockstep trace's own form: the (R, G) distances of
    ``probe_kernels.probe_blocks`` and their first minimum taken here.
    The loop polls on the host once per round.

    Returns (t, shape_id, rounds): the best hit if nearer than
    ``t_init`` (t_init and -1 otherwise) and the per-ray probe count.
    Where the JAX version returns a leaf slot, this returns the shape id
    the probe kernel resolved from it.
    """
    from wasm_pathtracer_tpu_torch.ops import probe_kernels
    R = o.shape[0]
    o, d = o.contiguous(), d.contiguous()
    ent = _rays_vs_boxes(o, d, cs.lo, cs.hi)              # (R, C)
    rows = torch.arange(R, device=o.device)
    t_best = t_init
    sid_best = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    rounds = torch.zeros((R,), dtype=torch.int64, device=o.device)
    while True:
        e, c = torch.min(ent, dim=1)                      # first minimum
        active = e < t_best
        with span("sync.cluster_active"):
            if not bool(active.any()):
                break
        rounds += active
        if cs.unreduced_probe:
            t = probe_kernels.probe_blocks(cs, o, d, c.to(torch.int32))
            tloc, j = torch.min(t, dim=1)                 # first minimum
            sid_loc = cs.slot_to_sid.view(cs.num_clusters, cs.group)[c, j]
            sid_loc = torch.where(torch.isfinite(tloc), sid_loc, -1)
        else:
            tloc, sid_loc = probe_kernels.probe_min(cs, o, d, c.to(torch.int32))
        better = active & (tloc < t_best)
        t_best = torch.where(better, tloc, t_best)
        sid_best = torch.where(better, sid_loc, sid_best)
        ent[rows, c] = torch.inf
    return t_best, sid_best, rounds
