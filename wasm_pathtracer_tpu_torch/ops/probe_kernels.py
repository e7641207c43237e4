"""Cluster select and probe kernels (``wasm_pathtracer_tpu.ops.probe_pallas``).

Five kernels, written in CUDA C++ for Hopper (``csrc/probe_kernels.cu``),
carry the cluster traversal:

- :func:`select_blocks` (K6): per ray, the slab test against every
  cluster box and, after the lex cursor ``(skip_e, skip_c)``, the two
  smallest unvisited (entry, id) pairs and the entry after both;
- :func:`select_scan` (K3): the same, plus the nearest hit over the
  small dense remainder of the scene (at most :data:`MAX_DENSE` shapes);
- :func:`probe_pair` (K4): two probe rounds, each the nearest of all G
  slots of one cluster per ray, first-minimum slot on ties;
- :func:`probe_min` (K5): one probe round;
- :func:`probe_blocks` (K7): one probe round unreduced, the (R, G)
  distances of every slot (the probe kernel compiled with a flag).

Beside each is its plain PyTorch version (``*_reference``): the slab
test and lexicographic reductions of the JAX flat wavefront, and the
gathered per-ray block test of ``ops.cluster``.  The select kernels
split a ray's boxes over several lanes and merge the lanes' candidates
(:func:`merge_top3`; :func:`select_blocks_lanes_reference` is that route
in plain PyTorch, for the tests).  The probe kernels test triangle slots
on the cluster set's staged table (``ClusterSet.staged``: the dense
sweep's staged form, built once per scene) and the other families on its
11-row table: :func:`probe_blocks_staged`, :func:`probe_min_staged` and
:func:`probe_pair_staged` are that arithmetic in plain PyTorch, for the
tests; they differ from the plain versions by rounding in the triangles'
inside test, which only rays within rounding of an edge can feel.  A
wrapper takes the plain version for tensors on the CPU; for CUDA tensors
it launches the kernel, and raises if the kernel does not build or
launch.  Each wrapper counts its launches in ``<wrapper>.launches``.

Cluster ids are int32 in [0, C); where an entry is +inf (no unvisited
cluster left) its id is meaningless.  Probe rounds return (t, shape id),
t = +inf and id = -1 on a miss.
"""

from __future__ import annotations

import torch

from wasm_pathtracer_tpu_torch.models.scene import PrimType
from wasm_pathtracer_tpu_torch.ops import cluster as cl
from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
from wasm_pathtracer_tpu_torch.ops import traverse_kernels as tk

# the largest dense remainder K3 folds into the select (the TPU kernel's
# limit; larger remainders go through K6 and the scene kernels)
MAX_DENSE = 64


def dense_scan_ok(prep) -> bool:
    """Whether the prep's dense remainder is small enough for K3."""
    return 0 < sum(prep.tables.counts) <= MAX_DENSE


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _unvisited_entries(cs: cl.ClusterSet, o, d, skip_e, skip_c):
    """(R, C) box entries, +inf on a miss and at or before the lex cursor."""
    ent = cl._rays_vs_boxes(o, d, cs.lo, cs.hi)
    cid = torch.arange(cs.num_clusters, device=o.device)
    se, sc = skip_e[:, None], skip_c[:, None]
    return torch.where((ent > se) | ((ent == se) & (cid > sc)), ent, torch.inf)


def _top3(ent, cid):
    """The two lexicographically smallest (entry, id) pairs of each row of
    ``ent`` (R, n), whose columns carry the ascending ids ``cid`` (n,), and
    the entry of the third: (e1, c1, e2, c2, e3)."""
    top = cid[-1]

    def lexmin(ent):
        # among minimal entries, the lowest id
        e = ent.amin(dim=1)
        c = torch.where(ent == e[:, None], cid, top + 1).amin(dim=1).clamp(max=top)
        rest = torch.where((ent > e[:, None]) |
                           ((ent == e[:, None]) & (cid > c[:, None])),
                           ent, torch.inf)
        return e, c.to(torch.int32), rest

    e_cur, c_cur, ent1 = lexmin(ent)
    e_b, c_b, ent2 = lexmin(ent1)
    return e_cur, c_cur, e_b, c_b, ent2.amin(dim=1)


def select_blocks_reference(cs: cl.ClusterSet, o, d, skip_e, skip_c):
    """Plain PyTorch version of :func:`select_blocks`."""
    return _top3(_unvisited_entries(cs, o, d, skip_e, skip_c),
                 torch.arange(cs.num_clusters, device=o.device))


def merge_top3(a, b):
    """The (e1, c1, e2, c2, e3) of the union of two disjoint sets of
    boxes from each set's own: the CUDA kernel's merge of two lanes.  The
    pairs compare lexicographically; the third needs no id.  Exact, since
    the three smallest of a union lie among each part's three smallest."""
    def lex_less(e, c, f, g):
        return (e < f) | ((e == f) & (c < g))

    swap = lex_less(b[0], b[1], a[0], a[1])
    a, b = ([torch.where(swap, y, x) for x, y in zip(a, b)],
            [torch.where(swap, x, y) for x, y in zip(a, b)])
    # a's first is the smallest; the second is a's second or b's first
    take = lex_less(b[0], b[1], a[2], a[3])
    return (a[0], a[1], torch.where(take, b[0], a[2]), torch.where(take, b[1], a[3]),
            torch.where(take, torch.minimum(a[2], b[2]), torch.minimum(a[4], b[0])))


def select_blocks_lanes_reference(cs: cl.ClusterSet, o, d, skip_e, skip_c, lanes: int):
    """:func:`select_blocks` as the CUDA kernel computes it, in plain
    PyTorch (used by the tests only): lane j of ``lanes`` selects among
    boxes j, j + lanes, ..., and the lanes merge in xor-butterfly order."""
    ent = _unvisited_entries(cs, o, d, skip_e, skip_c)
    cid = torch.arange(cs.num_clusters, device=o.device)
    none = (torch.full_like(ent[:, 0], torch.inf), torch.zeros_like(skip_c))
    # a lane past the last box holds no candidate
    part = [_top3(ent[:, j::lanes], cid[j::lanes]) if j < cs.num_clusters
            else (none[0], none[1], none[0], none[1], none[0]) for j in range(lanes)]
    off = 1
    while off < lanes:
        part = [merge_top3(part[j], part[j ^ off]) for j in range(lanes)]
        off *= 2
    return part[0]


def select_scan_reference(cs: cl.ClusterSet, prep, o, d, skip_e, skip_c):
    """Plain PyTorch version of :func:`select_scan`."""
    t, sid = sk.fused_nearest_reference(prep.tables, o, d, prep.sid_of_slot)
    return select_blocks_reference(cs, o, d, skip_e, skip_c) + (t, sid.to(torch.int32))


def _clamped(cs: cl.ClusterSet, cidx):
    return torch.clamp(cidx.long(), 0, cs.num_clusters - 1)


def probe_blocks_reference(cs: cl.ClusterSet, o, d, cidx):
    """Plain PyTorch version of :func:`probe_blocks`."""
    c = _clamped(cs, cidx)
    return cl._block_test(o, d, cs.blocks[c], cs.btype[c], cs.families)


def _round_min(cs: cl.ClusterSet, t, cidx):
    """(t, sid) of one round from its (R, G) distances: the first minimum."""
    tmin, j = torch.min(t, dim=1)
    sid = cs.slot_to_sid.view(cs.num_clusters, cs.group)[_clamped(cs, cidx), j]
    return tmin, torch.where(torch.isfinite(tmin), sid, -1).to(torch.int32)


def probe_min_reference(cs: cl.ClusterSet, o, d, cidx):
    """Plain PyTorch version of :func:`probe_min`."""
    return _round_min(cs, probe_blocks_reference(cs, o, d, cidx), cidx)


def probe_pair_reference(cs: cl.ClusterSet, o, d, c1, c2):
    """Plain PyTorch version of :func:`probe_pair`."""
    return probe_min_reference(cs, o, d, c1) + probe_min_reference(cs, o, d, c2)


def probe_blocks_staged(cs: cl.ClusterSet, o, d, cidx):
    """:func:`probe_blocks` by the CUDA kernel's arithmetic in plain
    PyTorch (used by the tests only): triangle slots from the staged
    table, every other family by the plain version's block test."""
    c = _clamped(cs, cidx)
    R, G = o.shape[0], cs.group
    rows = cs.staged[c].transpose(1, 2).reshape(R, G, 16)
    tri = cs.btype[c] == int(PrimType.TRIANGLE)
    others = tuple(f for f in cs.families if f != int(PrimType.TRIANGLE))
    t = cl._block_test(o, d, cs.blocks[c], cs.btype[c], others)
    return torch.where(tri, tk._staged_distances(rows, o, d), t)


def probe_min_staged(cs: cl.ClusterSet, o, d, cidx):
    """:func:`probe_min` by the CUDA kernel's arithmetic (the tests only)."""
    return _round_min(cs, probe_blocks_staged(cs, o, d, cidx), cidx)


def probe_pair_staged(cs: cl.ClusterSet, o, d, c1, c2):
    """:func:`probe_pair` by the CUDA kernel's arithmetic (the tests only)."""
    return probe_min_staged(cs, o, d, c1) + probe_min_staged(cs, o, d, c2)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_rays(o, d):
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"the cluster kernels run on CUDA tensors, got {dev}")
    R = o.shape[0]
    sk._check("o", o, (R, 3), torch.float32, dev)
    sk._check("d", d, (R, 3), torch.float32, dev)
    return dev, R


def _check_select(cs, o, d, skip_e, skip_c):
    dev, R = _check_rays(o, d)
    sk._check("skip_e", skip_e, (R,), torch.float32, dev)
    sk._check("skip_c", skip_c, (R,), torch.int32, dev)
    sk._check("cs.aabbs", cs.aabbs, (6, cs.num_clusters), torch.float32, dev)
    return dev, R


def _select_outputs(dev, R):
    return (torch.empty((3, R), dtype=torch.float32, device=dev),
            torch.empty((2, R), dtype=torch.int32, device=dev))


def select_blocks(cs: cl.ClusterSet, o, d, skip_e, skip_c):
    """The two smallest unvisited (entry, id) pairs after the cursor.

    Args:
      cs: the cluster structure (``cs.aabbs`` is read).
      o, d: (R, 3) float32 rays.
      skip_e, skip_c: (R,) float32 / int32 lex cursor, the last visited
        (entry, id); (-inf, -1) for a fresh trace.

    Returns (e_cur, c_cur, e_b, c_b, e_after): entries (R,) float32, +inf
    when none is left; ids (R,) int32.
    """
    if o.device.type == "cpu":
        return select_blocks_reference(cs, o, d, skip_e, skip_c)
    from wasm_pathtracer_tpu_torch.ops import _build
    dev, R = _check_select(cs, o, d, skip_e, skip_c)
    ent, cid = _select_outputs(dev, R)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.wpt_select(cs.aabbs.data_ptr(), cs.num_clusters, o.data_ptr(),
                            d.data_ptr(), skip_e.data_ptr(), skip_c.data_ptr(), R,
                            ent.data_ptr(), cid.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
    sk._raise_on(rc, "select_blocks")
    select_blocks.launches += 1
    return ent[0], cid[0], ent[1], cid[1], ent[2]


select_blocks.launches = 0


def select_scan(cs: cl.ClusterSet, prep, o, d, skip_e, skip_c):
    """:func:`select_blocks` plus the nearest hit over ``prep``'s dense
    remainder (``prep.tables``, at most :data:`MAX_DENSE` shapes).

    Returns (e_cur, c_cur, e_b, c_b, e_after, t_dense, sid_dense):
    ``t_dense`` (R,) float32, +inf on a miss; ``sid_dense`` (R,) int32
    shape id, -1 on a miss.
    """
    if o.device.type == "cpu":
        return select_scan_reference(cs, prep, o, d, skip_e, skip_c)
    from wasm_pathtracer_tpu_torch.ops import _build
    dev, R = _check_select(cs, o, d, skip_e, skip_c)
    tables = prep.tables
    n_dense = sum(tables.counts)
    if not 0 < n_dense <= MAX_DENSE:
        raise ValueError(f"select_scan takes 1 to {MAX_DENSE} dense shapes, "
                         f"got {n_dense}")
    sk._check("tables.flat", tables.flat,
              (sum(n * k for n, k in zip(tables.counts, sk.WIDTHS)),),
              torch.float32, dev)
    sk._check("prep.sid_of_slot", prep.sid_of_slot, (n_dense + 1,), torch.int64, dev)
    ent, cid = _select_outputs(dev, R)
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    sid = torch.empty((R,), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.wpt_select_scan(
            cs.aabbs.data_ptr(), cs.num_clusters, o.data_ptr(), d.data_ptr(),
            skip_e.data_ptr(), skip_c.data_ptr(), R, ent.data_ptr(), cid.data_ptr(),
            tables.flat.data_ptr(), *tables.counts, prep.sid_of_slot.data_ptr(),
            t.data_ptr(), sid.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    sk._raise_on(rc, "select_scan")
    select_scan.launches += 1
    return ent[0], cid[0], ent[1], cid[1], ent[2], t, sid


select_scan.launches = 0


def _check_probe(cs: cl.ClusterSet, o, d, cidx, cidx_shape):
    """Checks the probe's inputs; returns (device, R, the cluster set's
    leading arguments of ``wpt_probe``: table, staged, C, G, mixed)."""
    dev, R = _check_rays(o, d)
    sk._check("cidx", cidx, cidx_shape + (R,), torch.int32, dev)
    C, G = cs.num_clusters, cs.group
    sk._check("cs.table", cs.table, (C, cl.TABLE_ROWS, G), torch.float32, dev)
    sk._check("cs.staged", cs.staged, (C, 4, G, 4), torch.float32, dev)
    if cs.staged.data_ptr() % 16:
        raise ValueError("cs.staged must be 16-byte aligned (the kernel reads float4)")
    mixed = int(cs.families != (int(PrimType.TRIANGLE),))
    return dev, R, (cs.table.data_ptr(), cs.staged.data_ptr(), C, G, mixed)


def _probe(cs: cl.ClusterSet, o, d, cidx, name):
    from wasm_pathtracer_tpu_torch.ops import _build
    n_rounds = cidx.shape[0]
    dev, R, head = _check_probe(cs, o, d, cidx, (n_rounds,))
    t = torch.empty((n_rounds, R), dtype=torch.float32, device=dev)
    sid = torch.empty((n_rounds, R), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.wpt_probe(*head, o.data_ptr(), d.data_ptr(), cidx.data_ptr(), n_rounds,
                           R, t.data_ptr(), sid.data_ptr(),
                           torch.cuda.current_stream(dev).cuda_stream)
    sk._raise_on(rc, name)
    return t, sid


def probe_min(cs: cl.ClusterSet, o, d, cidx):
    """One probe round: the nearest of the G slots of cluster
    ``cidx[i]`` (int32, clamped into [0, C)) for each ray.

    Returns (t (R,) float32, sid (R,) int32): +inf / -1 on a miss.
    """
    if o.device.type == "cpu":
        return probe_min_reference(cs, o, d, cidx)
    t, sid = _probe(cs, o, d, cidx[None], "probe_min")
    probe_min.launches += 1
    return t[0], sid[0]


probe_min.launches = 0


def probe_pair(cs: cl.ClusterSet, o, d, c1, c2):
    """Two probe rounds in one launch, clusters ``c1`` then ``c2``.

    Returns (t1, sid1, t2, sid2), each round as :func:`probe_min`.
    """
    if o.device.type == "cpu":
        return probe_pair_reference(cs, o, d, c1, c2)
    t, sid = _probe(cs, o, d, torch.stack([c1, c2]), "probe_pair")
    probe_pair.launches += 1
    return t[0], sid[0], t[1], sid[1]


probe_pair.launches = 0


def probe_blocks(cs: cl.ClusterSet, o, d, cidx):
    """One probe round without the reduction: the distance from each
    ray to every slot of cluster ``cidx[i]`` (int32, clamped into
    [0, C)).

    Returns (R, G) float32, +inf on a miss or a padding slot.
    """
    if o.device.type == "cpu":
        return probe_blocks_reference(cs, o, d, cidx)
    from wasm_pathtracer_tpu_torch.ops import _build
    dev, R, head = _check_probe(cs, o, d, cidx, ())
    dist = torch.empty((R, cs.group), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.wpt_probe_blocks(*head, o.data_ptr(), d.data_ptr(), cidx.data_ptr(), R,
                                  dist.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream)
    sk._raise_on(rc, "probe_blocks")
    probe_blocks.launches += 1
    return dist


probe_blocks.launches = 0


def launch_shape(n_rays: int, n_rounds: int) -> dict:
    """The launch grids of K4/K5 (R rays, ``n_rounds`` rounds) and of K7
    (R rays), and what the compiler gave each of the probe's kernels
    (needs the built library, so a card's toolkit)."""
    import ctypes

    from wasm_pathtracer_tpu_torch.ops import _build
    out = (ctypes.c_int * 17)()
    sk._raise_on(_build.library().wpt_probe_launch_shape(n_rays, n_rounds, out),
                 "probe_launch_shape")
    keys = ("registers", "shared_bytes", "local_bytes")
    kernels = ("probe", "probe_mixed", "probe_blocks", "probe_blocks_mixed")
    return dict(grid_x=out[0], threads_per_block=out[1], lanes_per_round=out[2],
                blocks_grid_x=out[3], blocks_lanes_per_ray=out[4],
                **{k: dict(zip(keys, out[5 + 3 * i:8 + 3 * i]))
                   for i, k in enumerate(kernels)})
