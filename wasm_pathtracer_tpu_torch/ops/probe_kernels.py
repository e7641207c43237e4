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
gathered per-ray block test of ``ops.cluster``.  A wrapper takes the
plain version for tensors on the CPU; for CUDA tensors it launches the
kernel, and raises if the kernel does not build or launch.  Each wrapper
counts its launches in ``<wrapper>.launches``.

Cluster ids are int32 in [0, C); where an entry is +inf (no unvisited
cluster left) its id is meaningless.  Probe rounds return (t, shape id),
t = +inf and id = -1 on a miss.
"""

from __future__ import annotations

import torch

from wasm_pathtracer_tpu_torch.ops import cluster as cl
from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk

# the largest dense remainder K3 folds into the select (the TPU kernel's
# limit; larger remainders go through K6 and the scene kernels)
MAX_DENSE = 64


def dense_scan_ok(prep) -> bool:
    """Whether the prep's dense remainder is small enough for K3."""
    return 0 < sum(prep.tables.counts) <= MAX_DENSE


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def select_blocks_reference(cs: cl.ClusterSet, o, d, skip_e, skip_c):
    """Plain PyTorch version of :func:`select_blocks`."""
    C = cs.num_clusters
    ent = cl._rays_vs_boxes(o, d, cs.lo, cs.hi)                # (R, C)
    cid = torch.arange(C, device=o.device)
    se, sc = skip_e[:, None], skip_c[:, None]
    ent = torch.where((ent > se) | ((ent == se) & (cid > sc)), ent, torch.inf)

    def lexmin(ent):
        # among minimal entries, the lowest id
        e = ent.amin(dim=1)
        c = torch.where(ent == e[:, None], cid, C).amin(dim=1).clamp(max=C - 1)
        rest = torch.where((ent > e[:, None]) |
                           ((ent == e[:, None]) & (cid > c[:, None])),
                           ent, torch.inf)
        return e, c.to(torch.int32), rest

    e_cur, c_cur, ent1 = lexmin(ent)
    e_b, c_b, ent2 = lexmin(ent1)
    return e_cur, c_cur, e_b, c_b, ent2.amin(dim=1)


def select_scan_reference(cs: cl.ClusterSet, prep, o, d, skip_e, skip_c):
    """Plain PyTorch version of :func:`select_scan`."""
    t, fam, slot = sk.fused_nearest_reference(prep.tables, o, d)
    sid = prep.sid_of_slot[prep.fam_offset[torch.clamp(fam, min=0).long()] + slot]
    return select_blocks_reference(cs, o, d, skip_e, skip_c) + \
        (t, torch.where(fam >= 0, sid, -1).to(torch.int32))


def probe_blocks_reference(cs: cl.ClusterSet, o, d, cidx):
    """Plain PyTorch version of :func:`probe_blocks`."""
    c = torch.clamp(cidx.long(), 0, cs.num_clusters - 1)
    return cl._block_test(o, d, cs.blocks[c], cs.btype[c], cs.families)


def probe_min_reference(cs: cl.ClusterSet, o, d, cidx):
    """Plain PyTorch version of :func:`probe_min`."""
    c = torch.clamp(cidx.long(), 0, cs.num_clusters - 1)
    t = probe_blocks_reference(cs, o, d, cidx)           # (R, G)
    tmin, j = torch.min(t, dim=1)                        # first minimum
    sid = cs.slot_to_sid.view(cs.num_clusters, cs.group)[c, j]
    return tmin, torch.where(torch.isfinite(tmin), sid, -1).to(torch.int32)


def probe_pair_reference(cs: cl.ClusterSet, o, d, c1, c2):
    """Plain PyTorch version of :func:`probe_pair`."""
    return probe_min_reference(cs, o, d, c1) + probe_min_reference(cs, o, d, c2)


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
    dev, R = _check_rays(o, d)
    sk._check("cidx", cidx, cidx_shape + (R,), torch.int32, dev)
    C, G = cs.num_clusters, cs.group
    sk._check("cs.table", cs.table, (C, cl.TABLE_ROWS, G), torch.float32, dev)
    return dev, R, C, G


def _probe(cs: cl.ClusterSet, o, d, cidx, name):
    from wasm_pathtracer_tpu_torch.ops import _build
    n_rounds = cidx.shape[0]
    dev, R, C, G = _check_probe(cs, o, d, cidx, (n_rounds,))
    t = torch.empty((n_rounds, R), dtype=torch.float32, device=dev)
    sid = torch.empty((n_rounds, R), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.wpt_probe(cs.table.data_ptr(), C, G, o.data_ptr(), d.data_ptr(),
                           cidx.data_ptr(), n_rounds, R, t.data_ptr(), sid.data_ptr(),
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
    dev, R, C, G = _check_probe(cs, o, d, cidx, ())
    dist = torch.empty((R, G), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.wpt_probe_blocks(cs.table.data_ptr(), C, G, o.data_ptr(),
                                  d.data_ptr(), cidx.data_ptr(), R, dist.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream)
    sk._raise_on(rc, "probe_blocks")
    probe_blocks.launches += 1
    return dist


probe_blocks.launches = 0
