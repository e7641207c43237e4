"""BVH leaf order and the cluster structure (``wasm_pathtracer_tpu.ops.bvh``).

The cluster structure (``ops.cluster``) groups a scene's finite
primitives into fixed-size clusters along the leaf order of a
binned-SAH BVH, so that each cluster is spatially tight.  The BVH comes
from the native C++ builder (``ops.bvh_native``) when it builds and
loads, and from :func:`build_bvh2`, its NumPy twin, otherwise; both
give the leaf order the JAX package's builders give.

The 4-wide BVH walk (``attach_bvh``, ``collapse_bvh4``, ``ops.traverse``)
is not ported: no render path of the port uses it.
"""

from __future__ import annotations

import dataclasses
import subprocess

import numpy as np

from wasm_pathtracer_tpu_torch.models.scene import PrimType, SceneData
from wasm_pathtracer_tpu_torch.ops import cluster as cl
from wasm_pathtracer_tpu_torch.ops import trace

LEAF_MAX = 4          # max primitives per leaf


@dataclasses.dataclass
class BVH2Node:
    lo: np.ndarray
    hi: np.ndarray
    left: int = -1      # child index (internal) ...
    first: int = -1     # ... or primitive range (leaf)
    count: int = 0


def build_bvh2(lo: np.ndarray, hi: np.ndarray, num_bins: int = 16,
               leaf_max: int = LEAF_MAX):
    """Binned-SAH BVH2 over (N, 3) primitive AABBs: longest-axis
    uniform binning of centroids, an O(bins) sweep minimising
    ``SA_L * n_L + SA_R * n_R``, a split accepted only when cheaper than
    the parent as a leaf unless the node exceeds ``leaf_max``, and a
    median split where the centroids are degenerate.

    Returns (nodes: list[BVH2Node], order: (N,) int64 permutation of the
    input primitive ids in leaf-contiguous order).
    """
    n = lo.shape[0]
    cent = (lo + hi) * 0.5
    nodes: list[BVH2Node] = []

    def node_of(ids):
        return BVH2Node(lo=lo[ids].min(0), hi=hi[ids].max(0))

    def sa(l, h):
        d = np.maximum(h - l, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    # iterative top-down with an explicit stack; children at adjacent slots
    root_ids = np.arange(n)
    nodes.append(node_of(root_ids))
    out_order = []
    stack = [(0, root_ids)]
    while stack:
        ni, ids = stack.pop()
        node = nodes[ni]
        m = len(ids)
        if m <= leaf_max:
            node.first = len(out_order)
            node.count = m
            out_order.extend(ids.tolist())
            continue

        c = cent[ids]
        cmin, cmax = c.min(0), c.max(0)
        axis = int(np.argmax(cmax - cmin))
        ext = cmax[axis] - cmin[axis]

        split_done = False
        if ext > 1e-12:
            b = np.minimum(((c[:, axis] - cmin[axis]) / ext * num_bins)
                           .astype(np.int64), num_bins - 1)
            counts = np.bincount(b, minlength=num_bins)
            bin_lo = np.full((num_bins, 3), np.inf)
            bin_hi = np.full((num_bins, 3), -np.inf)
            for k in range(num_bins):
                sel = b == k
                if sel.any():
                    bin_lo[k] = lo[ids[sel]].min(0)
                    bin_hi[k] = hi[ids[sel]].max(0)
            lft_lo = np.minimum.accumulate(bin_lo, 0)
            lft_hi = np.maximum.accumulate(bin_hi, 0)
            rgt_lo = np.minimum.accumulate(bin_lo[::-1], 0)[::-1]
            rgt_hi = np.maximum.accumulate(bin_hi[::-1], 0)[::-1]
            nl = np.cumsum(counts)
            best_cost, best_k = np.inf, -1
            for k in range(num_bins - 1):
                n_l, n_r = nl[k], m - nl[k]
                if n_l == 0 or n_r == 0:
                    continue
                cost = (sa(lft_lo[k], lft_hi[k]) * n_l
                        + sa(rgt_lo[k + 1], rgt_hi[k + 1]) * n_r)
                if cost < best_cost:
                    best_cost, best_k = cost, k
            leaf_cost = sa(node.lo, node.hi) * m
            if best_k >= 0 and (best_cost < leaf_cost or m > leaf_max):
                sel = b <= best_k
                ids_l, ids_r = ids[sel], ids[~sel]
                split_done = len(ids_l) > 0 and len(ids_r) > 0

        if not split_done:
            perm = np.argsort(c[:, axis], kind="stable")
            half = m // 2
            ids_l, ids_r = ids[perm[:half]], ids[perm[half:]]

        li = len(nodes)
        node.left = li
        nodes.append(node_of(ids_l))
        nodes.append(node_of(ids_r))
        stack.append((li + 1, ids_r))
        stack.append((li, ids_l))

    return nodes, np.array(out_order, np.int64)


def leaf_order(lo: np.ndarray, hi: np.ndarray, num_bins: int = 16) -> np.ndarray:
    """Leaf-contiguous primitive order of the BVH over (N, 3) AABBs:
    the native builder's, or :func:`build_bvh2`'s when it cannot be
    built or loaded."""
    from wasm_pathtracer_tpu_torch.ops import bvh_native
    try:
        return bvh_native.build(lo, hi, num_bins)[2]
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return build_bvh2(lo, hi, num_bins)[1]


_FAM_IDX = {int(PrimType.SPHERE): "idx_sphere",
            int(PrimType.TRIANGLE): "idx_triangle",
            int(PrimType.TORUS): "idx_torus",
            int(PrimType.AARECT): "idx_aarect",
            int(PrimType.SQUARE): "idx_square"}


def attach_clusters(prep: trace.ScenePrep, scene: SceneData, num_bins: int = 16,
                    group: int | None = None, min_count: int = 512,
                    families: list | None = None,
                    exclude_lights: bool = False) -> trace.ScenePrep:
    """Build the cluster structure over the scene's finite primitives
    and return the prep with it attached.

    Each finite family joins the structure when it has at least
    ``min_count`` shapes (or when listed in ``families``); the others
    stay in the dense remainder that the scene kernels trace.  Clustered
    families leave the prep's dense index sets, except, with
    ``exclude_lights``, their emissive shapes.  Returns ``prep``
    unchanged when nothing is clustered.
    """
    sets = {a: getattr(prep, a).cpu().numpy() for a in trace.INDEX_FIELDS}
    if families is None:
        families = [f for f, a in _FAM_IDX.items() if sets[a].shape[0] >= min_count]
    families = [int(f) for f in families if sets[_FAM_IDX[int(f)]].shape[0] > 0]
    if not families:
        return prep

    ids = np.concatenate([sets[_FAM_IDX[f]] for f in sorted(families)])
    light_sids = scene.light_shape.cpu().numpy()
    kept_dense = {}
    if exclude_lights and light_sids.size:
        is_light = np.isin(ids, light_sids)
        for f in families:
            fam_ids = sets[_FAM_IDX[f]]
            kept_dense[_FAM_IDX[f]] = fam_ids[np.isin(fam_ids, light_sids)]
        ids = ids[~is_light]
        if ids.size == 0:
            return prep
    params = scene.params.cpu().numpy()
    ptypes = scene.ptype.cpu().numpy()[ids]
    rows = params[ids][:, :9].astype(np.float32)
    lo, hi = cl.prim_aabbs(rows, ptypes)
    order = leaf_order(lo, hi, num_bins)
    cs = cl.build_clusters(rows[order], ptypes[order], ids[order],
                           group or cl.CLUSTER_SIZE, device=scene.device)
    for f in families:
        sets[_FAM_IDX[f]] = kept_dense.get(_FAM_IDX[f], np.zeros(0, np.int64))
    return trace.prepare_from_sets(scene, [sets[a] for a in trace.INDEX_FIELDS],
                                   cluster=cs)

