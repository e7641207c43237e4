"""Iterative 4-wide BVH traversal (``wasm_pathtracer_tpu.ops.traverse``).

Plain PyTorch: the JAX package has no kernel here either (a per-ray
divergent walk needs per-lane gathers, which it leaves to the compiler).
The JAX version is a per-ray ``while_loop`` under ``vmap``; here it is
one batched loop over all rays with a per-ray short stack and masked
updates, until no ray has a node left.  Each step pops one node per ray,
slab-tests its four child boxes at once, intersects the triangles of the
leaf children inline, and pushes the surviving internal children far to
near so that the nearest pops first.  A child is skipped when its entry
distance is not below the ray's best hit.  Visits are counted per ray.

The loop condition is read on the host every :data:`POLL_EVERY` steps;
a step with no live ray changes nothing.
"""

from __future__ import annotations

import torch

from wasm_pathtracer_tpu_torch.ops import bvh as bvhmod
from wasm_pathtracer_tpu_torch.ops import intersect as isx
from wasm_pathtracer_tpu_torch.utils import vecmath as vm

STACK_DEPTH = 48
POLL_EVERY = 4


def _aabb4_hit(o, inv_d, bounds, t_max):
    """Entry distances of (R, 3) rays against their (R, 4, 6) child
    boxes: 0 if the origin is inside, +inf on a miss or at or beyond
    ``t_max`` (R,)."""
    t1 = (bounds[..., 0:3] - o[:, None, :]) * inv_d[:, None, :]
    t2 = (bounds[..., 3:6] - o[:, None, :]) * inv_d[:, None, :]
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = (tmax >= tmin) & (tmax > 0.0)
    entry = torch.clamp(tmin, min=0.0)
    return torch.where(hit & (entry < t_max[:, None]), entry, torch.inf)


def _tri_rows_test(o, d, rows):
    """(R, K) distances of (R, 3) rays to their (R, K, 9) triangle rows,
    +inf on a miss.  Unlike the dense sweep this rejects ``n.d == 0``."""
    v0, v1, v2 = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
    o, d = o[:, None, :], d[:, None, :]
    n = vm.cross(v1 - v0, v2 - v0)
    n_dot_d = vm.dot(n, d)
    t = (vm.dot(n, v0) - vm.dot(n, o)) / n_dot_d
    nn = n * torch.rsqrt(torch.clamp(vm.dot(n, n), min=1e-30))[..., None]
    p = o + d * t[..., None]
    inside = torch.ones(t.shape, dtype=torch.bool, device=t.device)
    for a, b in ((v0, v1), (v1, v2), (v2, v0)):
        inside &= vm.dot(nn, vm.cross(b - a, p - a)) + 0.1 * isx.EPSILON >= 0.0
    return torch.where((n_dot_d != 0.0) & (t > 0.0) & inside, t, torch.inf)


def trace_bvh4(bounds, children, prim_index, tri_rows, o, d, t_init):
    """Nearest triangle hit through the BVH for a ray batch.

    Args:
      bounds: (M, 4, 6) child AABBs; children: (M, 4) int64 slots
        (>= 0 internal, < 0 leaf-encoded, EMPTY for none).
      prim_index: (T,) leaf order -> shape id.
      tri_rows: (T, 9) leaf-ordered triangle vertices.
      t_init: (R,) current best distances (prunes the traversal).

    Returns (t, shape_id, visits): the best of ``t_init`` and the hits
    found, the shape id of a hit found here (-1 otherwise) and the nodes
    visited per ray (int64).
    """
    R = o.shape[0]
    dev = o.device
    i64 = torch.int64
    T = tri_rows.shape[0]
    inv_d = 1.0 / d
    rows_idx = torch.arange(R, device=dev)
    # column STACK_DEPTH collects the pushes that are masked off
    stack = torch.zeros((R, STACK_DEPTH + 1), dtype=i64, device=dev)
    sp = torch.ones((R,), dtype=i64, device=dev)
    t_best = t_init
    slot_best = torch.full((R,), -1, dtype=i64, device=dev)
    visits = torch.zeros((R,), dtype=i64, device=dev)
    k4 = torch.arange(4, dtype=i64, device=dev)
    kleaf = torch.arange(bvhmod.LEAF_MAX, dtype=i64, device=dev)

    step = 0
    while True:
        if step % POLL_EVERY == 0 and not bool((sp > 0).any()):
            break
        step += 1
        live = sp > 0
        sp = sp - live.to(i64)
        node = stack[rows_idx, sp]
        visits = visits + live

        nb = bounds[node]                                  # (R, 4, 6)
        ch = children[node]                                # (R, 4)
        dist = _aabb4_hit(o, inv_d, nb, t_best)
        dist = torch.where(ch == bvhmod.EMPTY, torch.inf, dist)
        reach = torch.isfinite(dist) & live[:, None]

        # --- leaves: all 4 x LEAF_MAX candidate triangles in one batch,
        # folded as a first minimum in (child, position) order, which is
        # what testing them one after another with a strict < keeps
        is_leaf = (ch < 0) & (ch != bvhmod.EMPTY) & reach
        first, count = bvhmod.decode_leaf(ch)
        count = torch.where(is_leaf, count, 0)
        first = torch.where(is_leaf, first, 0)
        slot = first[..., None] + torch.minimum(kleaf, (count - 1)[..., None])
        slot = torch.clamp(slot, 0, max(T - 1, 0)).reshape(R, -1)   # (R, 16)
        valid = (kleaf < count[..., None]).reshape(R, -1)
        t = _tri_rows_test(o, d, tri_rows[slot])
        t = torch.where(valid, t, torch.inf)
        tloc, j = torch.min(t, dim=1)
        better = tloc < t_best
        t_best = torch.where(better, tloc, t_best)
        slot_best = torch.where(better, slot[rows_idx, j], slot_best)

        # --- internals: push far to near so that the nearest pops first
        # (a stable sort, so equal distances keep child order)
        is_int = (ch >= 0) & reach
        d_int = torch.where(is_int, dist, -torch.inf)
        order = torch.argsort(-d_int, dim=1, stable=True)  # far first
        push = torch.gather(is_int, 1, order)              # a prefix of each row
        pos = torch.where(push, sp[:, None] + k4, STACK_DEPTH)
        stack.scatter_(1, torch.clamp(pos, max=STACK_DEPTH), torch.gather(ch, 1, order))
        sp = sp + is_int.sum(dim=1)

    sid = prim_index[torch.clamp(slot_best, min=0)] if T else slot_best
    return t_best, torch.where(slot_best >= 0, sid, -1), visits
