"""The yardstick of the kernels' rooflines, frozen: the operations and
bytes a call of K1-K4 needs, counted from the call's own inputs, and the
H100's peaks.  A copy of ``chip_smoke.py``'s ``FLOPS``, ``bound``,
``torus_pairs``, ``scene_flops``, ``occluded_work``, ``probe_flops`` and
``probe_bounds`` (and the bytes its phases charge K1, K2 and K3), kept
here so that a change to a kernel or to that script cannot change how
the benchmark counts.  The per-ray formulas are the reference's
(:mod:`portbench.reference.intersect`).

A call's bound is the larger of its operations over the float32 peak
outside the tensor cores and its bytes over the HBM bandwidth.
"""

from __future__ import annotations

import torch

from portbench.reference import intersect as isx

PEAK_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM HBM3
# Operations of one ray-primitive test, by family (0 plane, 1 sphere, 2
# triangle, 4 aarect, 5 square): one per add, multiply, compare, min, max,
# divide or square root.  What depends on one side only is charged once
# for that side: a triangle's set-up ("tri_setup") once per triangle per
# call, the ray's three direction reciprocals ("recip") once per ray that
# meets a slab test.  "box" is a torus' bounding slab, "sdf" one torus
# march step, "newton" one polish step.
FLOPS = {0: 19, 1: 30, 2: 42, 4: 24, 5: 15, "tri_setup": 88, "recip": 3,
         "box": 24, "sdf": 22, "newton": 45}
SLOT_BITS = 20
# the order in which K2 tests the families
K2_ORDER = (0, 5, 4, 1, 2, 3)


def bound(flops, n_bytes):
    """(bound_ms, bound_by) of a call needing ``flops`` operations and
    ``n_bytes`` bytes of traffic."""
    t_ops, t_bytes = flops / PEAK_FLOPS, n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _family_distances(fam: int, rows, o, d):
    if fam == 0:
        return isx.rays_vs_planes(o, d, rows[:, 0:3], rows[:, 3:6])
    if fam == 1:
        return isx.rays_vs_spheres(o, d, rows[:, 0:3], rows[:, 3])
    if fam == 2:
        return isx.rays_vs_triangles(o, d, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])
    if fam == 3:
        return isx.rays_vs_tori(o, d, rows[:, 0:3], rows[:, 3], rows[:, 4])
    if fam == 4:
        return isx.rays_vs_aarects(o, d, rows[:, 0:3], rows[:, 3:6])
    return isx.rays_vs_squares(o, d, rows[:, 0:3], rows[:, 3])


def torus_pairs(rows, o, d):
    """Per (ray, torus) pair: the box entry t_lo (+inf where the ray
    misses the box) and the operations of the march and Newton steps
    taken until they reach their fixed point (0 where the box is
    missed)."""
    lo = o[:, None, :] - rows[None, :, 0:3]
    ld = d[:, None, :]
    big_r, small_r = rows[None, :, 3], rows[None, :, 4]
    ext = torch.stack([big_r + small_r, small_r, big_r + small_r], dim=-1) * torch.ones_like(lo)
    inv_d = 1.0 / torch.where(ld.abs() < 1e-30, 1e-30, ld)
    t1, t2 = (-ext - lo) * inv_d, (ext - lo) * inv_d
    t_in = torch.minimum(t1, t2).amax(-1)
    t_out = torch.maximum(t1, t2).amin(-1)
    t_lo = t_in.clamp(min=1e-4)
    live = (t_in < t_out) & (t_out > 0)

    def sdf(t):
        return isx._torus_sdf(lo + ld * t[..., None], big_r, small_r)

    t = t_lo
    sign0 = torch.sign(sdf(t))
    sign0 = torch.where(sign0 == 0, 1.0, sign0)
    dist = sign0 * sdf(t)
    relaxed = torch.ones_like(live)
    marching = live.clone()
    n_sdf = torch.zeros_like(t_lo, dtype=torch.int64)
    for _ in range(24):
        step = dist * torch.where(relaxed, 1.6, 1.0)
        can = (dist > 1e-4) & (t < t_out)
        t2_ = t + torch.where(can, step, 0.0)
        d2 = sign0 * sdf(t2_)
        n_sdf += marching
        accept = (step <= 1e-4) | (d2 + dist >= step)
        marching &= can | (d2 != dist)
        t = torch.where(accept, t2_, t)
        dist = torch.where(accept, d2, dist)
        relaxed = accept
    n_newton = 4 * (live & (dist.abs() > 1e-6))
    ops = n_sdf * FLOPS["sdf"] + n_newton * FLOPS["newton"]
    return torch.where(live, t_lo, torch.inf), ops


def family_candidates(tables, o, d):
    return {f: _family_distances(f, tables.family(f), o, d)
            for f in range(6) if tables.counts[f]}


def needed_marches(tables, o, d):
    """(R, n_torus) bool of the tori K1 marches (box entry not beyond the
    ray's best hit among the other families) and each march's
    operations."""
    best = torch.full((o.shape[0],), torch.inf, device=o.device)
    for f, t in family_candidates(tables, o, d).items():
        if f != 3:
            best = torch.minimum(best, t.amin(1))
    t_lo, march = torus_pairs(tables.family(3), o, d)
    return t_lo <= best[:, None], march


def scene_flops(tables, o, d):
    """Operations the nearest hit of these rays over the whole scene
    needs (K1, K3's dense half)."""
    R, n = o.shape[0], tables.counts
    total = sum(R * n[f] * FLOPS[f] for f in (0, 1, 2, 4, 5)) + n[2] * FLOPS["tri_setup"]
    if n[3] + n[4]:
        total += R * FLOPS["recip"]
    if n[3]:
        go, march = needed_marches(tables, o, d)
        total += R * n[3] * FLOPS["box"] + int(march[go].sum())
    return total


def _excl_codes(light_sid, code_of):
    return torch.where(light_sid >= 0, code_of[torch.clamp(light_sid, min=0)],
                       -1).to(torch.int32)


def occluded_work(tables, code_of, o, d, dist, light_sid):
    """What the any-hit query of these shadow rays needs, in K2's order,
    up to and including the candidate that decides the verdict.  Returns
    (operations, per-ray primitive tests (R,), per-ray marches (R,))."""
    R, n = o.shape[0], tables.counts
    excl = _excl_codes(light_sid, code_of)
    cand = family_candidates(tables, o, d)
    costs, is_exc, dists = [], [], []
    for f in K2_ORDER:
        if f not in cand:
            continue
        t = cand[f]
        code = (f << SLOT_BITS) + torch.arange(n[f], device=o.device)
        exc = code[None, :] == excl[:, None]
        if f == 3:
            t_lo, march = torus_pairs(tables.family(3), o, d)
            costs.append((FLOPS["box"], t_lo, march))
        else:
            costs.append((FLOPS[f], None, None))
        is_exc.append(exc)
        dists.append(t)
    t_all, exc_all = torch.cat(dists, 1), torch.cat(is_exc, 1)
    t_exc = torch.where(exc_all, t_all, torch.inf).amin(1)
    limit = torch.minimum(dist, t_exc)
    pair, marches = [], []
    for (c, t_lo, march), exc in zip(costs, is_exc):
        if t_lo is None:
            pair.append(torch.full(exc.shape, float(c), device=o.device))
            marches.append(torch.zeros(exc.shape, device=o.device))
        else:
            go = (t_lo < limit[:, None]) | (exc & torch.isfinite(t_lo))
            pair.append(c + torch.where(go, march, 0).double())
            marches.append(go.double())
    pair, marches = torch.cat(pair, 1), torch.cat(marches, 1)
    first = torch.where(exc_all, torch.inf, t_all) < limit[:, None]
    upto = (torch.cumsum(first.int(), 1) - first.int()) == 0
    done = upto | exc_all
    ops = (pair * done).sum() + n[2] * FLOPS["tri_setup"] + (R * FLOPS["recip"] if n[3] + n[4] else 0)
    return int(ops), done.sum(1), (marches * done).sum(1)


def probe_flops(cs, cidx):
    """Operations one probe round needs: each ray's cluster's real slots
    at their family's cost, and the set-up of every triangle of the
    clusters probed, once."""
    c = cidx.long().clamp(0, cs.num_clusters - 1)
    bt = cs.btype[c]
    total = sum(int((bt == f).sum()) * FLOPS.get(f, FLOPS["box"]) for f in cs.families)
    probed = cs.btype[torch.unique(c)]
    return total + int((probed == 2).sum()) * FLOPS["tri_setup"]


def probe_bounds(cs, o, c1, c2=None):
    """(bound_ms, bound_by) of K4 (two rounds, ``c2`` given), K5 and K7."""
    B, table = o.shape[0], 4 * cs.table.numel()
    probe = probe_flops(cs, c1)
    bounds = {"probe_min": bound(probe, B * 24 + B * 4 + table + B * 8),
              "probe_blocks": bound(probe, B * 24 + B * 4 + table + B * cs.group * 4)}
    if c2 is not None:
        bounds["probe_pair"] = bound(probe + probe_flops(cs, c2),
                                     B * 24 + B * 8 + table + B * 16)
    return bounds


# -- one call's bound, from the arguments the wrapper was called with -------

def k1_bound(tables, o, d, sid_of_slot):
    """``scene_kernels.fused_nearest(tables, o, d, sid_of_slot)``."""
    R = o.shape[0]
    return bound(scene_flops(tables, o, d),
                 4 * tables.flat.numel() + 8 * sum(tables.counts) + R * (24 + 12))


def k2_bound(tables, o, d, dist, light_sid, code_of):
    """``scene_kernels.fused_occluded(tables, o, d, dist, light_sid, code_of)``."""
    R = o.shape[0]
    ops = occluded_work(tables, code_of, o, d, dist, light_sid)[0]
    return bound(ops, 4 * tables.flat.numel() + 4 * code_of.numel() + R * (24 + 4 + 8 + 1))


def k3_bound(cs, prep, o, d, skip_e, skip_c):
    """``probe_kernels.select_scan(cs, prep, o, d, skip_e, skip_c)``."""
    C, B = cs.num_clusters, o.shape[0]
    slab = B * (C * FLOPS["box"] + FLOPS["recip"])
    return bound(slab + scene_flops(prep.tables, o, d),
                 B * 24 + B * 8 + 4 * 6 * C + 4 * prep.tables.flat.numel() + B * 28)


def k4_bound(cs, o, d, c1, c2):
    """``probe_kernels.probe_pair(cs, o, d, c1, c2)``."""
    return probe_bounds(cs, o, c1, c2)["probe_pair"]
