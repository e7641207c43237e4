"""Plain nearest-hit and shadow queries over a whole scene, and the hit
shading rows: a frozen copy of the plain versions behind the port's
``ops/scene_kernels.py`` (``fused_nearest_reference``,
``fused_occluded_reference``) and of ``ops/trace.py``'s ``hit_info`` and
``winner_t``.

Every ray is tested against every shape with the formulas of
:mod:`portbench.reference.intersect`, in slices of rays and of shapes so
that a 100,000-triangle scene fits the card.  Within a family the first
minimum wins, across families the earliest family (plane, sphere,
triangle, torus, aarect, square) on ties.

Shadow rays follow the port's two rules: the any-hit predicate
``t_non < dist & t_non < t_exc`` of the scene kernels, and for a scene
whose triangles the port clusters (:func:`clustered`) the nearest hit
compared with the light's distance and shape.
"""

from __future__ import annotations

import torch

from portbench.reference import intersect as isx
from portbench.reference import vecmath as vm
from portbench.reference.scene import PrimType, Scene

# candidate pairs a slice of the (R, P) tests may hold
PAIRS_PER_SLICE = 1 << 22
# a finite family of at least this many shapes is clustered by the port
# (``RenderSettings.bvh_min_triangles``)
CLUSTER_MIN_SHAPES = 512

_FAMILY_TESTS = {
    PrimType.PLANE: lambda o, d, r: isx.rays_vs_planes(o, d, r[:, 0:3], r[:, 3:6]),
    PrimType.SPHERE: lambda o, d, r: isx.rays_vs_spheres(o, d, r[:, 0:3], r[:, 3]),
    PrimType.TRIANGLE: lambda o, d, r: isx.rays_vs_triangles(o, d, r[:, 0:3], r[:, 3:6],
                                                             r[:, 6:9]),
    PrimType.TORUS: lambda o, d, r: isx.rays_vs_tori(o, d, r[:, 0:3], r[:, 3], r[:, 4]),
    PrimType.AARECT: lambda o, d, r: isx.rays_vs_aarects(o, d, r[:, 0:3], r[:, 3:6]),
    PrimType.SQUARE: lambda o, d, r: isx.rays_vs_squares(o, d, r[:, 0:3], r[:, 3]),
}


def families(scene: Scene):
    """[(family, shape ids (n,) int64)] of the scene's non-empty families,
    in family order."""
    pt = scene.ptype.long()
    out = []
    for f in PrimType:
        ids = torch.nonzero(pt == int(f)).squeeze(1)
        if ids.numel():
            out.append((f, ids))
    return out


def clustered(scene: Scene) -> bool:
    """Whether the port puts a family of this scene into its cluster
    structure (a finite family of at least ``CLUSTER_MIN_SHAPES``)."""
    return any(f != PrimType.PLANE and ids.numel() >= CLUSTER_MIN_SHAPES
               for f, ids in families(scene))


def _slices(n_rays: int, n_shapes: int):
    rs = max(1, min(n_rays, PAIRS_PER_SLICE // max(n_shapes, 1)))
    ss = max(1, min(n_shapes, PAIRS_PER_SLICE // rs))
    return rs, ss


def nearest(scene: Scene, o, d, fams=None):
    """(t (R,), shape id (R,) int64, hit (R,)): the nearest hit over every
    shape; t is +inf and the id -1 on a miss."""
    fams = families(scene) if fams is None else fams
    R = o.shape[0]
    best_t = torch.full((R,), float("inf"), dtype=o.dtype, device=o.device)
    best_sid = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    n_max = max((ids.numel() for _, ids in fams), default=1)
    rs, _ = _slices(R, min(n_max, PAIRS_PER_SLICE))
    for r0 in range(0, R, rs):
        oo, dd = o[r0:r0 + rs], d[r0:r0 + rs]
        bt, bs = best_t[r0:r0 + rs], best_sid[r0:r0 + rs]
        for f, ids in fams:
            rows = scene.params[ids]
            _, ss = _slices(oo.shape[0], ids.numel())
            for s0 in range(0, ids.numel(), ss):
                t = _FAMILY_TESTS[f](oo, dd, rows[s0:s0 + ss])
                tmin, slot = torch.min(t, dim=1)
                better = tmin < bt
                bt = torch.where(better, tmin, bt)
                bs = torch.where(better, ids[s0:s0 + ss][slot], bs)
        best_t[r0:r0 + rs], best_sid[r0:r0 + rs] = bt, bs
    return best_t, best_sid, torch.isfinite(best_t)


def occluded(scene: Scene, p, point_on_light, light_sid, epsilon: float, fams=None,
             rule: str | None = None):
    """Whether the segment from ``p`` to the light point is blocked; the
    light's own shape does not occlude."""
    to_l = point_on_light - p
    dir_len = vm.length(to_l)
    d = to_l / dir_len[..., None]
    o = p + d * epsilon
    fams = families(scene) if fams is None else fams
    rule = rule or ("nearest" if clustered(scene) else "any_hit")
    if rule == "nearest":
        t, sid, hit = nearest(scene, o, d, fams)
        return hit & (t < dir_len) & (sid != light_sid)
    R = o.shape[0]
    inf = float("inf")
    t_non = torch.full((R,), inf, dtype=o.dtype, device=o.device)
    t_exc = torch.full((R,), inf, dtype=o.dtype, device=o.device)
    n_max = max((ids.numel() for _, ids in fams), default=1)
    rs, _ = _slices(R, min(n_max, PAIRS_PER_SLICE))
    for r0 in range(0, R, rs):
        oo, dd, ls = o[r0:r0 + rs], d[r0:r0 + rs], light_sid[r0:r0 + rs]
        tn, te = t_non[r0:r0 + rs], t_exc[r0:r0 + rs]
        for f, ids in fams:
            rows = scene.params[ids]
            _, ss = _slices(oo.shape[0], ids.numel())
            for s0 in range(0, ids.numel(), ss):
                t = _FAMILY_TESTS[f](oo, dd, rows[s0:s0 + ss])
                exc = ids[s0:s0 + ss][None, :] == ls[:, None]
                tn = torch.minimum(tn, torch.where(exc, inf, t).amin(dim=1))
                te = torch.minimum(te, torch.where(exc, t, inf).amin(dim=1))
        t_non[r0:r0 + rs], t_exc[r0:r0 + rs] = tn, te
    return (t_non < dir_len) & (t_non < t_exc)


# ---------------------------------------------------------------------------
# The winner's distance under autograd (``trace.winner_t``)
# ---------------------------------------------------------------------------

_WINNER_T = {PrimType.PLANE: isx.plane_t, PrimType.SPHERE: isx.sphere_t,
             PrimType.TRIANGLE: isx.triangle_t, PrimType.TORUS: isx.torus_t,
             PrimType.AARECT: isx.aarect_t, PrimType.SQUARE: isx.square_t}


def needs_grad(scene: Scene, *xs) -> bool:
    return torch.is_grad_enabled() and (
        scene.params.requires_grad or any(x.requires_grad for x in xs))


def trace(scene: Scene, o, d, fams=None):
    """(t, sid, hit): :func:`nearest` on detached rays, the winners'
    distances re-evaluated under autograd when the rays or the shape
    table require grad (misses keep +inf)."""
    if not needs_grad(scene, o, d):
        return nearest(scene, o, d, fams)
    with torch.no_grad():
        t, sid, hit = nearest(scene, o.detach(), d.detach(), fams)
    sid_c = torch.clamp(sid, min=0)
    ptype = scene.ptype[sid_c]
    out = t
    for f, _ in (families(scene) if fams is None else fams):
        idx = torch.nonzero((sid >= 0) & (ptype == int(f))).squeeze(1)
        if idx.numel():
            out = out.index_put((idx,), _WINNER_T[f](o[idx], d[idx],
                                                      scene.params[sid_c[idx]]))
    return torch.where(torch.isfinite(out), out, t), sid, hit


# ---------------------------------------------------------------------------
# Hit shading rows (``trace.pack_hit_rows`` / ``hit_info_from_row``)
# ---------------------------------------------------------------------------

def pack_hit_rows(scene: Scene):
    """(N, 24) f32: params 0:9, albedo 9:12, emission 12:15, mat_extra
    15:20, ptype 20, mat_kind 21, pad."""
    f32 = scene.params.dtype
    z = torch.zeros((scene.params.shape[0], 2), dtype=f32, device=scene.device)
    return torch.cat([scene.params, scene.albedo, scene.emission, scene.mat_extra,
                      scene.ptype[:, None].to(f32), scene.mat_kind[:, None].to(f32), z],
                     dim=1)


def hit_info(o, d, t, prow):
    """Normal, entering flag, kind, albedo and emission of each ray's hit
    row ``prow`` (R, 24)."""
    rows = prow[:, 0:9]
    pt = prow[:, 20].to(torch.int32)
    n_pl, e_pl = isx.plane_normal(d, rows[:, 3:6])
    n_sp, e_sp = isx.sphere_normal(o, d, t, rows[:, 0:3], rows[:, 3])
    n_tr, e_tr = isx.triangle_normal(d, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])
    n_to, e_to = isx.torus_normal(o, d, t, rows[:, 0:3], rows[:, 3], rows[:, 4])
    n_aa, e_aa = isx.aarect_normal(o, d, t, rows[:, 0:3], rows[:, 3:6])
    n_sq, e_sq = isx.square_normal(d)
    n = n_pl
    ent = torch.ones_like(e_pl)
    for k, (nk, ek) in enumerate(((n_pl, e_pl), (n_sp, e_sp), (n_tr, e_tr),
                                  (n_to, e_to), (n_aa, e_aa), (n_sq, e_sq))):
        is_k = pt == k
        if k:
            n = torch.where(is_k[..., None], nk, n)
        ent = torch.where(is_k, ek, ent)
    return dict(n=n, is_entering=ent, kind=prow[:, 21].to(torch.int32),
                albedo=prow[:, 9:12], emission=prow[:, 12:15], extra=prow[:, 15:20])
