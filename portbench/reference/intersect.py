"""Vectorized ray-primitive intersection: a frozen copy of the port's
``ops/intersect.py``.

Each primitive family is a dense rays x primitives computation: (R,)
rays against (P,) primitives give one (R, P) tensor of distances with
``inf`` marking misses.  Every early return of a per-primitive test is a
``torch.where`` mask.  These are the plain versions behind the scene
kernels' reference paths (``ops.scene_kernels``), and the normal and
light-sampling math of the shading step.

Dot products are broadcast multiply + sum, never ``matmul``/``einsum``.
"""

from __future__ import annotations

import torch

from portbench.reference import vecmath as vm

INF = float("inf")
# Reference EPSILON; triangles use 0.1x slack.
EPSILON = 2e-4


def _posmask(t, extra=True):
    """Keep t where (t > 0) & extra, else +inf."""
    return torch.where((t > 0.0) & extra, t, INF)


def _nonzero(x, eps=1e-30):
    """Clamp |x| away from 0 (to +eps) so masked lanes never divide by 0."""
    return torch.where(torch.abs(x) < eps, eps, x)


def _dot_rp(a, b):
    """(R,3) x (P,3) -> (R,P) dot products, as broadcast multiply + sum."""
    return torch.sum(a[:, None, :] * b[None, :, :], dim=-1)


def rays_vs_planes(o, d, loc, n):
    """(R,3),(R,3) x (P,3),(P,3) -> (R,P) distances."""
    n_dot_d = _dot_rp(d, n)
    o_dist = torch.sum(n * loc, dim=-1)               # n . location
    n_dot_o = _dot_rp(o, n)
    t = (o_dist[None, :] - n_dot_o) / _nonzero(n_dot_d)
    return _posmask(t, n_dot_d != 0.0)


def rays_vs_spheres(o, d, center, radius):
    """(R,3),(R,3) x (S,3),(S,) -> (R,S)."""
    oc = o[:, None, :] - center[None, :, :]           # (R,S,3)
    b = 2.0 * torch.sum(oc * d[:, None, :], dim=-1)
    c = torch.sum(oc * oc, dim=-1) - (radius * radius)[None, :]
    disc = b * b - 4.0 * c                             # a == 1 (unit dir)
    sq = vm.sqrt(torch.where(disc > 0.0, disc, 1.0))
    sq = torch.where(disc > 0.0, sq, 0.0)
    t0 = (-b + sq) * 0.5
    t1 = (-b - sq) * 0.5
    t_near = torch.minimum(t0, t1)
    t_far = torch.maximum(t0, t1)
    t = torch.where(t_near > 0.0, t_near, t_far)
    return torch.where((disc >= 0.0) & (t > 0.0), t, INF)


def rays_vs_triangles(o, d, v0, v1, v2):
    """(R,3),(R,3) x (T,3)x3 -> (R,T): plane intersection, then three
    half-space tests with +0.1*EPSILON slack against T-junction gaps."""
    n = vm.cross(v1 - v0, v2 - v0)                     # (T,3), unnormalized
    n_dot_d = _dot_rp(d, n)
    orig_dis = torch.sum(n * v0, dim=-1)
    t = (orig_dis[None, :] - _dot_rp(o, n)) / _nonzero(n_dot_d)

    nn = n / _nonzero(torch.linalg.norm(n, dim=-1, keepdim=True))  # (T,3)
    p = o[:, None, :] + d[:, None, :] * t[..., None]     # (R,T,3)

    def left_of(a, bb):
        edge = bb - a                                   # (T,3)
        v0p = p - a[None, :, :]                         # (R,T,3)
        c = vm.cross(edge[None], v0p)
        return torch.sum(c * nn[None, :, :], dim=-1) + 0.1 * EPSILON >= 0.0

    inside = left_of(v0, v1) & left_of(v1, v2) & left_of(v2, v0)
    return _posmask(t, (n_dot_d != 0.0) & inside)


def rays_vs_aarects(o, d, bmin, bmax):
    """(R,3),(R,3) x (A,3),(A,3) -> (R,A).  Slab test; tmin when outside,
    tmax when inside the box."""
    inv_d = 1.0 / _nonzero(d)                          # (R,3)
    t1 = (bmin[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    t2 = (bmax[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)   # (R,A)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    t = torch.where(tmin > 0.0, tmin, tmax)
    return torch.where((tmin < tmax) & (t > 0.0), t, INF)


def rays_vs_squares(o, d, center, size):
    """(R,3),(R,3) x (Q,3),(Q,) -> (R,Q).  Axis-aligned y-plane quad."""
    n_dot_d = d[:, 1:2]                                # (R,1)
    t = (center[None, :, 1] - o[:, 1:2]) / _nonzero(n_dot_d)  # (R,Q)
    px = o[:, 0:1] + d[:, 0:1] * t
    pz = o[:, 2:3] + d[:, 2:3] * t
    dx = torch.abs(px - center[None, :, 0])
    dz = torch.abs(pz - center[None, :, 2])
    inside = (2.0 * dx < size[None, :]) & (2.0 * dz < size[None, :])
    return _posmask(t, (n_dot_d != 0.0) & inside)


# ---------------------------------------------------------------------------
# One shape per ray: the distance along each ray to its own shape, (R, 3)
# rays against (R, 9) shape rows.  The same operations as the (R, P)
# tests above, so a ray's value is theirs bit for bit; the masks that
# turn a miss into +inf are left out, since the caller knows the ray
# hits.  These are what gradients flow through once the kernels have
# chosen each ray's shape.
# ---------------------------------------------------------------------------

def plane_t(o, d, rows):
    n = rows[:, 3:6]
    n_dot_d = torch.sum(d * n, dim=-1)
    return (torch.sum(n * rows[:, 0:3], dim=-1) - torch.sum(o * n, dim=-1)) \
        / _nonzero(n_dot_d)


def sphere_t(o, d, rows):
    oc = o - rows[:, 0:3]
    b = 2.0 * torch.sum(oc * d, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - rows[:, 3] * rows[:, 3]
    disc = b * b - 4.0 * c
    sq = vm.sqrt(torch.where(disc > 0.0, disc, 1.0))
    sq = torch.where(disc > 0.0, sq, 0.0)
    t0 = (-b + sq) * 0.5
    t1 = (-b - sq) * 0.5
    t_near = torch.minimum(t0, t1)
    return torch.where(t_near > 0.0, t_near, torch.maximum(t0, t1))


def triangle_t(o, d, rows):
    v0 = rows[:, 0:3]
    n = vm.cross(rows[:, 3:6] - v0, rows[:, 6:9] - v0)
    n_dot_d = torch.sum(d * n, dim=-1)
    return (torch.sum(n * v0, dim=-1) - torch.sum(o * n, dim=-1)) / _nonzero(n_dot_d)


def torus_t(o, d, rows):
    return tori_march(o - rows[:, 0:3], d, rows[:, 3], rows[:, 4])


def aarect_t(o, d, rows):
    inv_d = 1.0 / _nonzero(d)
    t1 = (rows[:, 0:3] - o) * inv_d
    t2 = (rows[:, 3:6] - o) * inv_d
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    return torch.where(tmin > 0.0, tmin, tmax)


def square_t(o, d, rows):
    return (rows[:, 1] - o[:, 1]) / _nonzero(d[:, 1])


# ---------------------------------------------------------------------------
# Tori: over-relaxed sphere tracing of the exact torus SDF inside its
# AABB, then Newton polish.  The constants are the JAX package's.
# ---------------------------------------------------------------------------

_TORUS_STEPS = 24     # over-relaxed march iterations
_TORUS_NEWTON = 4     # Newton polish iterations
_TORUS_OMEGA = 1.6    # over-relaxation factor
_TORUS_TOL = 1e-4


def _torus_sdf(p, big_r, small_r):
    """Signed distance to a flat-lying torus centred at the origin."""
    qx = vm.sqrt(torch.clamp(p[..., 0] ** 2 + p[..., 2] ** 2, min=1e-24)) - big_r
    return vm.sqrt(torch.clamp(qx * qx + p[..., 1] ** 2, min=1e-24)) - small_r


def rays_vs_tori(o, d, center, big_r, small_r):
    """(R,3),(R,3) x (T,3),(T,),(T,) -> (R,T)."""
    lo = o[:, None, :] - center[None, :, :]
    ld = d[:, None, :]
    return tori_march(lo, ld, big_r[None], small_r[None])


def tori_march(lo, ld, R_, r_):
    """Broadcast-generic torus intersection: ``lo`` (..., 3) torus-local
    origins, ``ld`` broadcastable unit directions, ``R_``/``r_``
    broadcastable radii.  Returns (...) distances, inf on miss.

    Differentiable by the implicit function theorem, as the JAX
    version's ``custom_vjp``: the hit distance solves
    ``f(t; theta) = sdf(lo + ld * t, R_, r_) = 0``, so at the root
    ``dt/dtheta = -(df/dtheta) / (df/dt)``.  The backward takes one SDF
    VJP at the saved ``t`` and keeps nothing of the march.
    """
    return _ToriMarch.apply(lo, ld, R_, r_)


def _torus_dsdf(lo, ld, t, R_, r_):
    """Directional derivative of the torus SDF along ``ld`` at ``t``."""
    p = lo + ld * t[..., None]
    rho = vm.sqrt(torch.clamp(p[..., 0] ** 2 + p[..., 2] ** 2, min=1e-24))
    qx = rho - R_
    ql = vm.sqrt(torch.clamp(qx * qx + p[..., 1] ** 2, min=1e-24))
    drho = (p[..., 0] * ld[..., 0] + p[..., 2] * ld[..., 2]) / rho
    return (qx * drho + p[..., 1] * ld[..., 1]) / ql


def _clamp_away(x, eps=1e-6):
    """|x| clamped up to ``eps``, keeping the sign (0 goes to +eps)."""
    return torch.where(torch.abs(x) < eps, torch.where(x < 0, -eps, eps), x)


class _ToriMarch(torch.autograd.Function):
    """:func:`tori_march` with the implicit-function-theorem backward.

    The backward is differentiable once only, as the JAX version's
    ``custom_vjp`` admits no forward-mode derivative: a second
    derivative through a torus hit (the screen warp's Jacobian over a
    torus) raises."""

    @staticmethod
    def forward(ctx, lo, ld, R_, r_):
        t = _tori_march_impl(lo, ld, R_, r_)
        ctx.save_for_backward(t, lo, ld, R_, r_)
        return t

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        t, lo, ld, R_, r_ = ctx.saved_tensors
        fin = torch.isfinite(t)
        ts = torch.where(fin, t, 1.0)
        # misses carry zero cotangent (the inf branch is constant)
        ct = torch.where(fin, ct, 0.0)
        ft = _clamp_away(_torus_dsdf(lo, ld, ts, R_, r_))
        need = ctx.needs_input_grad[:4]
        args = [x.detach().requires_grad_(n) for x, n in zip((lo, ld, R_, r_), need)]
        with torch.enable_grad():
            f = _torus_sdf(args[0] + args[1] * ts[..., None], args[2], args[3])
            grads = iter(torch.autograd.grad(f, [a for a in args if a.requires_grad],
                                             grad_outputs=-ct / ft))
        return tuple(next(grads) if n else None for n in need)


def _tori_march_impl(lo, ld, R_, r_):
    ext = torch.stack([R_ + r_, r_, R_ + r_], dim=-1) * torch.ones_like(lo)
    inv_d = 1.0 / _nonzero(ld)
    t1 = (-ext - lo) * inv_d
    t2 = (ext - lo) * inv_d
    t_in = torch.amax(torch.minimum(t1, t2), dim=-1)
    t_out = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit_box = (t_in < t_out) & (t_out > 0.0)

    def sdf(t):
        return _torus_sdf(lo + ld * t[..., None], R_, r_)

    t_lo = torch.clamp(t_in, min=1e-4)
    t = t_lo
    sign0 = torch.sign(sdf(t))
    sign0 = torch.where(sign0 == 0.0, 1.0, sign0)

    dist = sign0 * sdf(t)
    relaxed = torch.ones(t.shape, dtype=torch.bool, device=t.device)
    for _ in range(_TORUS_STEPS):
        step = dist * torch.where(relaxed, _TORUS_OMEGA, 1.0)
        t2_ = t + torch.where((dist > _TORUS_TOL) & (t < t_out), step, 0.0)
        d2 = sign0 * sdf(t2_)
        # accept while the consecutive step spheres overlap; otherwise
        # stay put and retry conservatively
        accept = (step <= _TORUS_TOL) | (d2 + dist >= step)
        t = torch.where(accept, t2_, t)
        dist = torch.where(accept, d2, dist)
        relaxed = accept

    for _ in range(_TORUS_NEWTON):
        f = sign0 * sdf(t)
        fp = _clamp_away(sign0 * _torus_dsdf(lo, ld, t, R_, r_))
        tn = torch.minimum(torch.maximum(t - f / fp, t_lo), t_out)
        t = torch.where(torch.abs(f) > 1e-6, tn, t)

    dist = torch.abs(sdf(t))
    ok = hit_box & (dist <= 10.0 * _TORUS_TOL) & (t > 0.0) \
        & (t <= t_out + _TORUS_TOL)
    return torch.where(ok, t, INF)


def torus_is_inside(o_local, big_r, small_r):
    """Whether a (local-space) point is inside the torus volume."""
    return _torus_sdf(o_local, big_r, small_r) < 0.0


# ---------------------------------------------------------------------------
# Normals at a hit point
# ---------------------------------------------------------------------------

def _true(d):
    return torch.ones(d.shape[:-1], dtype=torch.bool, device=d.device)


def plane_normal(d, n):
    """Double-sided plane normal: flip toward the ray origin."""
    flip = vm.dot(d, n) > 0.0
    return torch.where(flip[..., None], -n, n), _true(d)


def sphere_normal(o, d, t, center, radius):
    """Outward normal; flipped when the ray starts inside."""
    p = o + d * t[..., None]
    n = (p - center) / _nonzero(radius)[..., None]
    inside = vm.length_sq(o - center) < radius * radius
    n = torch.where(inside[..., None], -n, n)
    return n, ~inside


def triangle_normal(d, v0, v1, v2):
    """Plane normal, flipped for back-side hits."""
    n = vm.normalize(vm.cross(v1 - v0, v2 - v0))
    back = vm.dot(n, d) > 0.0
    return torch.where(back[..., None], -n, n), ~back


_AARECT_FACES = ((-1.0, 0.0, 0.0), (1.0, 0.0, 0.0),
                 (0.0, -1.0, 0.0), (0.0, 1.0, 0.0),
                 (0.0, 0.0, -1.0), (0.0, 0.0, 1.0))


def aarect_normal(o, d, t, bmin, bmax):
    """Face normal of the slab that bounded the hit; inward-facing when
    the ray starts inside."""
    inv_d = 1.0 / _nonzero(d)
    t1 = (bmin - o) * inv_d
    t2 = (bmax - o) * inv_d
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    inside = ~(tmin > 0.0)
    # first match in the test order tx1, tx2, ty1, ty2, tz1, tz2
    cands = torch.stack([t1[..., 0], t2[..., 0], t1[..., 1], t2[..., 1],
                         t1[..., 2], t2[..., 2]], dim=-1)       # (R,6)
    match = torch.isclose(t[..., None], cands, rtol=1e-6, atol=1e-7)
    idx = torch.argmax(match.to(torch.int32), dim=-1)          # (R,)
    faces = torch.tensor(_AARECT_FACES, dtype=o.dtype, device=o.device)
    n = faces[idx]
    n = torch.where(inside[..., None], -n, n)
    return n, ~inside


def square_normal(d):
    """+-y toward the ray origin."""
    up = d[..., 1] <= 0.0
    n = torch.zeros_like(d)
    n[..., 1] = torch.where(up, 1.0, -1.0)
    return n, _true(d)


def torus_normal(o, d, t, center, big_r, small_r):
    """Alpha formula; flipped when the ray starts inside."""
    p = o + d * t[..., None] - center
    alpha = 1.0 - big_r / vm.sqrt(
        torch.clamp(p[..., 0] ** 2 + p[..., 2] ** 2, min=1e-24))
    n = vm.normalize(torch.stack(
        [alpha * p[..., 0], p[..., 1], alpha * p[..., 2]], dim=-1))
    inside = torus_is_inside(o - center, big_r, small_r)
    n = torch.where(inside[..., None], -n, n)
    return n, ~inside


# ---------------------------------------------------------------------------
# Area-light sampling
# ---------------------------------------------------------------------------

def triangle_area(v0, v1, v2):
    """0.5 * |cross(v1 - v0, v2 - v0)|."""
    return 0.5 * torch.linalg.norm(vm.cross(v1 - v0, v2 - v0), dim=-1)


def triangle_pick_random(v0, v1, v2, r1, r2, r3):
    """Uniform point on a triangle via the sqrt warp, with a random-sign
    normal.  Returns (point, normal)."""
    r1s = vm.sqrt(r1)[..., None]
    p = (1.0 - r1s) * v0 + (r1s * (1.0 - r2[..., None])) * v1 \
        + (r2[..., None] * r1s) * v2
    n = vm.normalize(vm.cross(v1 - v0, v2 - v0))
    n = torch.where((r3 > 0.5)[..., None], -n, n)
    return p, n
