"""Edge-aware (silhouette) gradients by warped-area reparameterization
(``wasm_pathtracer_tpu.ops.edges``).

The interior gradients of ``ops.integrator`` hold every discrete
visibility event constant: which shape a ray hits and whether a shadow
ray is occluded.  Finite differences also see those discontinuities
move (silhouettes sweep across pixels when the camera or geometry
moves; shadow boundaries sweep across the light-sample domain when an
area light moves).  This module adds those boundary terms by warping
each sample's integration variable with ``T(u, theta) = u + V -
detach(V)``, whose theta-velocity matches that of the nearby
discontinuities, times the Jacobian ``det dT/du`` (value 1).  The
warped integral is the true one for every theta, so differentiating
``L(T(u)) * J`` gives the interior and boundary terms together.

Two warps, both value-preserving (the forward render is unchanged):

- :func:`render_pixels_edgeaware`: the screen-space warp for primary
  visibility.  Its field is a boundary-weighted average of the screen
  velocities of auxiliary primary hits, each re-expressed in
  surface-attached coordinates, weighted toward silhouettes.
- :func:`nee_warp`: the warp of the area-light sample uniforms
  ``(r1, r2)`` inside the integrator's NEE block
  (``RenderSettings.edge_aware_nee``), whose discontinuity is the
  occluder's shadow; per-family clearances (spheres, tori, triangle
  edges, box and square outlines) find the nearest silhouette.

The Jacobian needs dT/du on an autograd graph that can itself be
differentiated: :func:`warp_jacobian` takes it row by row with
``torch.autograd.grad(..., create_graph=True)`` (the samples are
independent, so one backward pass per output coordinate gives every
sample's row).  The auxiliary traces go through the kernels on detached
rays, with the winners' distances re-evaluated under autograd
(``trace.trace_scene``), so the kernels only ever see plain detached
tensors.  Like the JAX package, the screen warp needs a dense prep (no cluster
structure, BVH or dense triangle sweep); the NEE warp's occluders are
the prep's dense index sets.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from wasm_pathtracer_tpu_torch.models.camera import Camera
from wasm_pathtracer_tpu_torch.models.scene import PrimType
from wasm_pathtracer_tpu_torch.utils import rng as rnglib
from wasm_pathtracer_tpu_torch.utils import vecmath as vm

_B_MISS = 1.0        # boundary test for rays that hit nothing
_B_EPS = 1e-3        # weight regularizer: w = kernel / (B^2 + eps)
_T_FAR = 1e3         # attachment distance for miss "hits"


def _detach_camera(camera: Camera) -> Camera:
    return Camera(camera.location.detach(), camera.rot_x.detach(),
                  camera.rot_y.detach())


def _aux_offsets(n_aux: int, radius: float, device):
    """The fixed aux-sample pattern: ``n_aux`` points on two rings, no
    centre point.  (K, 2)."""
    k = torch.arange(n_aux, dtype=torch.float32, device=device)
    ang = 2.0 * math.pi * (k / n_aux) + 0.5
    r = torch.where(k % 2 == 0, 1.0, 0.55) * radius
    return torch.stack([r * torch.cos(ang), r * torch.sin(ang)], dim=-1)


def _rays_from_screen(camera: Camera, ux, uy, width, height, screen_z):
    """Primary rays from continuous pixel coordinates (the
    ``primary_rays`` formula with ``px + jx`` as one float)."""
    fw = np.float32(width)
    fh = np.float32(height)
    ar = float(fw / fh)
    fx = (ux / float(fw) - 0.5) * ar
    fy = 0.5 - uy / float(fh)
    pixel = torch.stack([fx, fy, torch.full_like(fx, screen_z)], dim=-1)
    d = vm.normalize(pixel)
    d = vm.rot_x(d, camera.rot_x)
    d = vm.rot_y(d, camera.rot_y)
    o = camera.location.expand(d.shape)
    return o, d


def project_screen(camera: Camera, x, width, height, screen_z):
    """World point -> continuous pixel coordinates (the inverse of the
    primary-ray construction)."""
    p = x - camera.location
    p = vm.rot_y(p, -camera.rot_y)
    p = vm.rot_x(p, -camera.rot_x)
    z = torch.clamp(p[..., 2], min=1e-6)
    ar = float(np.float32(width) / np.float32(height))
    fx = p[..., 0] / z * screen_z
    fy = p[..., 1] / z * screen_z
    ux = (fx / ar + 0.5) * width
    uy = (0.5 - fy) * height
    return torch.stack([ux, uy], dim=-1)


def _barycentric(x, v0, v1, v2):
    """Barycentric coordinates of ``x`` (projected onto the triangle's
    plane)."""
    e1 = v1 - v0
    e2 = v2 - v0
    w = x - v0
    d11 = vm.dot(e1, e1)
    d12 = vm.dot(e1, e2)
    d22 = vm.dot(e2, e2)
    dw1 = vm.dot(w, e1)
    dw2 = vm.dot(w, e2)
    den = d11 * d22 - d12 * d12
    den = torch.where(torch.abs(den) < 1e-20, 1e-20, den)
    b1 = (d22 * dw1 - d12 * dw2) / den
    b2 = (d11 * dw2 - d12 * dw1) / den
    return 1.0 - b1 - b2, b1, b2


def _attached_point(scene, scene0, sid, x0):
    """Hit point ``x0`` in surface-attached coordinates: its value is
    ``x0``, and it carries the geometry derivatives of the attached
    point (frozen barycentrics on triangles, the frozen unit offset from
    a sphere's centre, translation with the anchor row otherwise).
    ``scene0`` is ``scene`` detached."""
    sidc = torch.clamp(sid, min=0)
    rows = scene.params[sidc]
    rows0 = scene0.params[sidc]
    pt = scene0.ptype[sidc]

    b0, b1, b2 = _barycentric(x0, rows0[:, 0:3], rows0[:, 3:6], rows0[:, 6:9])
    x_tri = (b0[..., None] * rows[:, 0:3] + b1[..., None] * rows[:, 3:6]
             + b2[..., None] * rows[:, 6:9])

    c0 = rows0[:, 0:3]
    r0 = torch.clamp(rows0[:, 3], min=1e-9)
    nbar = (x0 - c0) / r0[..., None]
    x_sph = rows[:, 0:3] + rows[:, 3:4] * nbar

    x_tr = x0 + (rows[:, 0:3] - rows0[:, 0:3])

    is_tri = (pt == int(PrimType.TRIANGLE))[..., None]
    is_sph = (pt == int(PrimType.SPHERE))[..., None]
    x_att = torch.where(is_tri, x_tri, torch.where(is_sph, x_sph, x_tr))
    # a miss's far point is attached to the background
    return torch.where((sid < 0)[..., None], x0, x_att)


def _boundary_test(scene0, sid, x0, d0, n0):
    """Silhouette proximity B >= 0 (-> 0 at a silhouette) of aux hits:
    |n.d| for spheres, tori and the plane horizon; the least barycentric
    for triangles; for boxes the second-smallest per-axis distance to a
    slab boundary, each over its own axis extent; for squares the
    Chebyshev distance to the outline over the half side; 1 on misses."""
    sidc = torch.clamp(sid, min=0)
    pt = scene0.ptype[sidc]
    rows0 = scene0.params[sidc]
    b_curved = torch.abs(vm.dot(n0, d0))
    b0, b1, b2 = _barycentric(x0, rows0[:, 0:3], rows0[:, 3:6], rows0[:, 6:9])
    b_tri = torch.clamp(torch.minimum(torch.minimum(b0, b1), b2), 0.0, 1.0)
    bmin, bmax = rows0[:, 0:3], rows0[:, 3:6]
    dax = torch.minimum(torch.abs(x0 - bmin), torch.abs(bmax - x0))
    ext = torch.clamp(bmax - bmin, min=1e-6)
    d_sorted = torch.sort(dax / ext, dim=-1).values
    b_rect = torch.clamp(d_sorted[..., 1], 0.0, 1.0)
    half = torch.clamp(0.5 * rows0[:, 3], min=1e-6)
    dxz = torch.abs(x0[..., ::2] - rows0[:, 0:3][..., ::2])
    b_sq = torch.clamp((half - torch.amax(dxz, dim=-1)) / half, 0.0, 1.0)
    curved = (pt == int(PrimType.SPHERE)) | (pt == int(PrimType.TORUS)) \
        | (pt == int(PrimType.PLANE))
    B = torch.where(curved, b_curved,
                    torch.where(pt == int(PrimType.TRIANGLE), b_tri,
                                torch.where(pt == int(PrimType.AARECT), b_rect,
                                            torch.where(pt == int(PrimType.SQUARE),
                                                        b_sq, _B_MISS))))
    return torch.where(sid < 0, _B_MISS, B)


def _screen_warp_T(prep, scene, settings, camera, u, width, height,
                   n_aux, aux_radius, margin):
    """The warped screen position T(u): (R, 2) -> (R, 2), value ``u``.
    Its derivatives in ``scene`` and ``camera`` carry the
    boundary-weighted content velocity; its u-derivatives give the
    warp's Jacobian (:func:`warp_jacobian`)."""
    from wasm_pathtracer_tpu_torch.ops import trace as tr

    cam0 = _detach_camera(camera)
    scene0 = scene.detach()
    offs = _aux_offsets(n_aux, aux_radius, u.device)       # (K, 2)
    R = u.shape[0]
    K = n_aux
    uk = (u[:, None, :] + offs[None]).reshape(R * K, 2)

    # aux primary rays and hits: free of theta (detached camera and
    # scene), differentiable in u
    o0, d0 = _rays_from_screen(cam0, uk[:, 0], uk[:, 1], width, height,
                               settings.screen_z)
    t, sid, hit, _ = tr.trace_scene(prep, scene0, o0, d0)
    t_eff = torch.where(hit, t, _T_FAR)
    x0 = o0 + d0 * t_eff[..., None]
    sid_eff = torch.where(hit, sid, -1)

    info = tr.hit_info(scene0, o0, d0, torch.where(hit, t, 1.0),
                       torch.clamp(sid, min=0))
    B = _boundary_test(scene0, sid_eff, x0, d0, info["n"])    # (R*K,)

    # content velocity: the moving camera's projection of the
    # surface-attached (moving-geometry) hit point
    x_att = _attached_point(scene, scene0, sid_eff, x0)
    u_proj = project_screen(camera, x_att, width, height, settings.screen_z)
    vel = (u_proj - u_proj.detach()).reshape(R, K, 2)  # value 0, theta-velocity

    kern = torch.exp(-0.5 * (torch.sum(offs ** 2, -1) / (0.6 * aux_radius) ** 2))
    w = kern[None, :] / (B.reshape(R, K) ** 2 + _B_EPS)        # (R, K)
    V = torch.sum(w[..., None] * vel, dim=1) / \
        torch.clamp(torch.sum(w, dim=1), min=1e-12)[..., None]

    # damp to zero at the pixel window's edge: a fixed domain boundary
    # carries no flux
    if margin > 0.0:
        dx = torch.minimum(u[:, 0], width - u[:, 0]) / margin
        dy = torch.minimum(u[:, 1], height - u[:, 1]) / margin
        rho = torch.clamp(dx, 0.0, 1.0) * torch.clamp(dy, 0.0, 1.0)
        V = V * rho[:, None]
    return u + V


def warp_jacobian(T_fn, u):
    """``T = T_fn(u)`` and the 2x2 warp Jacobian determinant, its value
    pinned to exactly 1 (the warp vanishes at the evaluation point; only
    the theta-derivatives of its divergence remain).

    Row k of every sample's Jacobian is the gradient of ``T[:, k].sum()``
    with respect to ``u`` (samples are independent), taken with
    ``create_graph`` so the determinant stays differentiable in theta.
    """
    with torch.enable_grad():
        u = u.detach().requires_grad_(True)
        T = T_fn(u)
        rows = [torch.autograd.grad(T[:, k].sum(), u, create_graph=True)[0]
                for k in range(2)]

    def pinned(x, one):
        return x - x.detach() + one

    a = pinned(rows[0][:, 0], 1.0)     # dT0/du0
    b = pinned(rows[0][:, 1], 0.0)     # dT0/du1
    c = pinned(rows[1][:, 0], 0.0)     # dT1/du0
    d = pinned(rows[1][:, 1], 1.0)     # dT1/du1
    return T, a * d - b * c


def render_pixels_edgeaware(prep, scene, settings, camera: Camera,
                            px, py, width: int, height: int, seed,
                            photon_grid=None, n_aux: int = 8,
                            aux_radius: float = 1.25,
                            window_margin: float = 1.5):
    """Edge-aware twin of ``ops.integrator.render_pixels``: the same
    value (the warp preserves it), and gradients that also carry the
    primary-visibility boundary terms.  Needs a dense prep.

    ``aux_radius`` is the warp's support on the screen, in pixels.
    """
    if prep.cluster is not None or prep.has_bvh or prep.use_pallas:
        raise AssertionError("edge-aware gradients need the dense "
                             "differentiable trace path")
    from wasm_pathtracer_tpu_torch.ops import integrator

    ray_id = py.long() * width + px.long()
    jx, jy, _ = rnglib.uniform3(seed, ray_id, integrator.SLOT_JITTER)
    u = torch.stack([px.to(torch.float32) + jx, py.to(torch.float32) + jy], dim=-1)

    T_fn = functools.partial(_screen_warp_T, prep, scene, settings, camera,
                             width=width, height=height, n_aux=n_aux,
                             aux_radius=aux_radius, margin=window_margin)
    T, J = warp_jacobian(T_fn, u)

    o, d = _rays_from_screen(camera, T[:, 0], T[:, 1], width, height,
                             settings.screen_z)
    col, cost = integrator.trace_paths(prep, scene, settings, o, d, ray_id, seed,
                                       photon_grid=photon_grid)
    return col * J[:, None], cost


# ---------------------------------------------------------------------------
# The NEE shadow-visibility warp (light-sample uniform space)
# ---------------------------------------------------------------------------

def _torus_sdf_grad(p, big_r, small_r):
    """Analytic gradient of the flat-lying torus SDF (local frame)."""
    rho = vm.sqrt(torch.clamp(p[..., 0] ** 2 + p[..., 2] ** 2, min=1e-24))
    qx = rho - big_r
    L = vm.sqrt(torch.clamp(qx * qx + p[..., 1] ** 2, min=1e-24))
    gx = (qx / L) * (p[..., 0] / rho)
    gy = p[..., 1] / L
    gz = (qx / L) * (p[..., 2] / rho)
    return torch.stack([gx, gy, gz], dim=-1)


def _ray_edges_clearance(x0, nu, seg_len, a, b):
    """Closest approach of the segments ``x0 + s*nu, s in (0, seg_len)``
    to the edge segments ``a[e] .. b[e]``.  Returns (B (R, E) angular
    clearance dist / s, z (R, E, 3) closest edge points)."""
    e = b - a                                          # (E, 3)
    w0 = a[None, :, :] - x0[:, None, :]                # (R, E, 3)
    nu_e = nu[:, None, :]
    d_ee = torch.sum(e * e, -1)[None]                  # (1, E)
    d_en = torch.sum(e[None] * nu_e, -1)               # (R, E)
    d_w0e = torch.sum(w0 * e[None], -1)
    d_w0n = torch.sum(w0 * nu_e, -1)
    den = d_ee - d_en * d_en
    den_s = torch.where(torch.abs(den) < 1e-12, 1e-12, den)
    # edge parameter of the point closest to the ray line
    tc = torch.clamp((d_en * d_w0n - d_w0e * 1.0) / -den_s, 0.0, 1.0)
    s_c = d_w0n + tc * d_en
    s_c = torch.minimum(torch.clamp(s_c, min=1e-4), seg_len[:, None])
    ze = a[None] + tc[..., None] * e[None]             # (R, E, 3)
    diff = ze - (x0[:, None, :] + s_c[..., None] * nu_e)
    dist = vm.sqrt(torch.clamp(vm.length_sq(diff), min=1e-20))
    return dist / s_c, ze


def _fold_min(best_B, best_z, Bs, zs):
    """Fold one family's (R, N) candidates into the running
    (best_B (R,), best_z (R, 3)) minimum (first minimum on ties)."""
    j = torch.argmin(Bs, dim=1)
    Bmin = torch.gather(Bs, 1, j[:, None])[:, 0]
    zmin = torch.gather(zs, 1, j[:, None, None].expand(-1, 1, 3))[:, 0]
    better = Bmin < best_B
    return (torch.where(better, Bmin, best_B),
            torch.where(better[:, None], zmin, best_z))


_TORUS_COARSE = 16    # coarse samples along the segment
_TORUS_REFINE = 8     # samples per refinement pass (x2 passes)
_TORUS_NEWTON = 2     # Newton polishes of d/ds sdf = 0


def _take(v, s):
    """``s`` at the first minimum of ``v`` along the last axis."""
    j = torch.argmin(v, dim=-1, keepdim=True)
    return torch.gather(s, -1, j)[..., 0]


def _torus_segment_clearance(x0, nu, seg_len, c, big_r, small_r):
    """Min |sdf| of each segment against each torus, by a coarse-to-fine
    search on ``f(s) = sdf(x0 + s*nu - c)`` and a Newton polish of
    ``f'(s) = 0``.  The signed minimum vanishes at grazing from both
    sides.  Returns (B (R, T), z (R, T, 3)): clearance over the argmin
    distance and the SDF projection of the argmin point onto the
    surface.  Runs on the detached scene."""
    from wasm_pathtracer_tpu_torch.ops.intersect import _torus_sdf

    p0 = x0[:, None, :] - c[None]                       # (R, T, 3)
    nu_t = nu[:, None, :]                               # (R, 1, 3)
    Rb, rb = big_r[None], small_r[None]                 # (1, T)

    def f(s):                                           # (R, T, S)
        return _torus_sdf(p0[..., None, :] + s[..., None] * nu_t[..., None, :],
                          Rb[..., None], rb[..., None])

    lo = torch.full_like(seg_len[:, None] * Rb, 1e-4)   # (R, T)
    hi = seg_len[:, None] * torch.ones_like(Rb)
    frac = (torch.arange(_TORUS_COARSE, dtype=torch.float32, device=x0.device)
            + 0.5) / _TORUS_COARSE
    s = lo[..., None] + (hi - lo)[..., None] * frac      # (R, T, S)
    s_best = _take(f(s), s)
    w = (hi - lo) / _TORUS_COARSE
    frac = (torch.arange(_TORUS_REFINE, dtype=torch.float32, device=x0.device)
            + 0.5) / _TORUS_REFINE
    for _ in range(2):                                   # two refinement passes
        s = torch.minimum(torch.maximum(s_best[..., None] + w[..., None]
                                        * (2.0 * frac - 1.0), lo[..., None]),
                          hi[..., None])
        s_best = _take(f(s), s)
        w = w * (2.0 / _TORUS_REFINE)

    # Newton polish of f'(s) = 0: analytic f', finite-difference f''
    h = torch.clamp(1e-3 * (hi - lo), min=1e-5)
    for _ in range(_TORUS_NEWTON):
        p = p0 + s_best[..., None] * nu_t
        g = torch.sum(_torus_sdf_grad(p, Rb, rb) * nu_t, -1)
        p_h = p0 + (s_best + h)[..., None] * nu_t
        g_h = torch.sum(_torus_sdf_grad(p_h, Rb, rb) * nu_t, -1)
        curv = (g_h - g) / h
        curv = torch.where(torch.abs(curv) < 1e-6, 1e-6, curv)
        step = torch.minimum(torch.maximum(-g / curv, -w), w)
        s_best = torch.minimum(torch.maximum(s_best + step, lo), hi)

    p = p0 + s_best[..., None] * nu_t
    sdf = _torus_sdf(p, Rb, rb)                          # (R, T), signed
    grad = _torus_sdf_grad(p, Rb, rb)
    z = x0[:, None, :] + s_best[..., None] * nu_t - sdf[..., None] * grad
    return torch.abs(sdf) / s_best, z


def _segment_clearance(prep, scene0, light_sid, x0, nu, seg_len):
    """Angular clearance of the segment ``x0 + s*nu, s in (0, seg_len)``
    against every finite occluder, and the nearest silhouette point.

    Returns (B (R,), z (R, 3)): B -> 0 where the segment grazes an
    occluder's silhouette, from the blocked and the clear side alike.
    Spheres by closest approach, tori by the signed SDF minimum,
    triangles by their edges (area lights excluded), boxes by their 12
    edges, squares by their 4.  Planes have no outline.
    """
    R = x0.shape[0]
    best_B = torch.full((R,), 1e9, dtype=torch.float32, device=x0.device)
    best_z = x0 + nu  # placeholder

    if prep.idx_sphere.shape[0]:
        rows = scene0.params[prep.idx_sphere]
        c = rows[:, 0:3]
        r = rows[:, 3]
        to_c = c[None, :, :] - x0[:, None, :]              # (R, S, 3)
        s_star = torch.minimum(torch.clamp(torch.sum(to_c * nu[:, None, :], -1),
                                           min=1e-4), seg_len[:, None])
        q = x0[:, None, :] + s_star[..., None] * nu[:, None, :]
        dq = q - c[None]
        dist = vm.sqrt(torch.clamp(vm.length_sq(dq), min=1e-20))
        Bs = torch.abs(dist - r[None, :]) / s_star
        zs = c[None] + (r[None, :] / dist)[..., None] * dq
        best_B, best_z = _fold_min(best_B, best_z, Bs, zs)

    if prep.idx_torus.shape[0]:
        rows = scene0.params[prep.idx_torus]
        Bt, zt = _torus_segment_clearance(x0, nu, seg_len, rows[:, 0:3],
                                          rows[:, 3], rows[:, 4])
        best_B, best_z = _fold_min(best_B, best_z, Bt, zt)

    if prep.idx_triangle.shape[0]:
        ids = prep.idx_triangle
        verts = scene0.params[ids].reshape(-1, 3, 3)       # (T, 3, 3)
        a = verts.reshape(-1, 3)                           # edge starts (3T, 3)
        b = torch.roll(verts, -1, dims=1).reshape(-1, 3)   # edge ends
        eid_sid = torch.repeat_interleave(ids, 3)
        Bt, ze = _ray_edges_clearance(x0, nu, seg_len, a, b)
        # area-light triangles are not occluders of the warp: the
        # sampled light is transparent to its own shadow rays, and a
        # coplanar sibling (quad lights are triangle pairs) would read
        # B -> 0 along the shared diagonal without ever occluding
        if scene0.num_lights > 0:
            is_light = torch.any(eid_sid[:, None] == scene0.light_shape[None, :].long(),
                                 dim=1)
            Bt = torch.where(is_light[None, :], 1e9, Bt)
        else:
            Bt = torch.where(eid_sid[None, :] == light_sid[:, None], 1e9, Bt)
        best_B, best_z = _fold_min(best_B, best_z, Bt, ze)

    if prep.idx_aarect.shape[0]:
        rows = scene0.params[prep.idx_aarect]
        a_e, b_e = _box_edges(rows[:, 0:3], rows[:, 3:6])
        Br, zr = _ray_edges_clearance(x0, nu, seg_len, a_e, b_e)
        best_B, best_z = _fold_min(best_B, best_z, Br, zr)

    if prep.idx_square.shape[0]:
        rows = scene0.params[prep.idx_square]
        a_e, b_e = _square_edges(rows[:, 0:3], rows[:, 3])
        Bq, zq = _ray_edges_clearance(x0, nu, seg_len, a_e, b_e)
        best_B, best_z = _fold_min(best_B, best_z, Bq, zq)

    return torch.clamp(best_B, max=_B_MISS), best_z


# box corner k takes bit j of k as its min (0) / max (1) choice on axis j
_BOX_SEL = np.array([[(i >> k) & 1 for k in range(3)] for i in range(8)], np.float32)
_BOX_EDGES = np.array([[0, 1], [2, 3], [4, 5], [6, 7],      # x-edges
                       [0, 2], [1, 3], [4, 6], [5, 7],      # y-edges
                       [0, 4], [1, 5], [2, 6], [3, 7]])     # z-edges


def _box_edges(bmin, bmax):
    """The 12 edges of each axis-aligned box: (A, 3), (A, 3) ->
    (12A, 3), (12A, 3) endpoints."""
    A = bmin.shape[0]
    sel = torch.from_numpy(_BOX_SEL).to(bmin.device)
    corners = bmin[:, None, :] * (1.0 - sel[None]) + bmax[:, None, :] * sel[None]
    a = corners[:, _BOX_EDGES[:, 0], :].reshape(12 * A, 3)
    b = corners[:, _BOX_EDGES[:, 1], :].reshape(12 * A, 3)
    return a, b


def _square_edges(center, size):
    """The 4 outline edges of each y-plane square (centre, full side)."""
    Q = center.shape[0]
    h = (0.5 * size)[:, None]                              # (Q, 1)
    sx = torch.tensor([[-1.0, 1.0, 1.0, -1.0]], device=center.device)
    sz = torch.tensor([[-1.0, -1.0, 1.0, 1.0]], device=center.device)
    corners = torch.stack([center[:, 0:1] + h * sx,
                           center[:, 1:2].expand(Q, 4),
                           center[:, 2:3] + h * sz], dim=-1)  # (Q, 4, 3)
    a = corners.reshape(4 * Q, 3)
    b = torch.roll(corners, -1, dims=1).reshape(4 * Q, 3)
    return a, b


def _uv_from_point(y, l0, l1, l2):
    """Invert the triangle sqrt-warp: a point on the light's plane -> the
    (r1, r2) that ``intersect.triangle_pick_random`` maps there."""
    b0, b1, b2 = _barycentric(y, l0, l1, l2)
    s = torch.clamp(1.0 - b0, min=1e-4)
    return torch.stack([s * s, b2 / s], dim=-1)


def _nee_warp_T(prep, scene, light_rows, light_sid, x_sh, u, n_aux, radius):
    """Warped light-sample uniforms T(u): (R, 2) -> (R, 2), value ``u``.
    ``light_rows`` are the sampled lights' (l0, l1, l2) rows, attached to
    theta; ``x_sh`` the detached shading points."""
    scene0 = scene.detach()
    rows0 = light_rows.detach()
    l0a, l1a, l2a = light_rows[:, 0:3], light_rows[:, 3:6], light_rows[:, 6:9]
    l00, l10, l20 = rows0[:, 0:3], rows0[:, 3:6], rows0[:, 6:9]

    offs = _aux_offsets(n_aux, radius, u.device)            # (K, 2)
    R = u.shape[0]
    K = n_aux
    uk = u[:, None, :] + offs[None]
    uk = torch.clamp(uk, 1e-3, 1.0 - 1e-3).reshape(R * K, 2)

    def rep(v):
        return torch.repeat_interleave(v, K, dim=0)

    # aux light points on the frozen light (free of theta, differentiable in u)
    r1s = vm.sqrt(uk[:, 0])[..., None]
    y = ((1.0 - r1s) * rep(l00) + (r1s * (1.0 - uk[:, 1][..., None])) * rep(l10)
         + (uk[:, 1][..., None] * r1s) * rep(l20))       # (R*K, 3)

    x0 = rep(x_sh)
    to_y = y - x0
    seg_len = vm.sqrt(torch.clamp(vm.length_sq(to_y), min=1e-20))
    nu = to_y / seg_len[..., None]

    B, z = _segment_clearance(prep, scene0, rep(light_sid), x0, nu, seg_len)

    # the boundary point in uniform space: the ray through the frozen
    # silhouette point pierces the moving light's plane there, mapped
    # back through the sampling warp
    nu_z = vm.normalize(z - x0, eps=1e-12)
    n_l = vm.cross(rep(l1a) - rep(l0a), rep(l2a) - rep(l0a))
    denom = vm.dot(nu_z, n_l)
    denom = torch.where(torch.abs(denom) < 1e-9,
                        torch.where(denom < 0, -1e-9, 1e-9), denom)
    t_star = vm.dot(rep(l0a) - x0, n_l) / denom
    y_star = x0 + t_star[..., None] * nu_z
    u_star = _uv_from_point(y_star, rep(l0a), rep(l1a), rep(l2a))
    # a shadow far outside the light cannot be this sample's nearest
    # discontinuity; the clamp also bounds the inverse warp's b0 -> 1
    # singularity
    u_star = torch.clamp(u_star, -0.5, 1.5)
    # gate the velocity by clearance: it has to match the boundary's at
    # B -> 0 and stay continuous, and decays away from boundaries
    GATE = 0.08
    gate = GATE * GATE / (B * B + GATE * GATE)
    vel = ((u_star - u_star.detach()) * gate[..., None]).reshape(R, K, 2)

    kern = torch.exp(-0.5 * (torch.sum(offs ** 2, -1) / (0.6 * radius) ** 2))
    w = kern[None, :] / (B.reshape(R, K) ** 2 + _B_EPS)
    V = torch.sum(w[..., None] * vel, dim=1) / \
        torch.clamp(torch.sum(w, dim=1), min=1e-12)[..., None]

    # damp at the uniform domain's edges (fixed, no flux)
    m = 0.04
    rho = torch.clamp(torch.minimum(u[:, 0], 1.0 - u[:, 0]) / m, 0.0, 1.0) \
        * torch.clamp(torch.minimum(u[:, 1], 1.0 - u[:, 1]) / m, 0.0, 1.0)
    return u + V * rho[:, None]


def nee_warp(prep, scene, light_rows, light_sid, hit_point, s1, s2,
             n_aux: int = 6, radius: float = 0.12):
    """Warp the NEE light-sample uniforms; returns (s1', s2', J) with the
    values of (s1, s2, 1).  Off an autograd path (nothing the sample
    depends on requires grad) the warp would change nothing, and the
    inputs come back as they are."""
    if not (torch.is_grad_enabled() and light_rows.requires_grad):
        return s1, s2, torch.ones_like(s1)
    u = torch.stack([s1, s2], dim=-1)
    T_fn = functools.partial(_nee_warp_T, prep, scene, light_rows, light_sid,
                             hit_point.detach(), n_aux=n_aux, radius=radius)
    T, J = warp_jacobian(T_fn, u)
    return T[:, 0], T[:, 1], J
