"""Whitted-style deterministic ray tracer (``wasm_pathtracer_tpu.ops.whitted``).

- The recursion tree (reflect and refract branches) is unrolled in
  Python to the configured depth: each level traces the whole ray batch,
  masked, so a depth-``k`` render makes 2^(k+1) - 1 traces.
- Both Fresnel branches of a dielectric are traced, weighted by
  Schlick's approximation, with Beer-Lambert absorption along interior
  segments.
- Direct lighting: point, spot and directional lights with hard
  shadows, and area lights sampled at their centroids.

Every trace goes through ``trace.trace_scene`` (the nearest-hit kernel,
and the cluster probes on a cluster prep) and every occlusion through
``trace.shadow_ray`` (the any-hit kernel on a dense prep).  The render
is differentiable with respect to materials, lights and camera: the
shadow verdicts are constants, decided on detached rays without
autograd, and the trace re-evaluates the winners' distances.
"""

from __future__ import annotations

import math

import torch

from wasm_pathtracer_tpu_torch.config import RenderSettings
from wasm_pathtracer_tpu_torch.models.camera import Camera, primary_rays
from wasm_pathtracer_tpu_torch.models.scene import (
    EXTRA_ABSORB_B, EXTRA_ABSORB_R, EXTRA_IOR, EXTRA_REFLECTIVITY, MatKind,
    SceneData,
)
from wasm_pathtracer_tpu_torch.ops import intersect as isx
from wasm_pathtracer_tpu_torch.ops import trace as tr
from wasm_pathtracer_tpu_torch.ops.integrator import _clip, _refract_dir, _schlick
from wasm_pathtracer_tpu_torch.utils import vecmath as vm


def _occluded(prep, scene: SceneData, p, target, light_sid, eps):
    """Shadow verdicts of rays from ``p`` to ``target`` (``light_sid`` an
    (R,) int64 tensor: -1 for no light shape, -2 for a padded slot):
    constants, decided on detached inputs without autograd."""
    with torch.no_grad():
        occ, _ = tr.shadow_ray(prep, scene.detach(), p.detach().contiguous(),
                               target.detach().contiguous(), light_sid, eps)
    return occ


def _direct_light(prep, scene: SceneData, p, n, albedo, eps,
                  light_chunk: int = 16):
    """Direct illumination at a diffuse surface point (hard shadows).

    Every area light contributes, sampled at its centroid.  The lights
    go in chunks of ``light_chunk``, each chunk one shadow query over
    R * chunk rays; padded slots of the last chunk have zero area and
    shape id -2.  A chunk's tensors are dropped before the next.
    """
    R = p.shape[0]
    dev = p.device
    out = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    brdf = albedo / math.pi

    L = scene.num_lights
    if L > 0:
        lsid = scene.light_shape.long()
        lrows = scene.params[lsid]                          # (L, 9)
        v0, v1, v2 = lrows[:, 0:3], lrows[:, 3:6], lrows[:, 6:9]
        centroid = (v0 + v1 + v2) / 3.0
        n_l = vm.normalize(vm.cross(v1 - v0, v2 - v0))
        area = isx.triangle_area(v0, v1, v2)
        emit = scene.emission[lsid]

        Lc = min(light_chunk, L)
        pad = (-L) % Lc

        def padded(x, value=0.0):
            return torch.nn.functional.pad(
                x, (0, 0, 0, pad) if x.dim() == 2 else (0, pad), value=value)

        cent_p, nl_p = padded(centroid), padded(n_l)
        area_p, emit_p = padded(area), padded(emit)
        sid_p = padded(lsid, -2)
        acc = torch.zeros((R, 3), dtype=torch.float32, device=dev)
        for c0 in range(0, L + pad, Lc):
            cent, nl = cent_p[c0:c0 + Lc], nl_p[c0:c0 + Lc]
            ar, em, sid = area_p[c0:c0 + Lc], emit_p[c0:c0 + Lc], sid_p[c0:c0 + Lc]
            to_l = cent[None, :, :] - p[:, None, :]          # (R, Lc, 3)
            dis_sq = torch.clamp(torch.sum(to_l * to_l, -1), min=1e-12)
            to_l = to_l / vm.sqrt(dis_sq)[..., None]
            cos_i = torch.sum(to_l * n[:, None, :], -1)
            cos_o = torch.abs(torch.sum(-to_l * nl[None, :, :], -1))   # two-sided
            vis = (cos_i > 0.0) & (ar[None, :] > 0.0)
            occ = _occluded(prep, scene, p[:, None, :].expand(R, Lc, 3).reshape(-1, 3),
                            cent[None, :, :].expand(R, Lc, 3).reshape(-1, 3),
                            sid[None, :].expand(R, Lc).reshape(-1), eps)
            w = ar[None, :] * cos_o / dis_sq * cos_i
            w = torch.where(vis & ~occ.view(R, Lc), w, 0.0)
            acc = acc + torch.sum(w[..., None] * em[None, :, :], dim=1)
            del to_l, dis_sq, cos_i, cos_o, vis, occ, w
        out = out + brdf * acc

    # 0-sized lights
    none = torch.full((R,), -1, dtype=torch.int64, device=dev)
    for li, kind in enumerate(scene.plight_kind.tolist()):
        color = scene.plight_color[li]
        if kind == 2:   # directional: constant direction, no falloff
            to_l = (-vm.normalize(scene.plight_dir[li])[None, :]).expand(p.shape)
            cos_i = vm.dot(to_l, n)
            occ = _occluded(prep, scene, p, p + to_l * 1e4, none, eps)
            w = torch.where((cos_i > 0.0) & ~occ, cos_i, 0.0)
        else:           # point / spot: inverse-square falloff
            lp = scene.plight_pos[li]
            to_l = lp[None, :] - p
            dis_sq = torch.clamp(vm.length_sq(to_l), min=1e-12)
            to_l = to_l / vm.sqrt(dis_sq)[..., None]
            cos_i = vm.dot(to_l, n)
            vis = cos_i > 0.0
            if kind == 1:  # spot cone test
                cos_cone = torch.cos(scene.plight_angle[li])
                spot_dir = vm.normalize(scene.plight_dir[li])
                vis = vis & (vm.dot(-to_l, spot_dir[None, :]) >= cos_cone)
            occ = _occluded(prep, scene, p, lp[None, :].expand(p.shape), none, eps)
            w = torch.where(vis & ~occ, cos_i / dis_sq, 0.0)
        out = out + brdf * color * w[..., None]

    return out


def trace_whitted(prep, scene: SceneData, settings: RenderSettings,
                  o, d, depth: int, absorb=None):
    """Trace one level of the Whitted tree and recurse on ``depth``
    (unrolled in Python).  Returns (R, 3) radiance."""
    R = o.shape[0]
    eps = settings.epsilon
    if absorb is None:
        absorb = torch.zeros((R, 3), dtype=torch.float32, device=o.device)

    t, sid, hit, _ = tr.trace_scene(prep, scene, o, d)
    t_safe = torch.where(hit, t, 1.0)
    sid_c = torch.clamp(sid, min=0)
    info = tr.hit_info(scene, o, d, t_safe, sid_c)
    p = o + d * t_safe[..., None]
    n = info["n"]
    kind = info["kind"]

    seg = torch.where(hit, t, 0.0)
    beer = torch.exp(-absorb * seg[..., None])

    bg = scene.background[None, :].expand(R, 3)
    color = torch.where(hit[..., None], 0.0, bg)

    # emissive
    emis = hit & (kind == int(MatKind.EMISSIVE))
    color = torch.where(emis[..., None], info["emission"], color)

    # diffuse component (diffuse shapes fully; reflect shapes partially)
    diffuse_w = torch.where(kind == int(MatKind.DIFFUSE), 1.0,
                            torch.where(kind == int(MatKind.REFLECT),
                                        1.0 - info["extra"][:, EXTRA_REFLECTIVITY], 0.0))
    need_diffuse = hit & (diffuse_w > 0.0)
    direct = _direct_light(prep, scene, p, n, info["albedo"], eps)
    color = color + torch.where(need_diffuse[..., None],
                                diffuse_w[..., None] * direct, 0.0)

    if depth > 0:
        wo = -d
        # mirror branch (REFLECT shapes and the Fresnel reflection of REFRACT)
        wi_m = vm.reflect(wo, n)
        refl_w = torch.where(kind == int(MatKind.REFLECT),
                             info["extra"][:, EXTRA_REFLECTIVITY], 0.0)

        ent = info["is_entering"]
        ior = info["extra"][:, EXTRA_IOR]
        n1 = torch.where(ent, 1.0, ior)
        n2 = torch.where(ent, ior, 1.0)
        eta = n1 / torch.clamp(n2, min=1e-12)
        cos_i = _clip(-vm.dot(d, n), 0.0, 1.0)
        wi_t, tir = _refract_dir(d, n, eta)
        fres = torch.where(tir, 1.0, _schlick(cos_i, n1, n2))
        is_refr = kind == int(MatKind.REFRACT)
        refl_w = refl_w + torch.where(is_refr, fres, 0.0)
        trans_w = torch.where(is_refr, 1.0 - fres, 0.0)

        any_refl = hit & (refl_w > 0.0)
        any_trans = hit & (trans_w > 0.0) & ~tir

        # the transmitted branch's absorption inside the new medium
        absorb_in = info["extra"][:, EXTRA_ABSORB_R:EXTRA_ABSORB_B + 1]
        absorb_t = torch.where(ent[..., None], absorb_in, 0.0)

        sub_r = trace_whitted(prep, scene, settings, p + wi_m * eps, wi_m,
                              depth - 1, absorb)
        color = color + torch.where(any_refl[..., None],
                                    refl_w[..., None] * info["albedo"] * sub_r, 0.0)
        sub_t = trace_whitted(prep, scene, settings, p + wi_t * eps, wi_t,
                              depth - 1, absorb_t)
        color = color + torch.where(any_trans[..., None], trans_w[..., None] * sub_t, 0.0)

    return color * beer


def render_whitted(prep, scene: SceneData, settings: RenderSettings,
                   camera: Camera, px, py, width: int, height: int,
                   depth: int = 4):
    """Whitted render through pixel centres (deterministic, no jitter).
    Returns (R, 3) radiance for the pixels ``(px, py)``."""
    half = torch.full(px.shape, 0.5, dtype=torch.float32, device=px.device)
    o, d = primary_rays(camera, px, py, half, half, width, height, settings.screen_z)
    return trace_whitted(prep, scene, settings, o, d, depth)
