"""The estimator, path by path in lockstep: a frozen copy of the port's
``ops/integrator.py`` (``_shade_core``, ``_bounce_step``, ``trace_paths``,
``render_pixels``) over the plain tracer of
:mod:`portbench.reference.tracer`.

Randomness is counter-based: every draw is ``uniform3(seed, ray_id,
slot)`` with one slot per (bounce, purpose), so a path's radiance is a
pure function of its ray id, its primary ray and the seed, whatever
route the program traced it by.  A path of the regenerating queue with
queue index ``i`` is the lockstep path with ``ray_id = rid_base + i``
(:func:`queue_paths`).

``quant`` rounds the carried state to a lower precision after every
step; it is the identity for the reference and bfloat16 for the control
(:mod:`portbench.reference.precision`).
"""

from __future__ import annotations

import math

import torch

from portbench.reference import intersect as isx
from portbench.reference import photon as ph
from portbench.reference import rng as rnglib
from portbench.reference import tracer as tr
from portbench.reference import vecmath as vm
from portbench.reference.camera import primary_rays
from portbench.reference.scene import (EXTRA_ABSORB_B, EXTRA_ABSORB_R, EXTRA_IOR,
                                       EXTRA_REFLECTIVITY, MatKind, Scene)

SLOT_JITTER = 0x7FFF0000
SLOTS_PER_BOUNCE = 8
_SLOT_HEMI = 0
_SLOT_RR = 1
_SLOT_LIGHT_PICK = 2
_SLOT_LIGHT_POINT = 3
_SLOT_PNEE = 4
_SLOT_MAT = 5


def _same(x):
    return x


def sample_cosine_hemisphere(n, r1, r2):
    two_pi_r1 = 2.0 * math.pi * r1
    s = vm.sqrt(torch.clamp(1.0 - r2, min=0.0))
    x = torch.cos(two_pi_r1) * s
    y = vm.sqrt(r2)
    z = torch.sin(two_pi_r1) * s
    t, b = vm.tangent_frame(n)
    wi = vm.normalize(x[..., None] * t + y[..., None] * n + z[..., None] * b)
    return wi, vm.dot(wi, n) / math.pi


def _refract_dir(d, n, eta):
    cos_i = -vm.dot(d, n)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t > 1.0
    cos_t = vm.sqrt(torch.where(sin2_t < 1.0, 1.0 - sin2_t, 1.0))
    cos_t = torch.where(tir, 0.0, cos_t)
    refr = eta[..., None] * d + (eta * cos_i - cos_t)[..., None] * n
    return vm.normalize(refr, eps=1e-12), tir


def _schlick(cos_i, n1, n2):
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_i) ** 5


def _clip(x, lo: float, hi: float):
    """``torch.clamp``; on an autograd path a max and a min, whose
    gradients split a tie on a bound in half."""
    if not x.requires_grad:
        return torch.clamp(x, lo, hi)
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def light_table(scene: Scene):
    """(L, 16) rows: vertices 0:9, intensity 9:12, shape id 12."""
    ls = scene.light_shape.long()
    lrows, lint = scene.params[ls], scene.emission[ls]
    return torch.cat([lrows, lint, scene.light_shape[:, None].to(lrows.dtype),
                      torch.zeros((lrows.shape[0], 3), dtype=lrows.dtype,
                                  device=lrows.device)], dim=1), max(scene.num_lights, 1)


def bounce(scene: Scene, settings: dict, tabs, o, d, tp, color, alive, hdb, absorb,
           slot0, ray_id, seed, photon_grid=None, quant=_same):
    """One lockstep bounce: the nearest hit, the estimator step and the
    NEE shadow ray resolved inline.  Returns the new carry."""
    lpack, n_lights, packed, fams = tabs
    eps = settings["epsilon"]
    t, sid, hit = tr.trace(scene, o, d, fams)
    t = quant(t)
    sid_c = torch.clamp(sid, min=0)
    t_safe = torch.where(hit, t, 1.0)
    info = tr.hit_info(o, d, t_safe, packed[sid_c])

    seg = torch.where(hit, t, 0.0)
    tp = tp * torch.exp(-absorb * seg[..., None])
    hit_point = o + d * t_safe[..., None]
    kind, n = info["kind"], info["n"]
    is_emissive = kind == int(MatKind.EMISSIVE)
    is_refract = kind == int(MatKind.REFRACT)
    is_reflect = kind == int(MatKind.REFLECT)

    miss = alive & ~hit
    color = color + torch.where(miss[..., None], tp * scene.background[None, :], 0.0)
    emis_hit = alive & hit & is_emissive
    has_nee = settings["render_type"] in (1, 2)
    add_emis = emis_hit & ~hdb if has_nee else emis_hit
    color = color + torch.where(add_emis[..., None], tp * info["emission"], 0.0)

    scat = alive & hit & ~is_emissive
    wo = -d
    r1, r2, _ = rnglib.uniform3(seed, ray_id, slot0 + _SLOT_HEMI)
    um, ur, _ = rnglib.uniform3(seed, ray_id, slot0 + _SLOT_MAT)
    wi_d, pdf_d = sample_cosine_hemisphere(n, r1, r2)
    cos_d = vm.dot(wi_d, n)
    contrib_d = info["albedo"] / math.pi * (cos_d / torch.clamp(pdf_d, min=1e-12))[..., None]
    wi_m = vm.reflect(wo, n)
    contrib_m = info["albedo"]
    ent = info["is_entering"]
    ior = info["extra"][:, EXTRA_IOR]
    n1 = torch.where(ent, 1.0, ior)
    n2 = torch.where(ent, ior, 1.0)
    eta = n1 / torch.clamp(n2, min=1e-12)
    cos_i = torch.clamp(-vm.dot(d, n), 0.0, 1.0)
    wi_t, tir = _refract_dir(d, n, eta)
    fres = torch.where(tir, 1.0, _schlick(cos_i, n1, n2))
    take_refl_r = ur < fres
    wi_r = torch.where(take_refl_r[..., None], wi_m, wi_t)
    mirror_now = is_reflect & (um < info["extra"][:, EXTRA_REFLECTIVITY])
    specular = mirror_now | is_refract
    wi = torch.where(is_refract[..., None], wi_r,
                     torch.where(mirror_now[..., None], wi_m, wi_d))
    contrib = torch.where(is_refract[..., None], torch.ones_like(contrib_m),
                          torch.where(mirror_now[..., None], contrib_m, contrib_d))
    new_tp = tp * contrib
    absorb_in = info["extra"][:, EXTRA_ABSORB_R:EXTRA_ABSORB_B + 1]
    entering = is_refract & ~take_refl_r & ent
    exiting = is_refract & ~take_refl_r & ~ent
    new_absorb = torch.where(entering[..., None], absorb_in,
                             torch.where(exiting[..., None], 0.0, absorb))
    diffuse_now = scat & ~specular
    new_hdb = hdb | diffuse_now

    shadow = None
    if has_nee and scene.num_lights > 0:
        if settings["render_type"] == 2 and photon_grid is not None:
            lid, chance = ph.sample(photon_grid, hit_point, seed, ray_id, slot0 + _SLOT_PNEE)
            chance = torch.clamp(chance, min=1e-12)
        else:
            u_pick = rnglib.uniform3(seed, ray_id, slot0 + _SLOT_LIGHT_PICK)
            lid = torch.clamp((u_pick[0] * n_lights).to(torch.int32), max=n_lights - 1)
            chance = max(1.0 / n_lights, 1e-12)
        lrow = lpack[lid.long()]
        lv, intensity = lrow[:, 0:9], lrow[:, 9:12]
        light_sid = lrow[:, 12].to(torch.int64)
        l0, l1, l2 = lv[:, 0:3], lv[:, 3:6], lv[:, 6:9]
        s1, s2, s3 = rnglib.uniform3(seed, ray_id, slot0 + _SLOT_LIGHT_POINT)
        p_l, n_l = isx.triangle_pick_random(l0, l1, l2, s1, s2, s3)
        to_l = p_l - hit_point
        dis_sq = torch.clamp(vm.length_sq(to_l), min=1e-12)
        to_l = to_l / vm.sqrt(dis_sq)[..., None]
        cos_i_l = vm.dot(to_l, n)
        cos_o_l = vm.dot(-to_l, n_l)
        nee = diffuse_now & (cos_i_l > 0.0) & (cos_o_l > 0.0)
        w = isx.triangle_area(l0, l1, l2) * cos_o_l / dis_sq * cos_i_l / chance
        w = torch.where(nee, w, 0.0)
        shadow = (nee, hit_point, p_l, light_sid, new_tp * intensity * w[..., None])

    u_rr = rnglib.uniform3(seed, ray_id, slot0 + _SLOT_RR)[0]
    keep = _clip(torch.amax(new_tp, dim=-1), settings["rr_clamp_min"],
                 settings["rr_clamp_max"])
    survive = u_rr < keep
    new_tp = new_tp / keep[..., None]
    new_alive = scat & survive
    scat3 = scat[..., None]
    o = torch.where(scat3, hit_point + wi * eps, o)
    d = torch.where(scat3, wi, d)
    tp = torch.where(scat3, new_tp, tp)
    absorb = torch.where(scat3, new_absorb, absorb)
    hdb = torch.where(scat, new_hdb, hdb)
    if shadow is not None:
        need, p_from, p_to, lsid, add = shadow
        with torch.no_grad():
            occ = tr.occluded(scene, p_from.detach(), p_to.detach(), lsid, eps, fams)
        color = color + torch.where((need & ~occ)[..., None], add, 0.0)
    return quant(o), quant(d), quant(tp), quant(color), new_alive, hdb, absorb


def trace_paths(scene: Scene, settings: dict, o, d, ray_id, seed, photon_grid=None,
                quant=_same, early_exit: bool = True):
    """Radiance (R, 3) of a batch of paths, all lanes in lockstep, up to
    ``settings['max_bounces']`` bounces.  A bounce with no live lane adds
    nothing, so stopping early changes nothing."""
    R, dev = o.shape[0], o.device
    f32 = scene.params.dtype
    lpack, n_lights = light_table(scene)
    tabs = (lpack, n_lights, tr.pack_hit_rows(scene), tr.families(scene))
    tp = torch.ones((R, 3), dtype=f32, device=dev)
    color = torch.zeros((R, 3), dtype=f32, device=dev)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    hdb = torch.zeros((R,), dtype=torch.bool, device=dev)
    absorb = torch.zeros((R, 3), dtype=f32, device=dev)
    o, d = quant(o), quant(d)
    for b in range(settings["max_bounces"]):
        if early_exit and not bool(alive.any()):
            break
        o, d, tp, color, alive, hdb, absorb = bounce(
            scene, settings, tabs, o, d, tp, color, alive, hdb, absorb,
            b * SLOTS_PER_BOUNCE, ray_id, seed, photon_grid, quant)
    return color


def render_pixels(scene, settings, camera, px, py, width, height, seed, photon_grid=None,
                  quant=_same, early_exit: bool = True):
    """One sample for each pixel (px, py), keyed by its pixel id."""
    ray_id = py.long() * width + px.long()
    jx, jy, _ = rnglib.uniform3(seed, ray_id, SLOT_JITTER)
    o, d = primary_rays(camera, px, py, jx, jy, width, height, settings["screen_z"])
    return trace_paths(scene, settings, o, d, ray_id, seed, photon_grid, quant, early_exit)


def queue_paths(scene, settings, camera, pix, qidx, width, height, seed, rid_base,
                photon_grid=None, quant=_same):
    """Radiance of the paths at queue indices ``qidx`` of a regenerating
    queue whose entries at those indices are the pixel ids ``pix``."""
    rid = (rid_base + qidx.long()) & 0xFFFFFFFF
    jx, jy, _ = rnglib.uniform3(seed, rid, SLOT_JITTER)
    o, d = primary_rays(camera, pix % width, pix // width, jx, jy, width, height,
                        settings["screen_z"])
    return trace_paths(scene, settings, o.contiguous(), d, rid, seed, photon_grid, quant)
