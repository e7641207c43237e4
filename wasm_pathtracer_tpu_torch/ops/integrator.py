"""The wavefront path-tracing integrator (``wasm_pathtracer_tpu.ops.integrator``).

The estimator is the JAX package's, step for step: emissive hits add
``throughput * intensity`` only without NEE or before the first diffuse
bounce; cosine-weighted hemisphere sampling; area-light NEE with the
solid-angle estimator; Russian roulette on the clamped max throughput;
a miss adds ``throughput * background``.  REFLECT / REFRACT materials
are masked branches of the same step.  With ``RenderType.PNEE`` and a
photon grid (``ops.photon``) the NEE light is drawn from the grid's
per-cell histogram instead of uniformly.

Randomness is counter-based: every draw is ``uniform3(seed, ray_id,
slot)`` with one slot per (bounce, purpose), the JAX package's layout,
so a path draws the same numbers in both packages.

Two drivers share the per-bounce body :func:`_bounce_step`:
:func:`trace_paths` (a fixed batch in lockstep) and :func:`render_queue`
(the persistent wavefront with path regeneration, the main path).

:func:`trace_paths` and :func:`render_pixels` are differentiable in the
scene's material leaves, its shape table (light rows) and the camera.
Which shape a ray hits and whether a shadow ray is occluded are
constants, as in the JAX package: the kernels decide them on detached
rays, and the winner's distance is re-evaluated under autograd
(``trace.trace_scene``).  The pcg3d draws do not depend on the
parameters.  With ``RenderSettings.checkpoint_bounces`` each bounce is
recomputed in the backward pass instead of keeping its intermediates,
and with ``edge_aware_nee`` the NEE light sample goes through the
shadow-boundary warp of ``ops.edges``.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models.camera import Camera, primary_rays
from wasm_pathtracer_tpu_torch.models.scene import (
    EXTRA_ABSORB_B, EXTRA_ABSORB_R, EXTRA_IOR, EXTRA_REFLECTIVITY, MatKind,
    SceneData,
)
from wasm_pathtracer_tpu_torch.ops import intersect as isx
from wasm_pathtracer_tpu_torch.ops import trace as tr
from wasm_pathtracer_tpu_torch.utils import rng as rnglib
from wasm_pathtracer_tpu_torch.utils import vecmath as vm

# RNG slot layout: slots [b*8, b*8+8) belong to bounce b; SLOT_JITTER is
# the pixel jitter of a primary ray.
SLOT_JITTER = 0x7FFF0000
_SLOTS_PER_BOUNCE = 8
_SLOT_HEMI = 0
_SLOT_RR = 1
_SLOT_LIGHT_PICK = 2
_SLOT_LIGHT_POINT = 3
_SLOT_PNEE = 4
_SLOT_MAT = 5


def sample_cosine_hemisphere(n, r1, r2):
    """Cosine-weighted hemisphere sample around ``n``.  Returns (wi, pdf)."""
    two_pi_r1 = 2.0 * math.pi * r1
    s = vm.sqrt(torch.clamp(1.0 - r2, min=0.0))
    x = torch.cos(two_pi_r1) * s
    y = vm.sqrt(r2)
    z = torch.sin(two_pi_r1) * s
    t, b = vm.tangent_frame(n)
    wi = vm.normalize(x[..., None] * t + y[..., None] * n + z[..., None] * b)
    pdf = vm.dot(wi, n) / math.pi
    return wi, pdf


def _refract_dir(d, n, eta):
    """Snell refraction of incoming direction ``d`` about ``n``
    (eta = n1/n2).  Returns (dir, total internal reflection mask)."""
    cos_i = -vm.dot(d, n)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t > 1.0
    cos_t = vm.sqrt(torch.where(sin2_t < 1.0, 1.0 - sin2_t, 1.0))
    cos_t = torch.where(tir, 0.0, cos_t)
    refr = eta[..., None] * d + (eta * cos_i - cos_t)[..., None] * n
    return vm.normalize(refr, eps=1e-12), tir


def _schlick(cos_i, n1, n2):
    """Schlick's Fresnel approximation."""
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_i) ** 5


def _clip(x, lo: float, hi: float):
    """``torch.clamp``, with the JAX package's gradient where ``x`` lies
    exactly on a bound: ``jnp.clip`` is a max and a min, whose gradients
    split a tie in half, where ``torch.clamp`` passes all of it.  An
    albedo of 0.9 puts the Russian-roulette keep chance right on its
    upper bound.  Off an autograd path it stays one ``torch.clamp``, so
    the forward drivers (:func:`render_queue`, the flat wavefront)
    launch the same device kernels a bounce as before the gradient path
    came (``chip_smoke.py``'s phase main counts them)."""
    if not x.requires_grad:
        return torch.clamp(x, lo, hi)
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def _light_table(scene: SceneData):
    """Area-light table as one (L, 16) row per light — vertices 0:9,
    intensity 9:12, shape id 12 — so the NEE lookup is one gather."""
    lrows = scene.params[scene.light_shape.long()]          # (L, 9)
    lint = scene.emission[scene.light_shape.long()]         # (L, 3)
    lpack = torch.cat(
        [lrows, lint, scene.light_shape[:, None].to(torch.float32),
         torch.zeros((lrows.shape[0], 3), dtype=torch.float32,
                     device=lrows.device)], dim=1)
    return lpack, max(scene.num_lights, 1)


def _check_supported(settings: RenderSettings):
    """The forward drivers (:func:`render_queue`, the flat wavefront)
    refuse the gradient-only edge-aware NEE."""
    if settings.edge_aware_nee:
        raise NotImplementedError("edge-aware NEE is a gradient switch: "
                                  "render through integrator.render_pixels "
                                  "or trace_paths")


def _shade_core(scene: SceneData, settings: RenderSettings, light_tab,
                o, d, throughput, color, alive, hdb, absorb,
                slot0, ray_id, seed, t, sid, hit, packed_rows=None,
                photon_grid=None, prep=None):
    """Everything a bounce does after the scene trace except resolving
    the NEE occlusion query.

    ``slot0`` is the RNG slot base: a scalar under :func:`trace_paths`,
    a per-lane tensor under :func:`render_queue`.  ``photon_grid`` guides
    the light pick when the settings ask for PNEE.  ``prep`` is needed
    with ``settings.edge_aware_nee`` (the warp's occluders).

    Returns ``(carry', shadow_req)``: the updated ``(o, d, throughput,
    color, alive, hdb, absorb)`` and the pending NEE query (``None``
    without NEE): ``need``, ``p_from``, ``p_to``, ``light_sid`` and
    ``contrib`` (the RGB to add when unoccluded, zero on ``~need``
    lanes).  Resolve with :func:`_apply_shadow`.
    """
    eps = settings.epsilon
    lpack, n_lights = light_tab
    use_pnee = settings.render_type == RenderType.PNEE and photon_grid is not None

    shadow_req = None
    sid_c = torch.clamp(sid, min=0)
    # t is +inf on a miss; downstream math takes the sanitized value
    t_safe = torch.where(hit, t, 1.0)
    info = tr.hit_info(scene, o, d, t_safe, sid_c, packed=packed_rows)

    # Beer-Lambert absorption through the current medium
    seg = torch.where(hit, t, 0.0)
    throughput = throughput * torch.exp(-absorb * seg[..., None])

    hit_point = o + d * t_safe[..., None]
    kind = info["kind"]
    n = info["n"]

    is_emissive = kind == int(MatKind.EMISSIVE)
    is_refract = kind == int(MatKind.REFRACT)
    is_reflect = kind == int(MatKind.REFLECT)

    # --- miss: background, path dies ------------------------------------
    miss = alive & ~hit
    color = color + torch.where(miss[..., None],
                                throughput * scene.background[None, :], 0.0)

    # --- emissive hit -----------------------------------------------------
    emis_hit = alive & hit & is_emissive
    add_emis = emis_hit & ~hdb if (settings.is_debug_photons or settings.has_nee) \
        else emis_hit
    color = color + torch.where(add_emis[..., None],
                                throughput * info["emission"], 0.0)

    # --- scatter (non-emissive hits) --------------------------------------
    scat = alive & hit & ~is_emissive
    wo = -d

    r1, r2, _ = rnglib.uniform3(seed, ray_id, slot0 + _SLOT_HEMI)
    um, ur, _ = rnglib.uniform3(seed, ray_id, slot0 + _SLOT_MAT)

    # diffuse branch
    wi_d, pdf_d = sample_cosine_hemisphere(n, r1, r2)
    cos_d = vm.dot(wi_d, n)
    f_d = info["albedo"] / math.pi
    contrib_d = f_d * (cos_d / torch.clamp(pdf_d, min=1e-12))[..., None]

    # mirror branch
    wi_m = vm.reflect(wo, n)
    contrib_m = info["albedo"]

    # refract branch: Fresnel-weighted reflect/transmit + Beer
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
    contrib_r = torch.ones_like(contrib_m)   # energy split by the sampling

    # choose the branch per material kind
    mirror_now = is_reflect & (um < info["extra"][:, EXTRA_REFLECTIVITY])
    specular = mirror_now | is_refract
    wi = torch.where(is_refract[..., None], wi_r,
                     torch.where(mirror_now[..., None], wi_m, wi_d))
    contrib = torch.where(is_refract[..., None], contrib_r,
                          torch.where(mirror_now[..., None], contrib_m,
                                      contrib_d))

    new_tp = throughput * contrib
    # medium tracking for refraction
    absorb_in = info["extra"][:, EXTRA_ABSORB_R:EXTRA_ABSORB_B + 1]
    entering_medium = is_refract & ~take_refl_r & ent
    exiting_medium = is_refract & ~take_refl_r & ~ent
    new_absorb = torch.where(entering_medium[..., None], absorb_in,
                             torch.where(exiting_medium[..., None], 0.0, absorb))

    diffuse_now = scat & ~specular
    new_hdb = hdb | diffuse_now

    # --- NEE from diffuse scatters ----------------------------------------
    if settings.has_nee and scene.num_lights > 0:
        if use_pnee:
            from wasm_pathtracer_tpu_torch.ops import photon as ph
            lid, light_chance = ph.sample(photon_grid, hit_point, seed, ray_id,
                                          slot0 + _SLOT_PNEE)
            light_chance = torch.clamp(light_chance, min=1e-12)
        else:
            u_pick = rnglib.uniform3(seed, ray_id, slot0 + _SLOT_LIGHT_PICK)
            lid = torch.clamp((u_pick[0] * n_lights).to(torch.int32),
                              max=n_lights - 1)
            light_chance = max(1.0 / n_lights, 1e-12)

        lrow = lpack[lid.long()]                      # (R, 16) — one gather
        lv = lrow[:, 0:9]
        intensity = lrow[:, 9:12]
        light_sid = lrow[:, 12].to(torch.int64)
        l0, l1, l2 = lv[:, 0:3], lv[:, 3:6], lv[:, 6:9]
        s1, s2, s3 = rnglib.uniform3(seed, ray_id, slot0 + _SLOT_LIGHT_POINT)
        j_nee = None
        if settings.edge_aware_nee:
            # value-preserving warp of the light-sample uniforms: light
            # geometry gradients gain the shadow-boundary flux
            from wasm_pathtracer_tpu_torch.ops import edges
            s1, s2, j_nee = edges.nee_warp(
                prep, scene, lv, light_sid, hit_point, s1, s2,
                n_aux=settings.edge_nee_aux, radius=settings.edge_nee_radius)
        p_l, n_l = isx.triangle_pick_random(l0, l1, l2, s1, s2, s3)

        to_l = p_l - hit_point
        dis_sq = torch.clamp(vm.length_sq(to_l), min=1e-12)
        to_l = to_l / vm.sqrt(dis_sq)[..., None]
        cos_i_l = vm.dot(to_l, n)
        cos_o_l = vm.dot(-to_l, n_l)
        front = (cos_i_l > 0.0) & (cos_o_l > 0.0)

        nee_mask = diffuse_now & front
        if settings.is_debug_photons:
            # light-selection debug render: the picked light, unshadowed
            color = color + torch.where(nee_mask[..., None], new_tp * intensity, 0.0)
        else:
            area = isx.triangle_area(l0, l1, l2)
            solid_angle = area * cos_o_l / dis_sq
            w = solid_angle * cos_i_l / light_chance
            if j_nee is not None:
                w = w * j_nee   # the warp's Jacobian (value 1)
            # zero w on masked lanes before the product, so that the
            # backward pass never meets 0 * a non-finite value
            w = torch.where(nee_mask, w, 0.0)
            shadow_req = dict(
                need=nee_mask,
                p_from=hit_point,
                p_to=p_l,
                light_sid=light_sid,
                contrib=new_tp * intensity * w[..., None],
            )

    # --- Russian roulette --------------------------------------------------
    u_rr = rnglib.uniform3(seed, ray_id, slot0 + _SLOT_RR)[0]
    keep = _clip(torch.amax(new_tp, dim=-1), settings.rr_clamp_min,
                 settings.rr_clamp_max)
    survive = u_rr < keep
    new_tp = new_tp / keep[..., None]

    new_alive = scat & survive
    o2 = hit_point + wi * eps
    # keep rays unchanged on dead lanes (their values are masked anyway)
    scat3 = scat[..., None]
    o = torch.where(scat3, o2, o)
    d = torch.where(scat3, wi, d)
    throughput = torch.where(scat3, new_tp, throughput)
    absorb = torch.where(scat3, new_absorb, absorb)
    hdb = torch.where(scat, new_hdb, hdb)
    return (o, d, throughput, color, new_alive, hdb, absorb), shadow_req


def _apply_shadow(color, shadow_req, occluded):
    """Fold a resolved NEE occlusion query into the radiance (add only
    when the shadow ray is clear)."""
    add = shadow_req["need"] & ~occluded
    return color + torch.where(add[..., None], shadow_req["contrib"], 0.0)


def _bounce_step(prep: tr.ScenePrep, scene: SceneData,
                 settings: RenderSettings, light_tab,
                 o, d, throughput, color, alive, hdb, absorb,
                 slot0, ray_id, seed, packed_rows=None, photon_grid=None):
    """One lockstep bounce: scene trace, :func:`_shade_core`, and the NEE
    shadow ray resolved inline.  Returns the updated carry plus this
    step's per-lane primitive-test count (masked by ``alive``).

    On an autograd path ``trace.trace_scene`` re-evaluates the winners'
    distances; the occlusion verdict is discrete and taken on detached
    rays."""
    t, sid, hit, c = tr.trace_scene(prep, scene, o, d)
    step_cost = torch.where(alive, c, 0)
    carry, shadow_req = _shade_core(
        scene, settings, light_tab, o, d, throughput, color, alive, hdb,
        absorb, slot0, ray_id, seed, t, sid, hit, packed_rows=packed_rows,
        photon_grid=photon_grid, prep=prep)
    if shadow_req is not None:
        o2, d2, tp2, color2, alive2, hdb2, absorb2 = carry
        with torch.no_grad():
            occluded, sc = tr.shadow_ray(prep, scene,
                                         shadow_req["p_from"].detach(),
                                         shadow_req["p_to"].detach(),
                                         shadow_req["light_sid"],
                                         settings.epsilon)
        step_cost = step_cost + torch.where(shadow_req["need"], sc, 0)
        color2 = _apply_shadow(color2, shadow_req, occluded)
        carry = (o2, d2, tp2, color2, alive2, hdb2, absorb2)
    return carry, step_cost


def trace_paths(prep: tr.ScenePrep, scene: SceneData,
                settings: RenderSettings, o, d, ray_id, seed, photon_grid=None):
    """Trace a batch of paths to radiance, all lanes in lockstep; the
    batch stops once every path has terminated.

    The loop breaks on the host, so it has no fixed trip count; that is
    reverse-differentiable in PyTorch as it is (the JAX package needs
    its scan form, ``early_exit=False``, for gradients), and the bounces
    a dead batch skips add nothing.  With
    ``settings.checkpoint_bounces`` on an autograd path each bounce runs
    under ``torch.utils.checkpoint``: the backward pass recomputes it,
    its kernels included, from the carry; the pcg3d streams are keyed by
    slot, so the recomputation draws the same numbers.

    Args:
      o, d: (R, 3) primary ray origins/directions.
      ray_id: (R,) integer unique path ids (pixel id is fine).
      seed: uint32 value folding session seed + sample round.
      photon_grid: optional ``ops.photon.PhotonGrid`` for PNEE.

    Returns (color (R, 3), cost (R,) int64 primitive tests).
    """
    R = o.shape[0]
    dev = o.device
    light_tab = _light_table(scene)
    packed_rows = tr.pack_hit_rows(scene)
    tp = torch.ones((R, 3), dtype=torch.float32, device=dev)
    color = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    hdb = torch.zeros((R,), dtype=torch.bool, device=dev)
    absorb = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    cost = torch.zeros((R,), dtype=torch.int64, device=dev)

    def bounce(b, *carry):
        return _bounce_step(prep, scene, settings, light_tab, *carry,
                            b * _SLOTS_PER_BOUNCE, ray_id, seed,
                            packed_rows=packed_rows, photon_grid=photon_grid)

    remat = settings.checkpoint_bounces and torch.is_grad_enabled() and (
        o.requires_grad or d.requires_grad or packed_rows.requires_grad)
    for b in range(settings.max_bounces):
        if not bool(alive.any()):
            break
        carry = (o, d, tp, color, alive, hdb, absorb)
        if remat:
            carry, step_cost = torch.utils.checkpoint.checkpoint(
                bounce, b, *carry, use_reentrant=False,
                preserve_rng_state=False)
        else:
            carry, step_cost = bounce(b, *carry)
        o, d, tp, color, alive, hdb, absorb = carry
        cost = cost + step_cost
    return color, cost


def render_pixels(prep, scene, settings: RenderSettings, camera: Camera,
                  px, py, width: int, height: int, seed, photon_grid=None):
    """One radiance sample for each pixel in (px, py), jittered within
    the pixel.  Returns (color (R, 3), cost (R,))."""
    ray_id = py.long() * width + px.long()
    jx, jy, _ = rnglib.uniform3(seed, ray_id, SLOT_JITTER)
    o, d = primary_rays(camera, px, py, jx, jy, width, height,
                        settings.screen_z)
    return trace_paths(prep, scene, settings, o, d, ray_id, seed,
                       photon_grid=photon_grid)


def render_queue(prep, scene, settings: RenderSettings, camera: Camera,
                 pix_queue, width: int, height: int, seed, n_lanes: int,
                 photon_grid=None, rid_base=0, return_iters=False):
    """Persistent wavefront: path-trace every sample in ``pix_queue``.

    Each of ``n_lanes`` lanes owns one in-flight path; when a path
    terminates (miss, emissive absorption, Russian roulette, bounce cap)
    the lane adds its radiance to the frame and claims the next queue
    slot.  Path ``i``'s random stream is keyed by ``ray_id = rid_base +
    i`` (its queue index), so per-path radiance is a pure function of
    (queue, seed), independent of the lane count.

    Claims follow the JAX package exactly: finished lanes claim the next
    contiguous queue slots in lane order (``cumsum`` ranks), while they
    have lane-ring capacity left (``K`` paths per lane).  Where the JAX
    version records finished paths in that ring and scatters once after
    the loop, this one adds them to the frame as they finish
    (``index_add_``), so float sums may be taken in another order.

    The loop condition reads ``alive.any()`` on the host once per
    iteration; nothing else in the loop waits for the device.

    Args:
      pix_queue: (S,) integer pixel ids (y * width + x).
      n_lanes: wavefront width.
      photon_grid: optional ``ops.photon.PhotonGrid`` for PNEE.
      rid_base: offset added to the queue index when keying each path's
        RNG stream (decorrelates the session's two halves).

    Returns (color_sum (H*W, 3), n_samples (H*W,) int32, lane_cost
    (n_lanes,) int64 per-lane primitive-test counts), plus the number of
    loop iterations with ``return_iters``.
    """
    _check_supported(settings)
    dev = pix_queue.device
    S = pix_queue.shape[0]
    B = n_lanes
    HW = width * height
    # row HW of the frame collects the lanes that finish nothing
    acc = torch.zeros((HW + 1, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros((HW + 1,), dtype=torch.int32, device=dev)
    lane_cost = torch.zeros((B,), dtype=torch.int64, device=dev)

    def _ret(its):
        out = (acc[:HW], cnt[:HW], lane_cost)
        return out + (its,) if return_iters else out

    if S == 0:
        return _ret(0)
    pix_queue = pix_queue.to(torch.int64)
    if settings.max_bounces == 0:
        # zero bounces contribute nothing, but every sample is counted
        cnt.index_add_(0, pix_queue, torch.ones_like(pix_queue, dtype=torch.int32))
        return _ret(0)

    light_tab = _light_table(scene)
    packed_rows = tr.pack_hit_rows(scene)
    # lane-ring capacity of the JAX version: bounds how many paths one
    # lane may record, and so which lanes may claim
    K = -(-S // B)
    K += max(2, K // 2)

    def ray_of(pid, sidx):
        rid = (rid_base + sidx) & 0xFFFFFFFF
        jx, jy, _ = rnglib.uniform3(seed, rid, SLOT_JITTER)
        o, d = primary_rays(camera, pid % width, pid // width, jx, jy,
                            width, height, settings.screen_z)
        return rid, o.contiguous(), d

    # queue padded with the HW drop sentinel: a claim past the end reads it
    pixq_pad = torch.cat([pix_queue, torch.full((B,), HW, dtype=torch.int64,
                                                device=dev)])
    lanes = torch.arange(B, dtype=torch.int64, device=dev)
    pid = pix_queue[torch.clamp(lanes, max=S - 1)]
    rid, o, d = ray_of(pid, lanes)
    issued = torch.tensor(min(B, S), dtype=torch.int64, device=dev)
    tp = torch.ones((B, 3), dtype=torch.float32, device=dev)
    col = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    alive = lanes < S
    hdb = torch.zeros((B,), dtype=torch.bool, device=dev)
    absorb = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    bounce = torch.zeros((B,), dtype=torch.int64, device=dev)
    k_lane = torch.zeros((B,), dtype=torch.int64, device=dev)
    it = 0

    while bool(alive.any()):
        was = alive
        (o, d, tp, col, alive, hdb, absorb), step_cost = _bounce_step(
            prep, scene, settings, light_tab, o, d, tp, col, was, hdb,
            absorb, bounce * _SLOTS_PER_BOUNCE, rid, seed,
            packed_rows=packed_rows, photon_grid=photon_grid)
        lane_cost += step_cost
        bounce = bounce + 1

        # a path is done when it died this step or hit the bounce cap
        done = was & (~alive | (bounce >= settings.max_bounces))
        alive = alive & ~done

        # add finished paths to the frame
        dst = torch.where(done, pid, HW)
        acc.index_add_(0, dst, col)
        cnt.index_add_(0, dst, done.to(torch.int32))
        k_lane = k_lane + done

        # regenerate: finished lanes with capacity left claim the next
        # queue slots in lane order
        claimable = done & (k_lane < K)
        ranks = torch.cumsum(claimable, 0) - 1
        sidx = issued + ranks
        can = claimable & (sidx < S)
        # the JAX version's dynamic slice of B entries at the claim
        # cursor, then a rank-indexed pick, as one gather
        pick = torch.clamp(issued, max=S) + torch.clamp(ranks, 0, B - 1)
        pid_n = torch.clamp(pixq_pad[pick], max=HW)
        rid_n, o_n, d_n = ray_of(pid_n, sidx)
        issued = torch.clamp(issued + ranks[-1] + 1, max=S)

        can3 = can[:, None]
        o = torch.where(can3, o_n, o)
        d = torch.where(can3, d_n, d)
        tp = torch.where(can3, 1.0, tp)
        col = torch.where(can3, 0.0, col)
        alive = alive | can
        hdb = hdb & ~can
        absorb = torch.where(can3, 0.0, absorb)
        bounce = torch.where(can, 0, bounce)
        pid = torch.where(can, pid_n, pid)
        rid = torch.where(can, rid_n, rid)
        it += 1
    return _ret(it)


def trace_depth(prep, scene, o, d):
    """Depth render: (t, +inf on a miss; cost)."""
    t, _, hit, cost = tr.trace_scene(prep, scene, o, d)
    return torch.where(hit, t, torch.inf), cost


def trace_bvh_cost(prep, scene, o, d):
    """Cost render: primitive and node tests per primary ray."""
    return tr.trace_scene(prep, scene, o, d)[3]
