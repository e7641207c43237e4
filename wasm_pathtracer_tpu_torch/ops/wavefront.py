"""Flattened persistent wavefront: cluster traversal folded into the path
loop (``wasm_pathtracer_tpu.ops.wavefront``).

:func:`ops.integrator.render_queue` traces every bounce with
``trace_scene``, whose cluster traversal is itself a lockstep loop: all
lanes wait for the slowest ray's probe sequence.  Here each lane carries
a small state machine and every loop iteration advances every live lane
by one step:

  SCAN   a fresh trace: the nearest hit over the dense remainder of the
         scene (K3's dense half, or the scene kernel K1 beside K6);
  PROBE  up to two clusters, the next two in ascending (entry, id) order
         after the lane's lex cursor ``(skip_e, skip_c)``, from one
         select pass (K3 or K6) and one probe launch (K4); the bound is
         tightened between the two rounds, and a shadow query is also
         bounded by its light's distance;
  SHADE  a finished primary trace runs the estimator step
         (``integrator._shade_core``), which may leave a pending NEE
         shadow query: the lane then traces that ray through the same
         SCAN/PROBE steps and resolves the occlusion when it finishes;
  REGEN  a finished path adds its radiance to the frame (``index_add_``)
         and the lane claims the next queue slot, as in ``render_queue``.

The visit order, the bounds, the claim order and the RNG keying are the
JAX loop's, so per-path radiance equals ``render_queue``'s on the same
queue.  The TPU version's lane ring, winner-row carry and material
palette were there to avoid scatters and gathers on the TPU; this loop
splats finished paths as they finish and shades from the shape's packed
row.  The loop condition reads ``live.any()`` on the host once per
iteration.
"""

from __future__ import annotations

import dataclasses

import torch

from wasm_pathtracer_tpu_torch.config import RenderSettings
from wasm_pathtracer_tpu_torch.models.camera import Camera, primary_rays
from wasm_pathtracer_tpu_torch.ops import integrator as itg
from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
from wasm_pathtracer_tpu_torch.ops import trace as tr
from wasm_pathtracer_tpu_torch.utils import rng as rnglib
from wasm_pathtracer_tpu_torch.utils import vecmath as vm


def render_queue_flat(prep: tr.ScenePrep, scene, settings: RenderSettings,
                      camera: Camera, pix_queue, width: int, height: int, seed,
                      n_lanes: int, photon_grid=None, rid_base=0,
                      return_iters: bool = False):
    """Persistent wavefront with flattened cluster traversal.

    The contract of :func:`ops.integrator.render_queue` (same queue
    semantics, RNG keying and returns); ``prep`` must carry a cluster
    structure.

    Returns (color_sum (H*W, 3), n_samples (H*W,) int32, lane_cost
    (n_lanes,) int64), plus the number of loop iterations with
    ``return_iters``.
    """
    if prep.cluster is None:
        raise ValueError("render_queue_flat needs a prep with clusters "
                         "(ops.bvh.attach_clusters)")
    itg._check_supported(settings)
    cs = prep.cluster
    dev = pix_queue.device
    S = pix_queue.shape[0]
    B = n_lanes
    G = cs.group
    HW = width * height
    # row HW of the frame collects the lanes that finish nothing
    acc = torch.zeros((HW + 1, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros((HW + 1,), dtype=torch.int32, device=dev)
    cost = torch.zeros((B,), dtype=torch.int64, device=dev)

    def _ret(its):
        out = (acc[:HW], cnt[:HW], cost)
        return out + (its,) if return_iters else out

    if S == 0:
        return _ret(0)
    pix_queue = pix_queue.to(torch.int64)
    if settings.max_bounces == 0:
        cnt.index_add_(0, pix_queue, torch.ones_like(pix_queue, dtype=torch.int32))
        return _ret(0)

    light_tab = itg._light_table(scene)
    packed_rows = tr.pack_hit_rows(scene)
    n_dense = sum(prep.tables.counts)
    # K3 folds a dense remainder of <= 64 shapes into the select; a larger
    # one runs through the scene kernel beside K6, and none needs no scan
    fused_scan = pk.dense_scan_ok(prep)
    prep_dense = dataclasses.replace(prep, cluster=None)
    eps = settings.epsilon
    f32, i64 = torch.float32, torch.int64
    inf = torch.inf
    # the JAX version's lane-ring capacity: bounds how many paths one lane
    # may finish, and so which lanes may claim
    K = -(-S // B)
    K += max(2, K // 2)

    def ray_of(pid, sidx):
        rid = (rid_base + sidx) & 0xFFFFFFFF
        jx, jy, _ = rnglib.uniform3(seed, rid, itg.SLOT_JITTER)
        o, d = primary_rays(camera, pid % width, pid // width, jx, jy,
                            width, height, settings.screen_z)
        return rid, o.contiguous(), d.contiguous()

    # queue padded with the HW drop sentinel: a claim past the end reads it
    pixq_pad = torch.cat([pix_queue, torch.full((B,), HW, dtype=i64, device=dev)])
    lanes = torch.arange(B, dtype=i64, device=dev)
    pid = pix_queue[torch.clamp(lanes, max=S - 1)]
    rid, o, d = ray_of(pid, lanes)
    issued = torch.tensor(min(B, S), dtype=i64, device=dev)
    live = lanes < S
    # path registers
    tp = torch.ones((B, 3), dtype=f32, device=dev)
    col = torch.zeros((B, 3), dtype=f32, device=dev)
    hdb = torch.zeros((B,), dtype=torch.bool, device=dev)
    absorb = torch.zeros((B, 3), dtype=f32, device=dev)
    bounce = torch.zeros((B,), dtype=i64, device=dev)
    k_lane = torch.zeros((B,), dtype=i64, device=dev)
    # trace registers: the ray being traced, its best hit, the lex cursor
    tr_o, tr_d = o, d
    shadow = torch.zeros((B,), dtype=torch.bool, device=dev)
    t_best = torch.full((B,), inf, dtype=f32, device=dev)
    sid_best = torch.full((B,), -1, dtype=i64, device=dev)
    skip_e = torch.full((B,), -inf, dtype=f32, device=dev)
    skip_c = torch.full((B,), -1, dtype=torch.int32, device=dev)
    need_scan = live.clone()
    # the pending NEE query, set at shade and read at resolve
    pend_contrib = torch.zeros((B, 3), dtype=f32, device=dev)
    pend_dist = torch.zeros((B,), dtype=f32, device=dev)
    pend_lsid = torch.zeros((B,), dtype=i64, device=dev)
    pend_cont = torch.zeros((B,), dtype=torch.bool, device=dev)
    it = 0

    while bool(live.any()):
        # ---- SCAN: fresh traces reset the cursor and take the dense hit
        scan = live & need_scan
        skip_e = torch.where(scan, -inf, skip_e)
        skip_c = torch.where(scan, -1, skip_c)
        if fused_scan:
            e_cur, c_cur, e_b, c_b, e_aft, t_d, sid_d = pk.select_scan(
                cs, prep, tr_o, tr_d, skip_e, skip_c)
            c_d = n_dense
        else:
            e_cur, c_cur, e_b, c_b, e_aft = pk.select_blocks(
                cs, tr_o, tr_d, skip_e, skip_c)
            if n_dense:
                t_d, sid_d, _, c_d = tr.trace_scene(prep_dense, scene, tr_o, tr_d)
            else:
                t_d, sid_d, c_d = inf, -1, 0
        t_best = torch.where(scan, t_d, t_best)
        sid_best = torch.where(scan, sid_d, sid_best)
        cost += torch.where(scan, c_d, 0)

        # ---- PROBE x2: the next two clusters in (entry, id) order
        bound = torch.where(shadow, torch.minimum(t_best, pend_dist), t_best)
        probing = live & (e_cur < bound)
        skip_e = torch.where(probing, e_cur, skip_e)
        skip_c = torch.where(probing, c_cur, skip_c)
        t1, s1, t2, s2 = pk.probe_pair(cs, tr_o, tr_d, c_cur, c_b)
        better = probing & (t1 < t_best)
        t_best = torch.where(better, t1, t_best)
        sid_best = torch.where(better, s1, sid_best)
        cost += torch.where(probing, G, 0)
        # the second round against the bound tightened by the first
        bound = torch.where(shadow, torch.minimum(t_best, pend_dist), t_best)
        probing2 = probing & (e_b < bound)
        skip_e = torch.where(probing2, e_b, skip_e)
        skip_c = torch.where(probing2, c_b, skip_c)
        better2 = probing2 & (t2 < t_best)
        t_best = torch.where(better2, t2, t_best)
        sid_best = torch.where(better2, s2, sid_best)
        cost += torch.where(probing2, G, 0)

        # ---- completion: the next candidate lies beyond the bound, or a
        # shadow query already found a blocker before its light
        e_next = torch.where(probing2, e_aft, torch.where(probing, e_b, e_cur))
        bound = torch.where(shadow, torch.minimum(t_best, pend_dist), t_best)
        occluded = torch.isfinite(t_best) & (t_best < pend_dist) \
            & (sid_best != pend_lsid)
        done = live & ((e_next >= bound) | (shadow & occluded))

        # ---- RESOLVE finished shadow queries
        resolve = done & shadow
        col = col + torch.where((resolve & ~occluded)[:, None], pend_contrib, 0.0)

        # ---- SHADE finished primary traces
        shade = done & ~shadow
        (o_n, d_n, tp_n, col, alive_n, hdb_n, absorb_n), req = itg._shade_core(
            scene, settings, light_tab, tr_o, tr_d, tp, col, shade, hdb, absorb,
            bounce * itg._SLOTS_PER_BOUNCE, rid, seed, t_best, sid_best,
            torch.isfinite(t_best), packed_rows=packed_rows,
            photon_grid=photon_grid)
        # adopt the estimator's updates on shade lanes only: elsewhere
        # (o_n, d_n) is the ray in flight, and the throughput update is
        # only meaningful where a hit was shaded
        sh3 = shade[:, None]
        o = torch.where(sh3, o_n, o)
        d = torch.where(sh3, d_n, d)
        tp = torch.where(sh3, tp_n, tp)
        absorb = torch.where(sh3, absorb_n, absorb)
        hdb = torch.where(shade, hdb_n, hdb)
        bounce = bounce + shade
        cont_shade = alive_n & (bounce < settings.max_bounces)

        if req is not None:
            pend = shade & req["need"]
            to_l = req["p_to"] - req["p_from"]
            dir_len = vm.length(to_l)
            d_sh = to_l / torch.clamp(dir_len, min=1e-30)[..., None]
            o_sh = req["p_from"] + d_sh * eps
            pend_contrib = torch.where(pend[:, None], req["contrib"], pend_contrib)
            pend_dist = torch.where(pend, dir_len, pend_dist)
            pend_lsid = torch.where(pend, req["light_sid"], pend_lsid)
        else:
            pend = torch.zeros_like(shade)
            o_sh, d_sh = tr_o, tr_d
        cont_prev = pend_cont
        pend_cont = torch.where(shade, cont_shade, pend_cont)

        # ---- FINALIZE: the bounce is complete (shadow resolved or none)
        fin = resolve | (shade & ~pend)
        cont = fin & torch.where(shadow, cont_prev, cont_shade)
        end = fin & ~cont
        acc.index_add_(0, torch.where(end, pid, HW), col)
        cnt.index_add_(0, torch.where(end, pid, HW), end.to(torch.int32))
        k_lane = k_lane + end

        # ---- REGEN: finished lanes with capacity left claim the next
        # queue slots in lane order
        claimable = end & (k_lane < K)
        ranks = torch.cumsum(claimable, 0) - 1
        sidx = issued + ranks
        can = claimable & (sidx < S)
        pick = torch.clamp(issued, max=S) + torch.clamp(ranks, 0, B - 1)
        pid_n = torch.clamp(pixq_pad[pick], max=HW)
        rid_n, o_p, d_p = ray_of(pid_n, sidx)
        issued = torch.clamp(issued + ranks[-1] + 1, max=S)

        # next traced ray: shadow query > new primary > next bounce
        can3, cont3 = can[:, None], cont[:, None]
        tr_o = torch.where(pend[:, None], o_sh,
                           torch.where(can3, o_p, torch.where(cont3, o, tr_o)))
        tr_d = torch.where(pend[:, None], d_sh,
                           torch.where(can3, d_p, torch.where(cont3, d, tr_d)))
        tr_o, tr_d = tr_o.contiguous(), tr_d.contiguous()
        start = pend | can | cont
        o = torch.where(can3, o_p, o)
        d = torch.where(can3, d_p, d)
        tp = torch.where(can3, 1.0, tp)
        col = torch.where(can3, 0.0, col)
        hdb = hdb & ~can
        absorb = torch.where(can3, 0.0, absorb)
        bounce = torch.where(can, 0, bounce)
        pid = torch.where(can, pid_n, pid)
        rid = torch.where(can, rid_n, rid)
        live = (live & ~end) | can
        shadow = torch.where(start, pend, shadow)
        need_scan = start
        it += 1
    return _ret(it)
