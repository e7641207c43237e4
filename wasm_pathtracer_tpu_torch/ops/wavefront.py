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
  REGEN  a finished path adds its radiance to the frame and the lane
         claims the next queue slot, as in ``render_queue`` and by the
         same code (``ops/regen.py``; one launch of the regen kernel an
         iteration on the card).

The visit order, the bounds, the claim order and the RNG keying are the
JAX loop's, so per-path radiance equals ``render_queue``'s on the same
queue.  The TPU version's lane ring, winner-row carry and material
palette were there to avoid scatters and gathers on the TPU; this loop
splats finished paths as they finish and shades from the shape's packed
row.  The loop itself is ``render_queue``'s, ``integrator._run_queue``;
this module holds the flat route's registers and its iteration.
"""

from __future__ import annotations

import dataclasses

import torch

from wasm_pathtracer_tpu_torch.config import RenderSettings
from wasm_pathtracer_tpu_torch.models.camera import Camera
from wasm_pathtracer_tpu_torch.ops import integrator as itg
from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
from wasm_pathtracer_tpu_torch.ops import regen as rg
from wasm_pathtracer_tpu_torch.ops import trace as tr
from wasm_pathtracer_tpu_torch.utils import vecmath as vm
from wasm_pathtracer_tpu_torch.utils.spans import span


def render_queue_flat(prep: tr.ScenePrep, scene, settings: RenderSettings,
                      camera: Camera, pix_queue, width: int, height: int, seed,
                      n_lanes: int, photon_grid=None, rid_base=0,
                      return_iters: bool = False, iters_out=None):
    """Persistent wavefront with flattened cluster traversal.

    The contract of :func:`ops.integrator.render_queue` (same queue
    semantics, RNG keying, arguments and returns); ``prep`` must carry a
    cluster structure.
    """
    if prep.cluster is None:
        raise ValueError("render_queue_flat needs a prep with clusters "
                         "(ops.bvh.attach_clusters)")
    cs = prep.cluster
    G = cs.group
    n_dense = sum(prep.tables.counts)
    # K3 folds a dense remainder of <= 64 shapes into the select; a larger
    # one runs through the scene kernel beside K6, and none needs no scan
    fused_scan = pk.dense_scan_ok(prep)
    prep_dense = dataclasses.replace(prep, cluster=None)
    eps = settings.epsilon
    f32, i64 = torch.float32, torch.int64
    inf = torch.inf

    def init(ln, c):
        B, dev = ln.pid.shape[0], ln.pid.device
        # trace registers: the ray being traced (its own copy: the regen kernel
        # writes registers in place), its best hit, the lex cursor
        ln.tr_o, ln.tr_d = ln.o.clone(), ln.d.clone()
        ln.shadow = torch.zeros((B,), dtype=torch.bool, device=dev)
        ln.need_scan = ln.alive.clone()
        c.t_best = torch.full((B,), inf, dtype=f32, device=dev)
        c.sid_best = torch.full((B,), -1, dtype=i64, device=dev)
        c.skip_e = torch.full((B,), -inf, dtype=f32, device=dev)
        c.skip_c = torch.full((B,), -1, dtype=torch.int32, device=dev)
        # the pending NEE query, set at shade and read at resolve
        c.pend_contrib = torch.zeros((B, 3), dtype=f32, device=dev)
        c.pend_dist = torch.zeros((B,), dtype=f32, device=dev)
        c.pend_lsid = torch.zeros((B,), dtype=i64, device=dev)
        c.pend_cont = torch.zeros((B,), dtype=torch.bool, device=dev)

    def step(q, ln, c, light_tab, packed_rows):
        live, shadow, tr_o, tr_d = ln.alive, ln.shadow, ln.tr_o, ln.tr_d
        with span("trace"):
            # ---- SCAN: fresh traces reset the cursor and take the dense hit
            scan = live & ln.need_scan
            c.skip_e = torch.where(scan, -inf, c.skip_e)
            c.skip_c = torch.where(scan, -1, c.skip_c)
            if fused_scan:
                e_cur, c_cur, e_b, c_b, e_aft, t_d, sid_d = pk.select_scan(
                    cs, prep, tr_o, tr_d, c.skip_e, c.skip_c)
                c_d = n_dense
            else:
                e_cur, c_cur, e_b, c_b, e_aft = pk.select_blocks(
                    cs, tr_o, tr_d, c.skip_e, c.skip_c)
                if n_dense:
                    t_d, sid_d, _, c_d = tr.trace_scene(prep_dense, scene, tr_o, tr_d)
                else:
                    t_d, sid_d, c_d = inf, -1, 0
            c.t_best = torch.where(scan, t_d, c.t_best)
            c.sid_best = torch.where(scan, sid_d, c.sid_best)
            c.cost += torch.where(scan, c_d, 0)

            # ---- PROBE x2: the next two clusters in (entry, id) order
            bound = torch.where(shadow, torch.minimum(c.t_best, c.pend_dist), c.t_best)
            probing = live & (e_cur < bound)
            c.skip_e = torch.where(probing, e_cur, c.skip_e)
            c.skip_c = torch.where(probing, c_cur, c.skip_c)
            t1, s1, t2, s2 = pk.probe_pair(cs, tr_o, tr_d, c_cur, c_b)
            better = probing & (t1 < c.t_best)
            c.t_best = torch.where(better, t1, c.t_best)
            c.sid_best = torch.where(better, s1, c.sid_best)
            c.cost += torch.where(probing, G, 0)
            # the second round against the bound tightened by the first
            bound = torch.where(shadow, torch.minimum(c.t_best, c.pend_dist), c.t_best)
            probing2 = probing & (e_b < bound)
            c.skip_e = torch.where(probing2, e_b, c.skip_e)
            c.skip_c = torch.where(probing2, c_b, c.skip_c)
            better2 = probing2 & (t2 < c.t_best)
            c.t_best = torch.where(better2, t2, c.t_best)
            c.sid_best = torch.where(better2, s2, c.sid_best)
            c.cost += torch.where(probing2, G, 0)

            # ---- completion: the next candidate lies beyond the bound, or a
            # shadow query already found a blocker before its light
            e_next = torch.where(probing2, e_aft, torch.where(probing, e_b, e_cur))
            bound = torch.where(shadow, torch.minimum(c.t_best, c.pend_dist), c.t_best)
            occluded = torch.isfinite(c.t_best) & (c.t_best < c.pend_dist) \
                & (c.sid_best != c.pend_lsid)
            done = live & ((e_next >= bound) | (shadow & occluded))

        with span("shade"):
            # ---- RESOLVE finished shadow queries
            resolve = done & shadow
            col = ln.col + torch.where((resolve & ~occluded)[:, None], c.pend_contrib, 0.0)

            # ---- SHADE finished primary traces
            shade = done & ~shadow
            (o_n, d_n, tp_n, ln.col, alive_n, hdb_n, absorb_n), req = itg._shade_core(
                scene, settings, light_tab, tr_o, tr_d, ln.tp, col, shade, ln.hdb,
                ln.absorb, ln.bounce * itg._SLOTS_PER_BOUNCE, ln.rid, seed, c.t_best,
                c.sid_best, torch.isfinite(c.t_best), packed_rows=packed_rows,
                photon_grid=photon_grid)
            # adopt the estimator's updates on shade lanes only: elsewhere
            # (o_n, d_n) is the ray in flight, and the throughput update is
            # only meaningful where a hit was shaded
            sh3 = shade[:, None]
            ln.o = torch.where(sh3, o_n, ln.o)
            ln.d = torch.where(sh3, d_n, ln.d)
            ln.tp = torch.where(sh3, tp_n, ln.tp)
            ln.absorb = torch.where(sh3, absorb_n, ln.absorb)
            ln.hdb = torch.where(shade, hdb_n, ln.hdb)
            ln.bounce = ln.bounce + shade
            cont_shade = alive_n & (ln.bounce < settings.max_bounces)

            if req is not None:
                pend = shade & req["need"]
                to_l = req["p_to"] - req["p_from"]
                dir_len = vm.length(to_l)
                d_sh = to_l / torch.clamp(dir_len, min=1e-30)[..., None]
                o_sh = req["p_from"] + d_sh * eps
                c.pend_contrib = torch.where(pend[:, None], req["contrib"], c.pend_contrib)
                c.pend_dist = torch.where(pend, dir_len, c.pend_dist)
                c.pend_lsid = torch.where(pend, req["light_sid"], c.pend_lsid)
            else:
                pend = torch.zeros_like(shade)
                o_sh, d_sh = tr_o, tr_d
            cont_prev = c.pend_cont
            c.pend_cont = torch.where(shade, cont_shade, c.pend_cont)
        return None, rg.Finalize(resolve, shade, pend, cont_prev, cont_shade, o_sh, d_sh)

    return itg._run_queue(step, scene, settings, camera, pix_queue, width, height, seed,
                          n_lanes, rid_base, return_iters, iters_out, init=init,
                          polls=not fused_scan and n_dense > 0 and tr.polls_host(prep_dense))
