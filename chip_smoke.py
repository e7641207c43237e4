#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's render paths once on one NVIDIA GPU.

    python3 chip_smoke.py [phase ...]

With no arguments every phase runs; naming phases (see ``PHASES``) runs
only those, and then the closing JSON lines are not printed.  Phases
(each raises on failure, so the script exits non-zero and never prints
its last line):

1. torch/CUDA versions and the card's name and power limit; no card, no
   run (there is no CPU fallback).
2. Build the CUDA kernels from ``wasm_pathtracer_tpu_torch/csrc`` with
   nvcc.
3. K1, the nearest-hit kernel, against its plain PyTorch version on the
   card: four scenes, 16,384 + 37 rays each (camera rays and random
   rays).  Hits agree on > 99.9% of rays, t agrees within rtol 1e-5 /
   atol 1e-4 where both hit, shape ids agree on > 99.5% (the tolerances
   of the JAX package's own kernel tests; the kernel contracts to FMA,
   the plain version does not; the kernel's triangles are staged and its
   torus square roots approximate).  Kernel and plain device times at
   16,384 rays on the museum (``cuda_ms``: CUDA events around a CUDA
   graph of the kernel's calls, and around eager calls of the plain
   version).  Then the same checks and times on the 16,384 rays K1 gets
   in the middle call of one run of the main path (phase 5's
   configuration; ``headline_inputs`` records them by wrapping the
   wrappers in this script), with the torus marches they need.
4. K2, the any-hit shadow kernel, on shadow rays from those rays' hits
   toward random light points.  From origins within the scenes'
   geometry, verdicts agree on > 99.9% of rays.  From far origins
   (grazing ground hits 50 to ~10^5 units away) every verdict that
   differs must be a float32 rounding tie: the plain version's own
   verdict flips when the origin moves by at most 16 ulp (and >= 98%
   agree).  Then the main path's own shadow rays, as for K1 (> 99.9%
   agree), with the occluded share and the primitive tests and marches
   a ray needs up to the one that decides it (where K2's lanes stop).
5. The main path at full width: the museum, 512x512, NEE, 8 bounces,
   S = 2,621,440 paths through ``render_queue`` with 16,384 lanes.
   Every sample is counted once, the radiance is finite, and each
   kernel's launch count equals the loop's iteration count.  Then a
   short run (S = 131,072) under ``torch.profiler``: device kernels per
   iteration and the device's busy share.
6. GPU against CPU: pcg3d streams bit-identical; then end to end, the
   museum at 32x32, 1 spp, 256 lanes, through the kernels on the card
   and the plain versions on the CPU: per-path radiance agrees (rtol
   1e-3, atol 2e-3) on >= 99% of paths.
7. The CLI renders the museum at 512x512 and writes a non-black PNG.
8. K6 and K3, the cluster selects, against their plain versions on three
   cluster sets: mesh70k (C = 550, plane remainder), a 300k-triangle
   cloud (C = 2,344, plane remainder) and the museum clustered with its
   lights left dense (mixed tori and aarects, 109-shape remainder; K6
   only).  16,384 + 37 camera and random rays, every other one with the
   lex cursor a first select pass gives it.  Entries agree in finiteness
   on > 99.9% of rays and within rtol 1e-5 / atol 1e-5; a cluster id may
   differ only where the two clusters' entries lie within that
   tolerance of each other (a rounding tie).  K3's dense hit follows the
   K1 rule.
9. K4 and K5, the probes, on the same sets and the clusters the select
   chose: hits agree on > 99.9% of rays, t within rtol 1e-5 / atol 1e-5,
   and a shape id may differ only where the two slots' distances tie
   within that tolerance.  Device times of K3-K6 and their plain
   versions at 16,384 rays at both table sizes (C = 550 and C = 2,344).
   Then K4 on the inputs of the middle call of one run of phase 10's
   path (``flat_inputs`` records them by wrapping the wrapper), under
   the same rule except that t may differ by the cancellation of a
   grazing or far bounce ray (``cancellation_atol``), timed.  Prints the
   probe's launch shape and the device memory of both cluster tables
   (the 11-row table and the staged triangles the probes read) at
   C = 550 and C = 2,344.
10. The mesh path at full width: mesh70k (70,314 triangles and a plane),
   512x512, NEE, 8 bounces, S = 524,288 paths through
   ``render_queue_flat`` with 16,384 lanes.  Every sample counted once,
   finite radiance, K3 and K4 launched once per iteration, K1, K2, K5
   and K6 never.
11. Mesh GPU against CPU: a 1,106-triangle mesh at 32x32, 1 spp, 256
   lanes, through the flat loop on the card and the plain versions on
   the CPU: sample counts equal, per-path radiance agrees (rtol 1e-3,
   atol 2e-3) on >= 99% of paths.
12. Lockstep against flat on the card: mesh70k at 64x64, 1 spp, through
   ``render_queue`` with the cluster prep (K1 and K5 in the lockstep
   cluster trace) and through ``render_queue_flat``: counts equal,
   >= 99% of paths agree, K5 launched.  Then the lockstep trace once
   more with ``unreduced_probe`` (K7 and a reduction outside the
   kernel): the same rounds, K7 launched as often as K5 was, paths agree.
13. The K6 path: the museum with its lights dense, 64x64, 1 spp, through
   ``render_queue_flat`` (K6 beside K1, then K4) against ``render_queue``
   without clusters: counts equal, >= 99% of paths agree, K6, K1 and K4
   launched once per iteration.
14. The CLI renders scene 5 (the 100k-triangle cloud) at 512x512 through
   the session's flat wavefront and writes a non-black PNG.
15. K8, the dense triangle sweep, against its plain version (runs before
   phase 8): mesh70k's 70,314 triangles and cloud300k's 300,002, 16,384 +
   37 camera and random rays each.  Hits agree on > 99.9% of rays, t
   within rtol 1e-5 / atol 1e-5, slots on > 99% (the kernel's rsqrt and
   reciprocal are approximate, nvcc contracts to FMA, and the inside test
   runs on rows staged per triangle; a slot may differ on a tie).  Device
   times at 16,384 rays on both tables, each beside its bound, with the
   kernel's launch grid, registers and shared memory.
16. K7, the unreduced probe, inside phase 9 on the same three cluster
   sets and clusters: finiteness equal on > 99.9% of the (B, G) entries,
   values within rtol 1e-5 / atol 1e-5, and the minimum over G equal to
   K5's t bit for bit.  Device times with K3-K6.
17. The dense-sweep path at full width: mesh70k with
   ``prepare(scene, use_pallas=True)`` and no clusters, 512x512, NEE, 8
   bounces, S = 524,288, B = 16,384 through ``render_queue``.  Every
   sample counted once, finite radiance, K8 and K1 launched twice per
   iteration (a nearest hit and a shadow trace), K2-K7 never.  Then a
   short run of the same loop under ``torch.profiler`` for the share of
   wall time the device was busy; the trace must hold K8's and K1's
   kernels as often as the wrappers counted launches.
18. BVH4 against the sweep: mesh70k at 64x64, 1 spp, ``render_queue``
   with ``attach_bvh`` against the ``use_pallas`` prep: counts equal,
   >= 99% of paths agree, mean node visits per primary ray below 1% of
   the triangle count.  The walk launches no kernel of the port.
19. Museum PNEE at full width: ``emit_photons`` in batches of 65,536 to
   the 300,000-photon budget (K1 once per batch), then with the counts
   reset S = 2,621,440, 512x512, PNEE, 8 bounces, B = 16,384 through
   ``render_queue``: counts exact, finite, K1 and K2 once per iteration.
20. Adaptive session: ``Session(1920, 1080, scene 0)``, both halves NEE +
   adaptive at ``ray_batch_size`` 262,144, 8 bounces, with the bootstrap
   cut to 1 sample per pixel (4 batches a half) and two steady-state
   batches a half: every pixel sampled by the bootstrap sweep, the floor
   sweep advanced, the density view not constant, and the excess mass
   below 2^24 (where a float32 cumulative sum is exact).
21. The CLI with ``--right-type 2 --right-adaptive --show-sampling``
   (museum) and with ``--debug-view bvh`` (scene 4) writes PNGs that are
   not black.
22. The backward cell at full width (``grad``): the museum, 262,144 rays
   (one per pixel of 512x512), NEE, 8 bounces, loss mean(col^2), the
   gradients with respect to albedo and camera through
   ``integrator.render_pixels``, with ``checkpoint_bounces`` on, then
   off.  For each: grad rays/s and forward-only rays/s (medians of three
   calls), the re-evaluation's share of a step (the step timed again
   with the winners' distances left detached), the peak device memory,
   and K1/K2's launches in a step: the forward's once per bounce, with
   checkpointing again in the backward.  Finite gradients, equal in the
   two settings within rtol 1e-5 (atol 1e-6 of the largest).  Then K1
   (phase 3's rule) and K2 (> 99.9% of verdicts agree) against their
   plain versions on the arguments of one call of the checkpointed step
   whose launches were counted (262,144 rays), and their times there.
23. The gradient path on the card against the CPU (``grad_gpu_vs_cpu``):
   museum 64x64, 4 bounces; paths whose radiance differs (rtol 1e-3,
   atol 1e-4) at most 0.1%, and the albedo and camera gradients of
   mean(col^2) over the other paths within 1e-3 relative (atol 1e-3 of
   the largest).
24. ``make_train_step`` (``train``): the museum at 512x512, albedo and
   camera, 3 SGD steps from an albedo scaled by 0.8 toward a render of
   the scene (K1, K2); then mesh70k with its lights out of the cluster
   tables, the light rows, 2 steps (K1, K5).  Every step finite and
   moving its leaves.  In the last light step K1 and K5 are held
   against their plain versions on the arguments of one call each
   (phase 3's rule; phase 9's with t's tolerance from
   ``cancellation_atol``), and timed there; the tables that step
   gathered for K1 equal a fresh prep's of the moved scene it was
   given, K1 on them agrees with its plain version on rays aimed at the
   moved light, and they hit it.
25. The warps (``edges``): sphere_plane at 64x64 with the screen warp
   and the NEE warp, camera and light rows on the autograd path: the
   warped forward equals the plain render (rtol 1e-5), and the gradients
   agree with the port's on the CPU as in phase 23.
26. Whitted frames (``whitted``) at 512x512 through
   ``ops.whitted.render_whitted``: scene 101 at depth 4 (K1 31, K2 31),
   the museum at depth 1 (K1 3, K2 21 calls of 4,194,304 shadow rays,
   padded light slots of id -2), scene 101 with a point, a spot and a
   directional light at depth 2 (K1 7, K2 28, light id -1), and scene
   4's cloud on the session's cluster prep at depth 1 (K1 once per trace
   and shadow query, K5 in the cluster rounds, K2 never).  Each three
   times with the counts set to 0 before and read after each: launches
   as counted, a finite image that is not black; median frame seconds
   and rays/s (traces and shadow rays).  Then K1, K2 and K5 against
   their plain versions on one call of each frame (``WHITTED_CALLS``),
   timed there: K1 by phase 3's rule, except that a t outside it passes
   when it lies within the plain version's own spread over its origin
   moved by 16 ulp (``t_spread``: secondary rays tangent to a sphere);
   K2 by ``check_occluded_far`` (> 99.9% of near verdicts, rounding
   ties only among far ones); K5 as in phase 24.
27. Whitted on the card against the CPU (``whitted_gpu_vs_cpu``): scene
   101 at 64x64 depth 4 and the museum at 32x32 depth 1, >= 99.5% of
   pixels within rtol 1e-3 / atol 1e-3; the gradients of mean(img^2) by
   albedo and camera at 64x64 depth 2 within 1e-3 relative, as phase 23.
28. The live server (``live``): ``Session(512, 512, scene 0)``, NEE, 8
   bounces, ``LiveSession`` and ``LiveServer`` on 127.0.0.1 with their
   threads started; a sequence of requests (frames, a camera key, pause
   and resume, a settings, scene and viewport switch, pan): paths/s
   served, the latencies of ``/frame.png`` and ``/status``, K1/K2
   launches; both threads stop.
29. The CLI's runtime flags (``cli_runtime``): ``--whitted 4`` on scene
   101, ``--whitted 1`` on scene 4 (cluster prep), ``--seconds 2
   --checkpoint`` then ``--resume --ticks 65536``: PNGs not black, the
   resumed counts the checkpoint's plus 65,536.
30. The sharded paths (``shard``, last) on a world-1 NCCL group opened by
   ``distributed.initialize`` over a TCP store on 127.0.0.1 (one card;
   NCCL takes one rank a card), destroyed at the end: the museum headline
   through ``render_queue_sharded`` and mesh70k flat through
   ``render_queue_flat_sharded`` at full width against their unsharded
   loops on the same queue and seed, unsharded, sharded, sharded,
   unsharded, each with its launches counted (K1/K2, K3/K4 once per
   iteration): counts equal, sums within rtol 1e-5 (``index_add_``'s
   float atomics), then one pair with deterministic algorithms bit for
   bit; ``render_image_sharded`` of the museum at 512x512 bit-equal to
   ``render_pixels``; a museum train step with the group and without
   (loss within rtol 1e-5, albedo within 1e-4 of its move); the
   inverse-render demo (sphere_plane 64x64, albedo +0.15, 6 steps: the
   loss at a fixed seed falls by more than 10%); ``measure_scaling`` over
   1, 2, 4, 8 devices (one row on one card); the all-reduce of a 512x512
   frame's sums and counts, by CUDA events.
31. The card as the default device (``defaults``): the museum through
    ``scenes.museum()``, ``trace.prepare``, ``initial_camera(0)``,
    ``adaptive.random_pixels`` and one ``render_queue`` batch of 16,384
    paths with no device argument anywhere: every tensor on the card,
    K1 and K2 launched.
32. The session's per-pixel step (``no_regen``): 512x512 sessions with
    ``use_regen=False`` (8 bounces) on the museum (K1, K2) and on scene 4's
    cluster prep (K1, K5): two batches a half against the same session on
    the CPU (counts exact, per-pixel sums by the per-path rule), then
    paths/s beside a regenerating session's in turns, launches counted.
33. The inverse-render example (``inverse_render``): ``python -m
    wasm_pathtracer_tpu_torch.examples.inverse_render`` at its defaults
    (40 steps, 48x48, the card) must exit 0; the albedo error before and
    after and steps/s.  Phase 24 (``train``) also times the museum step
    with every bounce (``early_exit=False``, what ``make_train_step``
    builds) against the host's early exit, in turns, losses bit-equal.
34. The shade kernel (``shade``): ``fused_shade`` against the eager
    ``_shade_core`` bit for bit (every lane of every output, NaN equal
    to NaN), then both timed as the kernels above, first on the
    arguments of the shade kernel's call ``HEADLINE_CALL`` in the main
    path's run (16,384 lanes, recorded by ``headline_inputs`` with the
    loop run op by op, ``eager_queue``: a CUDA-graph replay makes no
    Python call), then on
    those of the sixth call of each half of a 512x512 museum session
    (the left half's uniform NEE, then the right half's PNEE after its
    300,000 photons; 8,192 lanes) and the same lanes four times over
    (32,768).
35. The regen kernel (``regen``): ``fused_regen`` against the eager
    ``regen.regen`` bit for bit (every register, the frame's counts
    exactly and its sums within rtol 1e-5), then both timed as the
    kernels above on the arguments of regeneration ``REGEN_CALL`` of a
    queue loop over 8 x lanes random pixels of a 512x512 frame: the
    museum through ``render_queue`` and mesh70k through
    ``render_queue_flat``, at 16,384 and 8,192 lanes.

The shade kernel is counted with the others wherever launches are:
once per iteration in every queue loop, at least once in the sessions
and the renders outside autograd, never in a gradient or train step
(the autograd path shades eagerly).  The regen kernel is counted the
same way, once per iteration in every queue loop and never outside one
(the per-pixel route, the renders and the steps regenerate nothing).
Phase 5's trace must hold ``wpt_shade_kernel`` and ``wpt_regen_kernel``
as often as their wrappers counted launches.

Each kernel's ``bound_ms`` is the least time the card could take for the
call that was timed: the larger of its bytes (each input and output
once) over 3.35 TB/s and its float32 operations over 67 TFLOP/s, the
H100's published rates.  Operations are counted from the inputs with the
per-test costs in ``FLOPS`` (one per add, multiply, compare, min, max,
divide or square root the function needs; what depends on one side
only, as a triangle's set-up, once for that side; one triangle count for
every kernel); torus marches are counted at the steps these rays take
(``torus_pairs``), only where the box entry lies before the ray's best
hit among the other families (K1, K3) or before the light (K2), and K2
up to the primitive that decides each ray (``occluded_work``).  No single
PyTorch call computes any of the eight functions, so ``library_ms`` is
null.

The last lines of standard output are a JSON record of the paths, the
card's name and power limit, a JSON record of each kernel (launches in
the run of the path it serves, max |kernel - plain|, kernel, plain and
bound ms at the main path's shape: museum rays for K1 and K2, mesh70k for
the others; ``other_shapes`` holds the same four numbers on the main
path's own rays for K1 and K2, at cloud300k for the others) and a JSON
status line.  The whole script took 110-152 s on an NVIDIA H100 80GB
HBM3 at 700 W from a clean checkout before phases 22-25, the builds
included (42-57 s of it are the four CLI processes); phases 22-25 add
about 45 s, phases 26-29 about 60 s (33 s of it the four CLI processes),
phase 30 56-70 s; the whole script 282 s of command time.  Phases 31-33
add about 2.5 min (their first run: 1.5 s, 99.6 s of which 78 s were the
two CPU sessions, before scene 4's CPU batch was halved, and 40.9 s);
phase 34 about 1 s, and the whole script 319 s with the shade kernel on
the main path.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

HEADLINE = dict(width=512, height=512, max_bounces=8, S=2_621_440, B=16_384)
SEED = 0xBABABEBE


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sm_clocks() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n, graph=True):
    """ms of one ``fn()``, by CUDA events around ``n`` calls.

    With ``graph`` (the kernels) the calls are captured in a CUDA graph
    and events stand around each of five replays of it; the time is the
    median replay over ``n``.  Inside a graph the kernels follow each
    other without waiting for the host, whose Python takes longer per
    call than most of these kernels run, so the time of a call is its
    kernels' device time and the ~0.002 ms between two launches of a
    graph; the median leaves out a replay that the host started late.
    Without (the plain versions: hundreds of small kernels a call, some
    with a host read between them that a graph cannot hold) the calls
    run eagerly, and the time is the wall time of an eager call on the
    device's clock: it includes what the device waits for the host, so it
    is what a caller of the plain version would wait, not the sum of its
    kernels.  (``torch.profiler``'s kernel durations would leave the gaps
    out, but in a process that has run for a while its traces come back
    without some of their kernels.)  Raises when the events measured
    nothing."""
    import torch
    fn()
    torch.cuda.synchronize()
    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            for _ in range(n):
                fn()
        captured.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            captured.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / n)
        ms = sorted(times)[2]
    else:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / n
    if not ms > 0:
        raise RuntimeError("the CUDA events around the calls measured no time")
    return ms


PEAK_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM HBM3
# Operations of one ray-primitive test, by family: one per add, multiply,
# compare, min, max, divide or square root that the function needs.  What
# depends on one side only is charged once for that side: a triangle's
# edges, normal, 1 / |n| and edge planes ("tri_setup") once per triangle
# per call, and the ray's three direction reciprocals ("recip") once per
# ray that meets a slab test.  "tri" is the (ray, triangle) pair in the
# staged form (csrc/triangle_stage.cuh): n.d 5, its clamp 1, n.v0 - n.o 6,
# the division 1, the hit point 6, three edge tests 3 x 7, t > 0 and the
# fold 2 = 42; the same count serves every kernel that tests triangles.
# "aarect" and "box" (a torus' bounding slab) are slab tests without the
# reciprocals; "sdf" is one torus march step, "newton" one polish step.
FLOPS = {0: 19, 1: 30, 2: 42, 4: 24, 5: 15, "tri_setup": 88, "recip": 3,
         "box": 24, "sdf": 22, "newton": 45}


def bound(flops, n_bytes):
    """(bound_ms, bound_by) of a call needing ``flops`` operations and
    ``n_bytes`` bytes of traffic."""
    t_ops, t_bytes = flops / PEAK_FLOPS, n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def torus_pairs(rows, o, d):
    """Per (ray, torus) pair of (R, 3) rays and ``rows`` (n, 5): the box
    entry t_lo (+inf where the ray misses the box) and the operations of
    the march and Newton steps taken until they reach their fixed point,
    as ``torus_march`` in ``csrc/scene_families.cuh`` exits (0 where the
    box is missed)."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import intersect as isx
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
    # a Newton step runs while |f| > 1e-6; four at most (counted as the
    # march leaves them: converged marches take none)
    n_newton = 4 * (live & (dist.abs() > 1e-6))
    ops = n_sdf * FLOPS["sdf"] + n_newton * FLOPS["newton"]
    return torch.where(live, t_lo, torch.inf), ops


def family_candidates(tables, o, d):
    """{family: (R, n) distances} of the non-empty families (plain
    version's formulas)."""
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    return {f: sk._family_distances(f, tables.family(f), o, d)
            for f in range(6) if tables.counts[f]}


def needed_marches(tables, o, d):
    """(R, n_torus) bool of the tori K1 marches for these rays (those whose
    box entry is not beyond the ray's best hit among the other families:
    a torus hit is >= that entry), and the (R, n_torus) operations of
    each march."""
    import torch
    best = torch.full((o.shape[0],), torch.inf, device=o.device)
    for f, t in family_candidates(tables, o, d).items():
        if f != 3:
            best = torch.minimum(best, t.amin(1))
    t_lo, march = torus_pairs(tables.family(3), o, d)
    return t_lo <= best[:, None], march


def scene_flops(tables, o, d):
    """Operations the nearest hit of these rays over the whole scene needs
    (K1, K3's dense half): every pair of the five cheap families, each
    torus box, and the marches of ``needed_marches``."""
    R, n = o.shape[0], tables.counts
    total = sum(R * n[f] * FLOPS[f] for f in (0, 1, 2, 4, 5)) + n[2] * FLOPS["tri_setup"]
    if n[3] + n[4]:
        total += R * FLOPS["recip"]
    if n[3]:
        go, march = needed_marches(tables, o, d)
        total += R * n[3] * FLOPS["box"] + int(march[go].sum())
    return total


# the order in which K2 tests the families (csrc/scene_kernels.cu)
K2_ORDER = (0, 5, 4, 1, 2, 3)


def occluded_work(tables, code_of, o, d, dist, light_sid):
    """What the any-hit query of these shadow rays needs, in K2's order:
    the light's own primitive first, then the families in ``K2_ORDER``
    up to and including the first other candidate with
    t < min(dist, t_exc), which decides the verdict; a torus is marched
    only when its box entry is before that limit.  Returns (operations,
    per-ray primitive tests (R,), per-ray marches (R,))."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    R, n = o.shape[0], tables.counts
    excl = sk._excl_codes(light_sid, code_of)
    cand = family_candidates(tables, o, d)
    costs, is_exc, dists = [], [], []
    for f in K2_ORDER:
        if f not in cand:
            continue
        t = cand[f]
        code = (f << sk.SLOT_BITS) + torch.arange(n[f], device=o.device)
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
            # the light's own torus is marched in full (t_exc)
            go = (t_lo < limit[:, None]) | (exc & torch.isfinite(t_lo))
            pair.append(c + torch.where(go, march, 0).double())
            marches.append(go.double())
    pair, marches = torch.cat(pair, 1), torch.cat(marches, 1)
    first = torch.where(exc_all, torch.inf, t_all) < limit[:, None]
    # tests up to and including the first occluder; the light's own first
    upto = (torch.cumsum(first.int(), 1) - first.int()) == 0
    done = upto | exc_all
    ops = (pair * done).sum() + n[2] * FLOPS["tri_setup"] + (R * FLOPS["recip"] if n[3] + n[4] else 0)
    return int(ops), done.sum(1), (marches * done).sum(1)


def probe_flops(cs, cidx):
    """Operations one probe round needs: each ray's cluster's real slots
    at their family's cost (mesh70k and the clouds hold triangles only;
    a torus slot is counted at its box test), and the set-up of every
    triangle of the clusters probed, once."""
    import torch
    c = cidx.long().clamp(0, cs.num_clusters - 1)
    bt = cs.btype[c]
    total = sum(int((bt == f).sum()) * FLOPS.get(f, FLOPS["box"]) for f in cs.families)
    probed = cs.btype[torch.unique(c)]
    return total + int((probed == 2).sum()) * FLOPS["tri_setup"]


# (wrapper, TPU kernel it replaces, CUDA source), K1 to K8
KERNELS = (
    ("fused_nearest", "wasm_pathtracer_tpu/ops/scene_pallas.py:534",
     "wasm_pathtracer_tpu_torch/csrc/scene_kernels.cu"),
    ("fused_occluded", "wasm_pathtracer_tpu/ops/scene_pallas.py:447",
     "wasm_pathtracer_tpu_torch/csrc/scene_kernels.cu"),
    ("select_scan", "wasm_pathtracer_tpu/ops/probe_pallas.py:602",
     "wasm_pathtracer_tpu_torch/csrc/probe_kernels.cu"),
    ("probe_pair", "wasm_pathtracer_tpu/ops/probe_pallas.py:860",
     "wasm_pathtracer_tpu_torch/csrc/probe_kernels.cu"),
    ("probe_min", "wasm_pathtracer_tpu/ops/probe_pallas.py:884",
     "wasm_pathtracer_tpu_torch/csrc/probe_kernels.cu"),
    ("select_blocks", "wasm_pathtracer_tpu/ops/probe_pallas.py:398",
     "wasm_pathtracer_tpu_torch/csrc/probe_kernels.cu"),
    ("probe_blocks", "wasm_pathtracer_tpu/ops/probe_pallas.py:790",
     "wasm_pathtracer_tpu_torch/csrc/probe_kernels.cu"),
    ("dense_tri_nearest", "wasm_pathtracer_tpu/ops/traverse_pallas.py:117",
     "wasm_pathtracer_tpu_torch/csrc/traverse_kernels.cu"),
)
# the shade kernel replaces the eager shading, no TPU kernel
SHADE_KERNEL = ("fused_shade", None, "wasm_pathtracer_tpu_torch/csrc/shade_kernels.cu")
# float32 operations of one lane of the shade kernel, counted as FLOPS
# counts (the worst normal, a torus: 40; the BSDF branches and the
# tangent frame: ~170; the light point, its weight and the outputs: ~140),
# plus, with PNEE, the grid cell (21), the CDF count (one compare a light)
# and the eight neighbours (64)
SHADE_FLOPS, SHADE_PNEE_FLOPS = 350, 85


def wrappers():
    """Kernel wrapper of each name in ``KERNELS``, ``SHADE_KERNEL`` and
    ``REGEN_KERNEL``."""
    from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
    from wasm_pathtracer_tpu_torch.ops import regen_kernels as rgk
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    from wasm_pathtracer_tpu_torch.ops import shade_kernels as shk
    from wasm_pathtracer_tpu_torch.ops import traverse_kernels as tk
    return {"fused_nearest": sk.fused_nearest, "fused_occluded": sk.fused_occluded,
            "select_scan": pk.select_scan, "probe_pair": pk.probe_pair,
            "probe_min": pk.probe_min, "select_blocks": pk.select_blocks,
            "probe_blocks": pk.probe_blocks, "dense_tri_nearest": tk.dense_tri_nearest,
            "fused_shade": shk.fused_shade, "fused_regen": rgk.fused_regen}


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def expect_launches(launches, iters, once_per_iteration=(), at_least_once=(),
                    twice_per_iteration=()):
    """Each kernel of ``once_per_iteration`` launched ``iters`` times, each
    of ``twice_per_iteration`` twice that, each of ``at_least_once`` some
    times, every other kernel never."""
    for name, n in launches.items():
        if name in once_per_iteration:
            ok = n == iters
        elif name in twice_per_iteration:
            ok = n == 2 * iters
        elif name in at_least_once:
            ok = n > 0
        else:
            ok = n == 0
        if not ok:
            raise AssertionError(f"{name} launched {n} times in {iters} "
                                 f"iterations (all launches: {launches})")


# ---------------------------------------------------------------------------
# scenes and rays
# ---------------------------------------------------------------------------

def all_families_scene(device):
    """Every primitive family, sizes off any power of two, and emissive
    shapes in the sphere, square and triangle families."""
    from wasm_pathtracer_tpu_torch.models.scene import Material, SceneBuilder
    b = SceneBuilder(background=(0.1, 0.1, 0.1))
    r = np.random.default_rng(13)
    for _ in range(3):
        b.add_sphere(r.uniform(-2, 2, 3), 0.5, Material.diffuse(0.6, 0.4, 0.3))
    b.add_sphere((0.0, 2.5, 1.0), 0.4, Material.emissive(5.0, 5.0, 5.0))
    b.add_plane((0, -2, 0), (0, 1, 0), Material.diffuse(0.5, 0.5, 0.5))
    for _ in range(2):
        b.add_torus(r.uniform(-2, 2, 3), 0.8, 0.25, Material.diffuse(0.7, 0.7, 0.2))
    lo = r.uniform(-2, 0, (2, 3))
    hi = lo + r.uniform(0.2, 1.0, (2, 3))
    for j in range(2):
        b.add_aarect(lo[j][0], hi[j][0], lo[j][1], hi[j][1], lo[j][2], hi[j][2],
                     Material.diffuse(0.2, 0.6, 0.7))
    b.add_square((0.5, 3.0, 0.5), 1.5, Material.emissive(6.0, 6.0, 6.0))
    tri = np.random.default_rng(4)
    c = np.concatenate([tri.uniform(-2.5, 2.5, (5, 1, 2)),
                        tri.uniform(0.0, 5.0, (5, 1, 1))], axis=-1)
    b.add_triangles((c + tri.uniform(0.0, 0.5, (5, 3, 3))).astype(np.float32),
                    Material.emissive(4.0, 4.0, 4.0))
    return b.build(device)


def smoke_scenes(device):
    from wasm_pathtracer_tpu_torch.models import scenes
    return {"museum": scenes.museum(device),
            "sphere_plane": scenes.sphere_plane(device),
            "whitted": scenes.whitted(device=device),
            "all_families": all_families_scene(device)}


def test_rays(n, seed, device, camera=None):
    """Half primary rays of ``camera`` (the museum's by default) at random
    pixels of a 512x512 frame, half random origins in [-4, 4]^3 with
    random directions."""
    import torch
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera, primary_rays
    r = np.random.default_rng(seed)
    n_cam = n // 2
    px = torch.as_tensor(r.integers(0, 512, n_cam), device=device)
    py = torch.as_tensor(r.integers(0, 512, n_cam), device=device)
    jx = torch.as_tensor(r.random(n_cam, dtype=np.float32), device=device)
    jy = torch.as_tensor(r.random(n_cam, dtype=np.float32), device=device)
    o_c, d_c = primary_rays(camera or initial_camera(0, device), px, py, jx, jy,
                            512, 512)
    o_r = r.uniform(-4, 4, (n - n_cam, 3)).astype(np.float32)
    d_r = r.normal(size=(n - n_cam, 3)).astype(np.float32)
    d_r /= np.linalg.norm(d_r, axis=-1, keepdims=True)
    o = torch.cat([o_c, torch.as_tensor(o_r, device=device)]).contiguous()
    d = torch.cat([d_c, torch.as_tensor(d_r, device=device)]).contiguous()
    return o, d


def shadow_rays(prep, scene, o, d, seed):
    """Shadow rays from the hits of (o, d) toward random points of random
    lights, with the light's shape id as the exclusion (-1 on every
    tenth ray); rays that miss start from their own origin.  Returns the
    rays and a mask of those whose origin is a hit farther than 50 units
    (beyond the scenes' geometry: grazing hits on a ground plane, up to
    ~10^5 units away)."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import intersect as isx
    from wasm_pathtracer_tpu_torch.ops import trace
    dev = o.device
    t, _, hit, _ = trace.trace_scene(prep, scene, o, d)
    p = torch.where(hit[:, None], o + d * torch.where(hit, t, 0.0)[:, None], o)
    r = np.random.default_rng(seed)
    R = o.shape[0]
    lights = scene.light_shape.cpu().numpy()
    lsid = torch.as_tensor(r.choice(lights, R).astype(np.int64), device=dev)
    rows = scene.params[lsid]
    u = torch.as_tensor(r.random((3, R), dtype=np.float32), device=dev)
    tri = scene.ptype[lsid] == 2
    p_tri, _ = isx.triangle_pick_random(rows[:, 0:3], rows[:, 3:6], rows[:, 6:9],
                                        u[0], u[1], u[2])
    p_l = torch.where(tri[:, None], p_tri, rows[:, 0:3])
    to_l = p_l - p
    dist = torch.linalg.norm(to_l, dim=-1)
    dd = (to_l / torch.clamp(dist, min=1e-30)[:, None]).contiguous()
    oo = (p + dd * 2e-4).contiguous()
    lsid[::10] = -1
    return oo, dd, dist.contiguous(), lsid.contiguous(), hit & (t >= 50.0)


def rounding_ties(tables, code_of, o, d, dist, light_sid, max_ulps=16, n_jitter=2048,
                  seed=0):
    """(R,) bool: shadow rays whose verdict float32 does not settle.  The
    plain version is evaluated with each origin coordinate moved by up
    to ``max_ulps`` units in the last place (``n_jitter`` random moves);
    a ray is a tie when both verdicts occur.  The kernel (the Pallas
    kernel's formulas, FMA-contracted, triangles in the staged form) and
    the plain version (the dense formulas, separately rounded) compute
    t = (n.v0 - n.o) / (n.d) and o + d t with different roundings; from
    an origin 10^4 units out the cancellation leaves errors of several
    ulp of the origin, more at grazing angles."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    R = o.shape[0]
    if R == 0:
        return torch.zeros(0, dtype=torch.bool, device=o.device)
    g = torch.Generator(device=o.device).manual_seed(seed)
    a = o.abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    k = torch.randint(-max_ulps, max_ulps + 1, (n_jitter, R, 3), generator=g,
                      device=o.device)
    oj = (o[None] + k * ulp[None]).reshape(-1, 3)

    def rep(x):
        return x[None].expand(n_jitter, *x.shape).reshape(-1, *x.shape[1:])

    v = sk.fused_occluded_reference(tables, oj, rep(d), rep(dist), rep(light_sid),
                                    code_of).view(n_jitter, R)
    return v.any(0) & ~v.all(0)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

# the K1 and K2 calls of a museum headline run (of 345 each) whose inputs
# phases k1 and k2 time: the middle one, when the lanes hold a steady mix
# of camera and bounce rays
HEADLINE_CALL = 172


@contextlib.contextmanager
def recorded_calls(module, which):
    """Within the block, each wrapper ``module.<name>`` of ``which``
    records the arguments (tensors cloned) of its call ``which[name]``,
    counted from 0, into the dict the block gets.  The wrapper counts
    its launches on whatever its module name holds: the counts the block
    makes are carried back to the wrapper when it is put back."""
    import torch
    saved = {name: getattr(module, name) for name in which}
    got = {}

    def spy(name, fn):
        calls = [0]

        def wrapped(*args):
            if calls[0] == which[name]:
                got[name] = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                  for a in args)
            calls[0] += 1
            return fn(*args)
        wrapped.launches = fn.launches
        return wrapped

    try:
        for name, fn in saved.items():
            setattr(module, name, spy(name, fn))
        yield got
    finally:
        for name, fn in saved.items():
            fn.launches = getattr(module, name).launches
            setattr(module, name, fn)


@contextlib.contextmanager
def eager_queue():
    """Within the block the queue loops launch every iteration op by op,
    with no CUDA graph, so that a wrapper's spy sees each iteration's
    call: a replay launches without one."""
    from wasm_pathtracer_tpu_torch.ops import integrator
    from wasm_pathtracer_tpu_torch.ops import regen_kernels as rgk
    real = integrator._loop

    def loop(step, q, ln, c, light_tab, packed_rows, graph):
        it = 0
        while bool(ln.alive.any()):
            was, fin = step(q, ln, c, light_tab, packed_rows)
            rgk.fused_regen(q, ln, was=was, fin=fin)
            it += 1
        return it

    integrator._loop = loop
    try:
        yield
    finally:
        integrator._loop = real


@functools.cache
def headline_inputs(device):
    """{wrapper name: its arguments} of call ``HEADLINE_CALL`` of K1, of
    K2 and of the shade kernel in one run of the main path (the museum
    headline)."""
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera
    from wasm_pathtracer_tpu_torch.ops import integrator, trace
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    from wasm_pathtracer_tpu_torch.ops import shade_kernels as shk
    h = HEADLINE
    scene = scenes.museum(device)
    prep = trace.prepare(scene)
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=h["max_bounces"])
    which = {"fused_nearest": HEADLINE_CALL, "fused_occluded": HEADLINE_CALL}
    with eager_queue(), recorded_calls(sk, which) as got, \
            recorded_calls(shk, {"fused_shade": HEADLINE_CALL}) as got_shade:
        integrator.render_queue(prep, scene, st, initial_camera(0, device),
                                headline_queue(device, h["S"]), h["width"], h["height"],
                                4, h["B"])
        torch.cuda.synchronize()
    got.update(got_shade)
    if set(got) != set(which) | {"fused_shade"}:
        raise AssertionError(f"the headline run made fewer than {HEADLINE_CALL + 1} calls")
    return got


def check_nearest(tables, o, d, sid_map, what, spread=False):
    """K1 against its plain version on (o, d): hits agree on > 99.9% of
    rays, t within rtol 1e-5 / atol 1e-4 where both hit, shape ids on
    > 99.5%.  With ``spread`` a t outside that tolerance also passes when
    it lies within the plain version's own spread over the ray's origin
    moved by up to 16 ulp (``t_spread``): float32 cancellation, as in a
    secondary ray that leaves a surface.  Returns (max |dt|, hit rate)."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    t_k, s_k = sk.fused_nearest(tables, o, d, sid_map)
    t_p, s_p = sk.fused_nearest_reference(tables, o, d, sid_map)
    torch.cuda.synchronize()
    hit_k, hit_p = s_k >= 0, s_p >= 0
    both = hit_k & hit_p
    hit_agree = (hit_k == hit_p).float().mean().item()
    err = (t_k[both] - t_p[both]).abs().max().item() if both.any() else 0.0
    far = both & ~torch.isclose(t_k, t_p, rtol=1e-5, atol=1e-4)
    t_ok = not bool(far.any())
    if spread and not t_ok:
        idx = torch.nonzero(far)[:, 0]
        lo, hi = t_spread(tables, o[idx], d[idx], sid_map)
        inside = (t_k[idx] >= lo - 1e-4) & (t_k[idx] <= hi + 1e-4)
        order = torch.argsort((t_k[idx] - t_p[idx]).abs(), descending=True)[:4]
        for j in order.tolist():
            i = int(idx[j])
            log(f"  K1 t differs: origin {o[i].tolist()}, direction {d[i].tolist()}, "
                f"kernel ({t_k[i].item():.7g}, {int(s_k[i])}), plain ({t_p[i].item():.7g}, "
                f"{int(s_p[i])}), plain over a 16-ulp origin [{lo[j].item():.7g}, "
                f"{hi[j].item():.7g}]")
        log(f"K1 {what}: {idx.numel()} rays outside rtol 1e-5 / atol 1e-4, "
            f"{int(inside.sum())} of them within the plain version's rounding spread")
        t_ok = bool(inside.all())
    sid_agree = (s_k == s_p)[both].float().mean().item() if both.any() else 1.0
    misses_ok = bool(torch.isinf(t_k[~hit_k]).all())
    log(f"K1 {what}: hit agreement {hit_agree:.6f}, max |dt| {err:.3g}, shape-id "
        f"agreement {sid_agree:.6f}, hit rate {hit_p.float().mean().item():.3f}")
    if not (hit_agree > 0.999 and t_ok and sid_agree > 0.995 and misses_ok):
        raise AssertionError(f"K1 disagrees with its plain version on {what}")
    return err, hit_p.float().mean().item()


def t_spread(tables, o, d, sid_map, max_ulps=16, n_jitter=256, seed=0):
    """((R,), (R,)): the least and largest t the plain version gives for
    each ray with each origin coordinate moved by up to ``max_ulps`` units
    in the last place (``n_jitter`` random moves and the ray itself)."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    R = o.shape[0]
    g = torch.Generator(device=o.device).manual_seed(seed)
    a = o.abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    k = torch.randint(-max_ulps, max_ulps + 1, (n_jitter, R, 3), generator=g,
                      device=o.device)
    k[0] = 0
    oj = (o[None] + k * ulp[None]).reshape(-1, 3)
    dj = d[None].expand(n_jitter, R, 3).reshape(-1, 3)
    t = sk.fused_nearest_reference(tables, oj, dj, sid_map)[0].view(n_jitter, R)
    return t.amin(0), t.amax(0)


def phase_kernel_k1(device, record):
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    from wasm_pathtracer_tpu_torch.ops import trace
    worst = 0.0
    rec = record.setdefault("fused_nearest", {})
    for i, (name, scene) in enumerate(smoke_scenes(device).items()):
        prep = trace.prepare(scene)
        tables = prep.tables
        o, d = test_rays(16_384 + 37, 100 + i, device)
        worst = max(worst, check_nearest(tables, o, d, prep.sid_of_slot, name)[0])
        if name == "museum":
            o16, d16 = o[:16_384].contiguous(), d[:16_384].contiguous()
            rec.update(timed_nearest(tables, o16, d16, prep.sid_of_slot, "museum"))
    log(f"scene kernels built as {sk.launch_shape()}")

    # the rays of one call of the main path
    tables, o, d, sid_map = headline_inputs(device)["fused_nearest"]
    err, rate = check_nearest(tables, o, d, sid_map, f"headline call {HEADLINE_CALL}")
    worst = max(worst, err)
    m = needed_marches(tables, o, d)[0].sum(1).float()
    log(f"K1 headline rays: {o.shape[0]} rays, hit rate {rate:.3f}, marches per ray "
        f"{m.mean().item():.4f} (max {int(m.max())}), rays with a march "
        f"{(m > 0).float().mean().item():.4f}")
    rec["other_shapes"] = {"headline_rays": timed_nearest(tables, o, d, sid_map,
                                                          "headline rays")}
    rec["max_abs_err"] = worst


def timed_nearest(tables, o, d, sid_map, what):
    """Kernel, plain and bound ms of K1 on (o, d)."""
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    ms = cuda_ms(lambda: sk.fused_nearest(tables, o, d, sid_map), 50)
    plain_ms = cuda_ms(lambda: sk.fused_nearest_reference(tables, o, d, sid_map), 5,
                       graph=False)
    R = o.shape[0]
    b_ms, b_by = bound(scene_flops(tables, o, d),
                       4 * tables.flat.numel() + 8 * sum(tables.counts) + R * (24 + 12))
    log(f"K1 {what} B={R}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms by {b_by} ({100 * b_ms / ms:.1f}% of the kernel's time); "
        f"SM clock now / max {sm_clocks()}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def timed_occluded(tables, code_of, args, what):
    """Kernel, plain and bound ms of K2 on ``args`` (o, d, dist,
    light_sid), and what its early exit saves there.  The plain version
    and the work count go in slices of ``PLAIN_SLICE`` rays."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    ms = cuda_ms(lambda: sk.fused_occluded(tables, *args, code_of), 50)
    plain_ms = cuda_ms(lambda: plain_occluded(tables, *args, code_of), 5, graph=False)
    R = args[0].shape[0]
    parts = [occluded_work(tables, code_of, *(x[i:i + PLAIN_SLICE] for x in args))
             for i in range(0, R, PLAIN_SLICE)]
    ops = sum(p[0] for p in parts)
    tests, marches = (torch.cat([p[k] for p in parts]) for k in (1, 2))
    b_ms, b_by = bound(ops, 4 * tables.flat.numel() + 4 * code_of.numel()
                       + R * (24 + 4 + 8 + 1))
    occ = plain_occluded(tables, *args, code_of)
    log(f"K2 {what} B={R}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms by {b_by} ({100 * b_ms / ms:.1f}% of the kernel's time); "
        f"occluded {occ.float().mean().item():.4f}, primitive tests per ray up to the "
        f"deciding one {tests.float().mean().item():.2f} of {sum(tables.counts)}, "
        f"marches per ray {marches.float().mean().item():.4f}; SM clock now / max "
        f"{sm_clocks()}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


# rays a slice of K2's plain version's evaluation (its (R, P) candidate
# matrices at 4M rays would not fit the card's memory)
PLAIN_SLICE = 1 << 19


def plain_occluded(tables, o, d, dist, lsid, code_of):
    """K2's plain version, evaluated in slices of ``PLAIN_SLICE`` rays."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    return torch.cat([sk.fused_occluded_reference(tables, o[i:i + PLAIN_SLICE],
                                                  d[i:i + PLAIN_SLICE],
                                                  dist[i:i + PLAIN_SLICE],
                                                  lsid[i:i + PLAIN_SLICE], code_of)
                      for i in range(0, o.shape[0], PLAIN_SLICE)])


def phase_kernel_k2(device, record):
    """Near origins (within the scenes' geometry): verdicts agree on
    > 99.9% of rays.  Far origins (grazing hits > 50 units away, where a
    float32 ulp of the origin is 4e-6 to 8e-3): every verdict that
    differs is a rounding tie (``rounding_ties``), and >= 98% agree.
    Ties are common there (the origin sits on the ground plane within an
    ulp), so the share of ties among far rays is printed beside them.
    Then the rays of one call of the main path, held to the near rule."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    from wasm_pathtracer_tpu_torch.ops import trace
    worst = 0.0
    rec = record.setdefault("fused_occluded", {})
    for i, (name, scene) in enumerate(smoke_scenes(device).items()):
        prep = trace.prepare(scene)
        tables, code_of = prep.tables, prep.code_of
        o, d = test_rays(16_384 + 37, 200 + i, device)
        so, sd, dist, lsid, far = shadow_rays(prep, scene, o, d, 300 + i)
        occ_k = sk.fused_occluded(tables, so, sd, dist, lsid, code_of)
        occ_p = sk.fused_occluded_reference(tables, so, sd, dist, lsid, code_of)
        torch.cuda.synchronize()
        diff = occ_k != occ_p
        n_near, n_far = int((~far).sum()), int(far.sum())
        d_near, d_far = int((diff & ~far).sum()), int((diff & far).sum())
        agree_near = 1.0 - d_near / max(n_near, 1)
        agree_far = 1.0 - d_far / max(n_far, 1)
        idx = torch.nonzero(diff & far)[:, 0]
        ties = rounding_ties(tables, code_of, *(x[idx] for x in (so, sd, dist, lsid)))
        # how common ties are among far rays in general (256 of them)
        sample = torch.nonzero(far)[:256, 0]
        base = rounding_ties(tables, code_of, *(x[sample] for x in (so, sd, dist, lsid)))
        log(f"K2 {name}: near origins {d_near} of {n_near} differ (agreement "
            f"{agree_near:.6f}); far origins {d_far} of {n_far} differ (agreement "
            f"{agree_far:.6f}), {int(ties.sum())} of them rounding ties, ties among "
            f"{sample.numel()} far rays {base.float().mean().item() if sample.numel() else 0.0:.4f}; "
            f"occluded rate {occ_p.float().mean().item():.3f}")
        for j, tie in list(zip(idx.tolist(), ties.tolist()))[:8]:
            log(f"  differs: |origin| {so[j].abs().max().item():.6g}, light at "
                f"{dist[j].item():.6g}, light shape {int(lsid[j])}, kernel "
                f"{bool(occ_k[j])}, tie {tie}")
        if not (agree_near > 0.999 and agree_far >= 0.98 and bool(ties.all())):
            raise AssertionError(f"K2 disagrees with its plain version on {name}")
        worst = max(worst, diff.float().max().item())
        if name == "museum":
            args = [x[:16_384].contiguous() for x in (so, sd, dist, lsid)]
            rec.update(timed_occluded(tables, code_of, args, "museum"))

    tables, o, d, dist, lsid, code_of = headline_inputs(device)["fused_occluded"]
    worst = max(worst, check_occluded(tables, o, d, dist, lsid, code_of,
                                      f"headline call {HEADLINE_CALL}"))
    rec["other_shapes"] = {"headline_rays": timed_occluded(tables, code_of,
                                                           (o, d, dist, lsid),
                                                           "headline rays")}
    rec["max_abs_err"] = worst


def check_occluded(tables, o, d, dist, lsid, code_of, what):
    """K2 against its plain version on the rays of one call of a path:
    verdicts agree on > 99.9% of them.  Returns 1.0 if any verdict
    differs, else 0.0 (a verdict's largest error)."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    occ_k = sk.fused_occluded(tables, o, d, dist, lsid, code_of)
    occ_p = sk.fused_occluded_reference(tables, o, d, dist, lsid, code_of)
    torch.cuda.synchronize()
    agree = (occ_k == occ_p).float().mean().item()
    log(f"K2 {what}: verdicts agree on {agree:.6f} of {o.shape[0]} rays, occluded rate "
        f"{occ_p.float().mean().item():.3f}")
    if not agree > 0.999:
        raise AssertionError(f"K2 disagrees with its plain version on {what}")
    return (occ_k != occ_p).float().max().item()


def busy_share(fn, kernels):
    """(share, kernels): the share of the wall time of ``fn()`` in which
    the device ran a kernel, summed kernel durations from
    ``torch.profiler`` over the host clock (the profiler's own overhead is
    in the wall time), and the number of device kernels the trace holds.  ``kernels``
    maps a wrapper's name to the name of the CUDA kernel it launches: the
    trace must hold each as often as the wrapper counted launches in
    ``fn()``, else it lost kernels and the share would read too low.  Such
    a trace is thrown away and taken again, three times at most; then
    this raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(3):
        torch.cuda.synchronize()
        reset_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launched = read_counts()
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.device_time)
        traced = {w: sum(n for name, (n, _) in by_name.items() if k in name)
                  for w, k in kernels.items()}
        if all(traced[w] == launched[w] > 0 for w in kernels):
            break
        log(f"trace {attempt + 1} thrown away: it holds {traced}, the wrappers "
            f"launched {({w: launched[w] for w in kernels})}")
    else:
        raise RuntimeError("three traces in a row lost kernels of the loop")
    total = sum(us for _, us in by_name.values())
    n_kernels = sum(n for n, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
    log(f"device time {total / 1e3:.1f} ms of {1e3 * wall:.1f} ms wall in "
        f"{n_kernels} kernels ({traced} as launched); "
        "top: " + "; ".join(f"{name[:48]} x{n} {us / 1e3:.1f} ms"
                            for name, (n, us) in top))
    return total / 1e6 / wall, n_kernels


def counted_run(fn):
    """(fn(), seconds, launches) with the counts set to 0 just before and
    read just after."""
    import torch
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counts()


def run_queue(what, queue_fn, prep, scene, st, cam, h, device, **kw):
    """Warm up, then drive ``queue_fn`` over ``h['S']`` random pixels of
    an ``h['width']`` x ``h['height']`` frame with the counts set to 0
    just before and read just after.  Checks that every sample is counted
    once and the radiance is finite.  Returns (launches, iterations,
    record dict)."""
    import torch
    queue_fn(prep, scene, st, cam, headline_queue(device, 2 * h["B"]),
             h["width"], h["height"], 1, h["B"], **kw)
    pix = headline_queue(device, h["S"])
    (acc, cnt, cost, iters), dt, launches = counted_run(lambda: queue_fn(
        prep, scene, st, cam, pix, h["width"], h["height"], 2, h["B"], return_iters=True,
        **kw))
    total = int(cnt.sum())
    tests = int(cost.sum()) / h["S"]
    log(f"{what}: {h['width']}x{h['height']} {st.render_type.name} {st.max_bounces} "
        f"bounces, S={h['S']} B={h['B']}: {dt:.3f} s, {h['S'] / dt:.1f} paths/s, {iters} "
        f"iterations, launches {launches}, samples {total}, mean radiance "
        f"{acc.sum(0).div(h['S']).tolist()}, prim tests/path {tests:.1f}; {card_line()}")
    if total != h["S"]:
        raise AssertionError(f"{what}: counts sum to {total}, expected {h['S']}")
    if not bool(torch.isfinite(acc).all()):
        raise AssertionError(f"{what}: non-finite radiance")
    return launches, iters, dict(paths_per_sec=h["S"] / dt, seconds=dt, iterations=iters,
                                 prim_tests_per_path=tests)


def headline_queue(device, S):
    from wasm_pathtracer_tpu_torch.ops import adaptive
    h = HEADLINE
    px, py = adaptive.random_pixels(S, 1, 0, 0, h["width"], h["height"], device)
    return (py * h["width"] + px).contiguous()


def phase_main_path(device, record):
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera
    from wasm_pathtracer_tpu_torch.ops import integrator, trace
    h = HEADLINE
    scene = scenes.museum(device)
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=h["max_bounces"])
    prep, cam = trace.prepare(scene), initial_camera(0, device)
    launches, iters, rec = run_queue("main path: museum", integrator.render_queue,
                                     prep, scene, st, cam, h, device)
    expect_launches(launches, iters, ("fused_nearest", "fused_occluded", "fused_shade",
                                      "fused_regen"))
    for name in ("fused_nearest", "fused_occluded", "fused_shade", "fused_regen"):
        record.setdefault(name, {})["launches"] = launches[name]
    # device kernels per iteration, and the device's busy share, in a short run
    short = headline_queue(device, 8 * h["B"])
    short_iters = []
    rec["device_busy_share"], n_kernels = busy_share(
        lambda: short_iters.append(integrator.render_queue(
            prep, scene, st, cam, short, h["width"], h["height"], 3, h["B"],
            return_iters=True)[3]),
        {"fused_nearest": "fused_nearest_kernel", "fused_occluded": "fused_occluded_kernel",
         "fused_shade": "wpt_shade_kernel", "fused_regen": "wpt_regen_kernel"})
    rec["kernels_per_iteration"] = n_kernels / short_iters[-1]
    log(f"main path: {rec['kernels_per_iteration']:.1f} device kernels per iteration "
        f"({short_iters[-1]} iterations, S={short.numel()}), device busy "
        f"{100 * rec['device_busy_share']:.1f}% of wall time under the profiler")
    record["main_path"] = rec


def phase_gpu_vs_cpu(device, record):
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera
    from wasm_pathtracer_tpu_torch.ops import integrator, trace
    from wasm_pathtracer_tpu_torch.utils import rng
    # the pcg3d streams are bit-exact across devices (int64 wraparound)
    r = np.random.default_rng(5)
    args = [r.integers(0, 2**32, 1 << 16, dtype=np.int64) for _ in range(3)]
    for a in args:
        a[:2] = (0, 2**32 - 1)
    u_g = rng.uniform3(*(torch.as_tensor(a, device=device) for a in args))
    u_c = rng.uniform3(*(torch.as_tensor(a) for a in args))
    if not all(torch.equal(g.cpu(), c) for g, c in zip(u_g, u_c)):
        raise AssertionError("pcg3d streams differ between GPU and CPU")
    log("pcg3d: GPU and CPU streams bit-identical on 65,536 random triples")

    W = H = 32
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=8)
    out = {}
    for dev in (device, torch.device("cpu")):
        scene = scenes.museum(dev)
        pix = torch.arange(W * H, device=dev)
        acc, cnt, cost = integrator.render_queue(
            trace.prepare(scene), scene, st, initial_camera(0, dev), pix, W, H,
            SEED, 256)
        out[dev.type] = (acc.cpu().numpy(), cnt.cpu().numpy(), int(cost.sum()))
    (a_g, c_g, k_g), (a_c, c_c, k_c) = out["cuda"], out["cpu"]
    close = np.isclose(a_g, a_c, rtol=1e-3, atol=2e-3).all(-1).mean()
    log(f"GPU vs CPU museum {W}x{H} 1 spp: per-path agreement {close:.4f}, "
        f"mean {a_g.mean(0).tolist()} vs {a_c.mean(0).tolist()}, "
        f"prim tests {k_g} vs {k_c}")
    if not (np.array_equal(c_g, c_c) and close >= 0.99):
        raise AssertionError("GPU and CPU renders disagree")


def png_pixels(data: bytes) -> np.ndarray:
    """Decode an 8-bit RGB PNG as written by ``utils.png`` (filter 0)."""
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    return raw[:, 1:].reshape(h, w, 3)


def cli_render(scene_id: int, extra=("--ticks", "65536")):
    """Render ``scene_id`` at 512x512 through the CLI in a process of its
    own, with the ``extra`` arguments, and check the PNG is not black."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, f"scene{scene_id}.png")
        cmd = [sys.executable, "-m", "wasm_pathtracer_tpu_torch.runtime.cli",
               "--scene", str(scene_id), "--width", "512", "--height", "512",
               *extra, "--out", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode != 0:
            raise AssertionError(f"CLI failed ({proc.returncode}): {proc.stderr[-2000:]}")
        img = png_pixels(open(out, "rb").read())
        log(f"CLI scene {scene_id} {' '.join(extra)}: {img.shape} PNG in {time.perf_counter() - t0:.1f} s, "
            f"mean {img.mean():.2f}, non-zero pixels {(img.max(-1) > 0).mean():.3f}")
        if img.shape != (512, 512, 3) or img.max() == 0:
            raise AssertionError("CLI wrote a black or misshapen PNG")


def phase_cli(device, record):
    cli_render(0)


def phase_cli_cloud(device, record):
    cli_render(5)


# ---------------------------------------------------------------------------
# the mesh path
# ---------------------------------------------------------------------------

MESH = dict(width=512, height=512, max_bounces=8, S=524_288, B=16_384)
# the JAX bench's mesh70k camera (bench.py)
MESH_CAMERA = dict(location=(0.0, 1.0, -6.0), rot_x=0.1, rot_y=0.0)


def mesh70k(device):
    """The JAX bench's mesh70k scene (70,312 mesh triangles, two light
    triangles, a plane) and its prep with the default cluster structure:
    550 clusters of 128, the plane left dense."""
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.ops import bvh, trace
    scene = scenes.mesh_scene(scenes.surface_mesh(188), device)
    return scene, bvh.attach_clusters(trace.prepare(scene), scene)


def museum_clustered(device):
    """The museum with every finite family clustered except its 108 light
    triangles: tori and aarects in one mixed cluster, 109 shapes dense."""
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.ops import bvh, trace
    scene = scenes.museum(device)
    return scene, bvh.attach_clusters(trace.prepare(scene), scene, min_count=1,
                                      exclude_lights=True)


def mesh_camera(device):
    from wasm_pathtracer_tpu_torch.models.camera import Camera
    return Camera.create(**MESH_CAMERA, device=device)


def check_select(cs, o, d, out_k, out_p, what):
    """Hold a select's (e_cur, c_cur, e_b, c_b, e_after) against its plain
    version's.  Returns (max |entry difference|, ids that differ on a
    rounding tie)."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import cluster as cl
    worst = 0.0
    for ek, ep in zip(out_k[0::2], out_p[0::2]):
        fin_k, fin_p = torch.isfinite(ek), torch.isfinite(ep)
        both = fin_k & fin_p
        agree = (fin_k == fin_p).float().mean().item()
        if not (agree > 0.999 and torch.allclose(ek[both], ep[both], rtol=1e-5,
                                                 atol=1e-5)):
            raise AssertionError(f"{what}: entries disagree (finiteness agreement "
                                 f"{agree:.6f})")
        if both.any():
            worst = max(worst, (ek[both] - ep[both]).abs().max().item())
    ties = 0
    for ck, cp, ek, ep in zip(out_k[1:4:2], out_p[1:4:2], out_k[0:4:2], out_p[0:4:2]):
        idx = torch.nonzero(torch.isfinite(ek) & torch.isfinite(ep) & (ck != cp))[:, 0]
        if idx.numel():
            ent = cl._rays_vs_boxes(o[idx], d[idx], cs.lo, cs.hi)
            rows = torch.arange(idx.numel(), device=o.device)
            a, b = ent[rows, ck[idx].long()], ent[rows, cp[idx].long()]
            if not torch.isclose(a, b, rtol=1e-5, atol=1e-5).all():
                raise AssertionError(f"{what}: cluster ids differ off a tie")
            ties += idx.numel()
    return worst, ties


def check_probe(cs, o, d, cidx, out_k, out_p, what, atol=1e-5):
    """Hold one probe round's (t, sid) against its plain version's: hits
    agree on > 99.9% of rays, t within rtol 1e-5 and ``atol`` (a number,
    or one per ray), a shape id may differ only where the two slots'
    distances tie within that tolerance.  Returns (max |dt|, ids that
    differ on a rounding tie, hit rate)."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import cluster as cl
    (t_k, s_k), (t_p, s_p) = out_k, out_p
    atol = torch.as_tensor(atol, device=o.device).expand(o.shape[0])

    def close(a, b, rows):
        return bool(((a - b).abs() <= atol[rows] + 1e-5 * b.abs()).all())

    fin_k, fin_p = torch.isfinite(t_k), torch.isfinite(t_p)
    both = fin_k & fin_p
    agree = (fin_k == fin_p).float().mean().item()
    if not (agree > 0.999 and close(t_k[both], t_p[both], both)
            and bool((s_k[~fin_k] == -1).all())):
        bad = both & ((t_k - t_p).abs() > atol + 1e-5 * t_p.abs())
        raise AssertionError(
            f"{what}: distances disagree (hit agreement {agree:.6f}; {int(bad.sum())} rays "
            f"beyond the tolerance, max |dt| {(t_k - t_p)[bad].abs().max().item() if bad.any() else 0:.3g}, "
            f"their origins up to {o[bad].abs().max().item() if bad.any() else 0:.6g} out)")
    worst = (t_k[both] - t_p[both]).abs().max().item() if both.any() else 0.0
    idx = torch.nonzero(both & (s_k != s_p))[:, 0]
    if idx.numel():
        c = cidx[idx].long().clamp(0, cs.num_clusters - 1)
        t_slots = cl._block_test(o[idx], d[idx], cs.blocks[c], cs.btype[c], cs.families)
        grid = cs.slot_to_sid.view(cs.num_clusters, cs.group)[c]
        jk = (grid == s_k[idx, None]).int().argmax(1)
        jp = (grid == s_p[idx, None]).int().argmax(1)
        rows = torch.arange(idx.numel(), device=o.device)
        if not close(t_slots[rows, jk], t_slots[rows, jp], idx):
            raise AssertionError(f"{what}: shape ids differ off a tie")
    return worst, idx.numel(), fin_p.float().mean().item()


def cancellation_atol(cs, o, d, cidx, sid, ulps=32):
    """(R,) t tolerance of one probe round: 1e-5, or where the plain
    version's hit (shape id ``sid`` in cluster ``cidx``) is a triangle and
    it is larger, ``ulps`` units in the last place of the largest
    coordinate of the origin and the triangle over |cos| of the angle
    between the ray and the triangle's normal.  t = (n.v0 - n.o) / (n.d)
    cancels terms of that size in the kernel's staged form and the plain
    version alike, and the grazing ray divides what is left by the
    cosine: bounce rays leave surfaces up to ~10^5 units out (grazing
    ground hits), and some skim the mesh next to their origin."""
    import torch
    C, G = cs.num_clusters, cs.group
    c = cidx.long().clamp(0, C - 1)
    j = (cs.slot_to_sid.view(C, G)[c] == sid.long()[:, None]).int().argmax(1)
    v = cs.blocks[c, j].view(-1, 3, 3)
    tri = (cs.btype[c, j] == 2) & (sid >= 0)
    n = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    cos = (n * d).sum(-1).abs() / n.norm(dim=-1).clamp(min=1e-30)
    big = torch.maximum(o.abs().amax(dim=1), v.abs().amax(dim=(1, 2)))
    ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
    atol = torch.clamp(ulps * ulp / cos.clamp(min=1e-30), min=1e-5)
    return torch.where(tri, atol, torch.full_like(atol, 1e-5))


def check_probe_blocks(cs, o, d, cidx, what):
    """Hold K7's (R, G) distances against its plain version's: finiteness
    equal on > 99.9% of the entries, values within rtol 1e-5 / atol 1e-5
    where both are finite, and the minimum over G equal to K5's t on the
    same inputs (K5's torus skip is exact, so the two agree bit for bit).
    Returns max |dt|."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
    t_k = pk.probe_blocks(cs, o, d, cidx)
    t_p = pk.probe_blocks_reference(cs, o, d, cidx)
    t5 = pk.probe_min(cs, o, d, cidx)[0]
    torch.cuda.synchronize()
    fin_k, fin_p = torch.isfinite(t_k), torch.isfinite(t_p)
    both = fin_k & fin_p
    agree = (fin_k == fin_p).float().mean().item()
    if t_k.shape != (o.shape[0], cs.group) or not (
            agree > 0.999 and torch.allclose(t_k[both], t_p[both], rtol=1e-5, atol=1e-5)):
        raise AssertionError(f"{what}: distances disagree (finiteness agreement "
                             f"{agree:.6f})")
    if not torch.equal(t_k.amin(dim=1), t5):
        raise AssertionError(f"{what}: min over the slots differs from K5's t")
    return (t_k[both] - t_p[both]).abs().max().item() if both.any() else 0.0


# the K4 call of a mesh70k flat run (of 168) whose inputs phase clusters
# checks and times: the middle one
FLAT_CALL = 84


@functools.cache
def flat_inputs(device):
    """(cluster set, o, d, c1, c2) of call ``FLAT_CALL`` of K4 in one run of
    phase 10's path (mesh70k through ``render_queue_flat``)."""
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
    from wasm_pathtracer_tpu_torch.ops import wavefront
    h = MESH
    scene, prep = mesh70k(device)
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=h["max_bounces"])
    with eager_queue(), recorded_calls(pk, {"probe_pair": FLAT_CALL}) as got:
        wavefront.render_queue_flat(prep, scene, st, mesh_camera(device),
                                    headline_queue(device, h["S"]), h["width"],
                                    h["height"], 4, h["B"])
        torch.cuda.synchronize()
    if not got:
        raise AssertionError(f"the flat run made fewer than {FLAT_CALL + 1} K4 calls")
    return got["probe_pair"]


def probe_bounds(cs, o, c1, c2=None):
    """(bound_ms, bound_by) of K4 (two rounds, ``c2`` given), K5 and K7 on
    these inputs."""
    B, table = o.shape[0], 4 * cs.table.numel()
    probe = probe_flops(cs, c1)
    bounds = {"probe_min": bound(probe, B * 24 + B * 4 + table + B * 8),
              "probe_blocks": bound(probe, B * 24 + B * 4 + table + B * cs.group * 4)}
    if c2 is not None:
        bounds["probe_pair"] = bound(probe + probe_flops(cs, c2),
                                     B * 24 + B * 8 + table + B * 16)
    return bounds


def check_flat_inputs(device, record):
    """K4 against its plain version on the inputs of one call of the
    mesh70k flat path, under phase 9's rule with t's tolerance from
    ``cancellation_atol``, and its times there.  Returns max |dt|."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
    cs, o, d, c1, c2 = flat_inputs(device)
    out_k = pk.probe_pair(cs, o, d, c1, c2)
    out_p = pk.probe_pair_reference(cs, o, d, c1, c2)
    torch.cuda.synchronize()
    worst = 0.0
    for rnd, c, k, p in ((1, c1, out_k[:2], out_p[:2]), (2, c2, out_k[2:], out_p[2:])):
        atol = cancellation_atol(cs, o, d, c, p[1])
        err, ties, rate = check_probe(cs, o, d, c, k, p,
                                      f"K4 flat path call {FLAT_CALL} round {rnd}", atol)
        worst = max(worst, err)
        both = torch.isfinite(p[0]) & torch.isfinite(k[0])
        beyond = both & ((k[0] - p[0]).abs() > 1e-5 + 1e-5 * p[0].abs())
        log(f"K4 flat path call {FLAT_CALL} round {rnd}: max |dt| {err:.3g}, {ties} ties, "
            f"hit rate {rate:.3f}; {int(beyond.sum())} of {int(both.sum())} hits beyond "
            f"rtol/atol 1e-5, within their cancellation tolerance (up to "
            f"{atol[beyond].max().item() if beyond.any() else 0:.3g}; origins up to "
            f"{o[beyond].abs().max().item() if beyond.any() else 0:.6g} out)")
    ms = cuda_ms(lambda: pk.probe_pair(cs, o, d, c1, c2), 20)
    plain_ms = cuda_ms(lambda: pk.probe_pair_reference(cs, o, d, c1, c2), 3, graph=False)
    b_ms, b_by = probe_bounds(cs, o, c1, c2)["probe_pair"]
    log(f"K4 flat path call {FLAT_CALL} B={o.shape[0]}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by} ({100 * b_ms / ms:.1f}% of "
        f"the kernel's time); SM clock now / max {sm_clocks()}")
    rec = record.setdefault("probe_pair", {})
    rec.setdefault("other_shapes", {})["flat_path_inputs"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    return worst


def phase_cluster_kernels(device, record):
    """K3-K7 against their plain versions on three cluster sets, and K4
    on the flat path's own inputs."""
    import torch
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera
    from wasm_pathtracer_tpu_torch.ops import bvh, trace
    from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
    big = scenes.cloud(300_000, device=device)
    sets = {"mesh70k": (mesh70k(device)[1], mesh_camera(device)),
            "cloud300k": (bvh.attach_clusters(trace.prepare(big), big),
                          initial_camera(5, device)),
            "museum_clustered": (museum_clustered(device)[1], initial_camera(0, device))}
    errs = {name: 0.0 for name in ("select_scan", "probe_pair", "probe_min",
                                   "select_blocks", "probe_blocks")}
    for i, (name, (prep, cam)) in enumerate(sets.items()):
        cs = prep.cluster
        o, d = test_rays(16_384 + 37, 400 + i, device, cam)
        R = o.shape[0]
        fresh_e = torch.full((R,), -torch.inf, device=device)
        fresh_c = torch.full((R,), -1, dtype=torch.int32, device=device)
        e0, c0 = pk.select_blocks_reference(cs, o, d, fresh_e, fresh_c)[:2]
        # every other ray continues after its first candidate
        cont = (torch.arange(R, device=device) % 2 == 0) & torch.isfinite(e0)
        skip_e = torch.where(cont, e0, -torch.inf).contiguous()
        skip_c = torch.where(cont, c0, -1).to(torch.int32).contiguous()
        sel_p = pk.select_blocks_reference(cs, o, d, skip_e, skip_c)
        err, ties = check_select(cs, o, d, pk.select_blocks(cs, o, d, skip_e, skip_c),
                                 sel_p, f"K6 {name}")
        errs["select_blocks"] = max(errs["select_blocks"], err)
        msg = (f"{name}: C={cs.num_clusters}, dense {sum(prep.tables.counts)}, "
               f"families {cs.families}; K6 max |de| {err:.3g}, {ties} id ties, "
               f"entry rate {torch.isfinite(sel_p[0]).float().mean().item():.3f}")
        if pk.dense_scan_ok(prep):
            scan_k = pk.select_scan(cs, prep, o, d, skip_e, skip_c)
            scan_p = pk.select_scan_reference(cs, prep, o, d, skip_e, skip_c)
            err, ties = check_select(cs, o, d, scan_k[:5], scan_p[:5], f"K3 {name}")
            (t_k, s_k), (t_p, s_p) = scan_k[5:], scan_p[5:]
            hit_k, hit_p = s_k >= 0, s_p >= 0
            both = hit_k & hit_p
            hit_agree = (hit_k == hit_p).float().mean().item()
            sid_agree = (s_k == s_p)[both].float().mean().item() if both.any() else 1.0
            if not (hit_agree > 0.999 and sid_agree > 0.995 and torch.allclose(
                    t_k[both], t_p[both], rtol=1e-5, atol=1e-4)):
                raise AssertionError(f"K3 {name}: dense hits disagree")
            if both.any():
                err = max(err, (t_k[both] - t_p[both]).abs().max().item())
            errs["select_scan"] = max(errs["select_scan"], err)
            msg += (f"; K3 max err {err:.3g}, {ties} id ties, dense hit agreement "
                    f"{hit_agree:.6f}")
        c1, c2 = sel_p[1].contiguous(), sel_p[3].contiguous()
        pair_k = pk.probe_pair(cs, o, d, c1, c2)
        pair_p = pk.probe_pair_reference(cs, o, d, c1, c2)
        for rnd, c, k, p in ((1, c1, pair_k[:2], pair_p[:2]), (2, c2, pair_k[2:], pair_p[2:])):
            err, ties, rate = check_probe(cs, o, d, c, k, p, f"K4 {name} round {rnd}")
            errs["probe_pair"] = max(errs["probe_pair"], err)
            msg += f"; K4 round {rnd} max |dt| {err:.3g}, {ties} ties, hit rate {rate:.3f}"
        err, ties, _ = check_probe(cs, o, d, c1, pk.probe_min(cs, o, d, c1), pair_p[:2],
                                   f"K5 {name}")
        errs["probe_min"] = max(errs["probe_min"], err)
        err7 = check_probe_blocks(cs, o, d, c1, f"K7 {name}")
        errs["probe_blocks"] = max(errs["probe_blocks"], err7)
        log(msg + f"; K5 max |dt| {err:.3g}, {ties} ties; K7 max |dt| {err7:.3g}")
        if name == "museum_clustered":
            continue
        log(f"{name}: device memory of the cluster tables: 11-row table "
            f"{4 * cs.table.numel() / 1e6:.3f} MB, staged triangles "
            f"{4 * cs.staged.numel() / 1e6:.3f} MB (C={cs.num_clusters}, G={cs.group})")

        # device times at B = 16,384 at both table sizes
        o16, d16 = o[:16_384], d[:16_384]
        se, sc, a, b = (x[:16_384] for x in (skip_e, skip_c, c1, c2))
        calls = {"select_blocks": (lambda: pk.select_blocks(cs, o16, d16, se, sc),
                                   lambda: pk.select_blocks_reference(cs, o16, d16, se, sc)),
                 "probe_pair": (lambda: pk.probe_pair(cs, o16, d16, a, b),
                                lambda: pk.probe_pair_reference(cs, o16, d16, a, b)),
                 "probe_min": (lambda: pk.probe_min(cs, o16, d16, a),
                               lambda: pk.probe_min_reference(cs, o16, d16, a)),
                 "probe_blocks": (lambda: pk.probe_blocks(cs, o16, d16, a),
                                  lambda: pk.probe_blocks_reference(cs, o16, d16, a))}
        if pk.dense_scan_ok(prep):
            calls["select_scan"] = (
                lambda: pk.select_scan(cs, prep, o16, d16, se, sc),
                lambda: pk.select_scan_reference(cs, prep, o16, d16, se, sc))
        times = {k: (cuda_ms(kern, 20), cuda_ms(plain, 3, graph=False))
                 for k, (kern, plain) in calls.items()}
        log(f"{name} B=16384 device ms (kernel, plain): " + ", ".join(
            f"{k} {ms:.4f} / {pms:.4f}" for k, (ms, pms) in times.items()))
        C, B = cs.num_clusters, 16_384
        slab = B * (C * FLOPS["box"] + FLOPS["recip"])
        rays, boxes = B * 24, 4 * 6 * C
        bounds = {
            "select_blocks": bound(slab, rays + B * 8 + boxes + B * 20),
            "select_scan": bound(slab + scene_flops(prep.tables, o16, d16),
                                 rays + B * 8 + boxes + 4 * prep.tables.flat.numel()
                                 + B * 28),
            **probe_bounds(cs, o16, a, b)}
        for k, (ms, pms) in times.items():
            at = dict(ms=ms, plain_ms=pms, bound_ms=bounds[k][0], bound_by=bounds[k][1])
            if name == "mesh70k":
                record.setdefault(k, {}).update(at)
            else:   # the larger table: C = 2,344
                record.setdefault(k, {}).setdefault("other_shapes", {})[name] = at
        log(f"{name} bounds: " + ", ".join(f"{k} {v[0]:.5f} ms by {v[1]}"
                                           for k, v in bounds.items()))
    log(f"probe kernels built as {pk.launch_shape(16_384, 2)} (B=16384, two rounds)")
    errs["probe_pair"] = max(errs["probe_pair"], check_flat_inputs(device, record))
    for k, err in errs.items():
        record.setdefault(k, {})["max_abs_err"] = err


def phase_kernel_k8(device, record):
    """K8 against its plain version: mesh70k's 70,314 triangles and
    cloud300k's, 16,384 + 37 camera and random rays each.  Hits agree on
    > 99.9% of rays, t within rtol 1e-5 / atol 1e-5 where both hit, slots
    on > 99% (the rule of the JAX package's ``tests/test_pallas_dense.py``:
    the kernel's rsqrt and reciprocal are approximate, nvcc contracts to
    FMA, and the inside test runs on rows staged per triangle), a miss
    reads slot -1.  Device times at 16,384 rays on both, and the kernel's
    launch grid, registers and shared memory."""
    import torch
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera
    from wasm_pathtracer_tpu_torch.ops import trace
    from wasm_pathtracer_tpu_torch.ops import traverse_kernels as tk
    sets = {"mesh70k": (scenes.mesh_scene(scenes.surface_mesh(188), device),
                        mesh_camera(device)),
            "cloud300k": (scenes.cloud(300_000, device=device), initial_camera(5, device))}
    worst = 0.0
    rec = record.setdefault("dense_tri_nearest", {})
    for i, (name, (scene, cam)) in enumerate(sets.items()):
        rows = trace.prepare(scene, use_pallas=True).tri_rows
        o, d = test_rays(16_384 + 37, 500 + i, device, cam)
        t_k, s_k = tk.dense_tri_nearest(rows, o, d)
        t_p, s_p = tk.dense_tri_nearest_reference(rows, o, d)
        torch.cuda.synchronize()
        hit_k, hit_p = torch.isfinite(t_k), torch.isfinite(t_p)
        both = hit_k & hit_p
        hit_agree = (hit_k == hit_p).float().mean().item()
        err = (t_k[both] - t_p[both]).abs().max().item() if both.any() else 0.0
        slot_agree = (s_k == s_p)[both].float().mean().item() if both.any() else 1.0
        log(f"K8 {name}: T={rows.shape[0]}, hit agreement {hit_agree:.6f}, max |dt| "
            f"{err:.3g}, slot agreement {slot_agree:.6f}, hit rate "
            f"{hit_p.float().mean().item():.3f}")
        if not (hit_agree > 0.999 and slot_agree > 0.99
                and torch.allclose(t_k[both], t_p[both], rtol=1e-5, atol=1e-5)
                and bool((s_k[~hit_k] == -1).all())
                and bool(((s_k[hit_k] >= 0) & (s_k[hit_k] < rows.shape[0])).all())):
            raise AssertionError(f"K8 disagrees with its plain version on {name}")
        worst = max(worst, err)
        o16, d16 = o[:16_384].contiguous(), d[:16_384].contiguous()
        ms = cuda_ms(lambda: tk.dense_tri_nearest(rows, o16, d16), 5)
        plain_ms = cuda_ms(lambda: tk.dense_tri_nearest_reference(rows, o16, d16), 1, graph=False)
        b_ms, b_by = bound(rows.shape[0] * (16_384 * FLOPS[2] + FLOPS["tri_setup"]),
                           4 * rows.numel() + 16_384 * (24 + 8))
        log(f"K8 {name} B=16384: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms by {b_by} ({100 * b_ms / ms:.1f}% of the kernel's "
            f"time); launch {tk.launch_shape(rows.shape[0], 16_384)}; "
            f"SM clock now / max {sm_clocks()}")
        if name == "mesh70k":
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        else:
            rec["other_shapes"] = {name: dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                              bound_by=b_by)}
    rec["max_abs_err"] = worst


def phase_mesh_path(device, record):
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.ops import wavefront
    h = MESH
    scene, prep = mesh70k(device)
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=h["max_bounces"])
    launches, iters, rec = run_queue(
        f"mesh path: mesh70k ({scene.num_shapes} shapes, C={prep.cluster.num_clusters}, "
        f"dense {sum(prep.tables.counts)})", wavefront.render_queue_flat, prep, scene, st,
        mesh_camera(device), h, device)
    expect_launches(launches, iters, ("select_scan", "probe_pair", "fused_shade",
                                      "fused_regen"))
    for name in ("select_scan", "probe_pair"):
        record.setdefault(name, {})["launches"] = launches[name]
    record["mesh_path"] = rec


def agree_per_path(a, b, what):
    """Per-path radiance of two 1-spp renders (acc, cnt): counts equal and
    >= 99% of paths within rtol 1e-3 / atol 2e-3."""
    (a_acc, a_cnt), (b_acc, b_cnt) = ((x.cpu().numpy(), y.cpu().numpy()) for x, y in (a, b))
    close = np.isclose(a_acc, b_acc, rtol=1e-3, atol=2e-3).all(-1).mean()
    same = np.array_equal(a_cnt, b_cnt)
    log(f"{what}: counts equal {same}, per-path agreement {close:.4f}, mean "
        f"{a_acc.mean(0).tolist()} vs {b_acc.mean(0).tolist()}")
    if not (same and close >= 0.99):
        raise AssertionError(f"{what}: renders disagree")


def phase_mesh_gpu_vs_cpu(device, record):
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.ops import bvh, trace, wavefront
    W = H = 32
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=8)
    out = []
    for dev in (device, torch.device("cpu")):
        scene = scenes.mesh_scene(scenes.surface_mesh(24), dev)
        prep = bvh.attach_clusters(trace.prepare(scene), scene)
        acc, cnt, _ = wavefront.render_queue_flat(
            prep, scene, st, mesh_camera(dev), torch.arange(W * H, device=dev),
            W, H, SEED, 256)
        out.append((acc, cnt))
    agree_per_path(*out, f"GPU vs CPU mesh ({scene.num_shapes} shapes, "
                         f"C={prep.cluster.num_clusters}) {W}x{H} 1 spp")


def phase_lockstep(device, record):
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.ops import integrator, wavefront
    W = H = 64
    scene, prep = mesh70k(device)
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=8)
    pix = torch.arange(W * H, device=device)
    reset_counts()
    acc, cnt, _, iters = integrator.render_queue(prep, scene, st, mesh_camera(device),
                                                 pix, W, H, SEED, 1024, return_iters=True)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"lockstep mesh70k {W}x{H}: {iters} iterations, launches {launches}")
    expect_launches(launches, iters, ("fused_shade", "fused_regen"),
                    at_least_once=("fused_nearest", "probe_min"))
    record.setdefault("probe_min", {})["launches"] = launches["probe_min"]
    flat = wavefront.render_queue_flat(prep, scene, st, mesh_camera(device), pix, W, H,
                                       SEED, 1024)
    agree_per_path((acc, cnt), flat[:2], f"lockstep vs flat mesh70k {W}x{H} 1 spp")

    # the same lockstep trace probing with K7 and reducing outside the kernel
    import dataclasses
    prep7 = dataclasses.replace(prep, cluster=dataclasses.replace(
        prep.cluster, unreduced_probe=True))
    reset_counts()
    acc7, cnt7, _, iters7 = integrator.render_queue(
        prep7, scene, st, mesh_camera(device), pix, W, H, SEED, 1024, return_iters=True)
    torch.cuda.synchronize()
    launches7 = read_counts()
    log(f"lockstep with the unreduced probe: {iters7} iterations, launches {launches7}")
    expect_launches(launches7, iters7, ("fused_shade", "fused_regen"),
                    at_least_once=("fused_nearest", "probe_blocks"))
    if launches7["probe_blocks"] != launches["probe_min"] or iters7 != iters:
        raise AssertionError("the unreduced probe should run the reduced probe's rounds")
    record.setdefault("probe_blocks", {})["launches"] = launches7["probe_blocks"]
    agree_per_path((acc7, cnt7), (acc, cnt), f"unreduced vs reduced probe mesh70k {W}x{H}")


def phase_k6_path(device, record):
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera
    from wasm_pathtracer_tpu_torch.ops import integrator, probe_kernels as pk
    from wasm_pathtracer_tpu_torch.ops import trace, wavefront
    W = H = 64
    scene, prep = museum_clustered(device)
    if pk.dense_scan_ok(prep):
        raise AssertionError("the clustered museum's remainder should take K6")
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=8)
    cam = initial_camera(0, device)
    pix = torch.arange(W * H, device=device)
    reset_counts()
    acc, cnt, _, iters = wavefront.render_queue_flat(prep, scene, st, cam, pix, W, H,
                                                     SEED, 1024, return_iters=True)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"K6 path: museum clustered ({sum(prep.tables.counts)} dense, "
        f"C={prep.cluster.num_clusters}) {W}x{H}: {iters} iterations, launches {launches}")
    expect_launches(launches, iters, ("select_blocks", "fused_nearest", "probe_pair",
                                      "fused_shade", "fused_regen"))
    record.setdefault("select_blocks", {})["launches"] = launches["select_blocks"]
    ref = integrator.render_queue(trace.prepare(scene), scene, st, cam, pix, W, H,
                                  SEED, 1024)
    agree_per_path((acc, cnt), ref[:2], f"flat clustered vs dense museum {W}x{H} 1 spp")


def phase_sweep_path(device, record):
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.ops import integrator, trace
    h = MESH
    scene = scenes.mesh_scene(scenes.surface_mesh(188), device)
    prep = trace.prepare(scene, use_pallas=True)
    cam = mesh_camera(device)
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=h["max_bounces"])
    launches, iters, rec = run_queue(
        f"dense-sweep path: mesh70k ({prep.tri_rows.shape[0]} triangles swept, "
        f"{sum(prep.tables.counts)} shapes in K1's tables)",
        integrator.render_queue, prep, scene, st, cam, h, device)
    expect_launches(launches, iters, ("fused_shade", "fused_regen"),
                    twice_per_iteration=("dense_tri_nearest", "fused_nearest"))
    record.setdefault("dense_tri_nearest", {})["launches"] = launches["dense_tri_nearest"]
    short = headline_queue(device, 8 * h["B"])
    rec["device_busy_share"] = busy_share(lambda: integrator.render_queue(
        prep, scene, st, cam, short, h["width"], h["height"], 3, h["B"]),
        {"dense_tri_nearest": "dense_tri_kernel", "fused_nearest": "fused_nearest_kernel"})[0]
    log(f"dense-sweep path: device busy {100 * rec['device_busy_share']:.1f}% of wall "
        f"time under the profiler (S={short.numel()}; the trace holds every launch of "
        f"K8 and K1)")
    record["sweep_path"] = rec


def phase_bvh4(device, record):
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import primary_rays
    from wasm_pathtracer_tpu_torch.ops import bvh, integrator, trace, traverse
    W = H = 64
    scene = scenes.mesh_scene(scenes.surface_mesh(188), device)
    t0 = time.perf_counter()
    prep_bvh = bvh.attach_bvh(trace.prepare(scene), scene)
    t_build = time.perf_counter() - t0
    prep_sweep = trace.prepare(scene, use_pallas=True)
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=8)
    cam = mesh_camera(device)
    pix = torch.arange(W * H, device=device)
    n_tri = prep_bvh.idx_triangle.shape[0]

    half = torch.full((W * H,), 0.5, device=device)
    o, d = primary_rays(cam, pix % W, pix // W, half, half, W, H)
    no_hit = torch.full((W * H,), torch.inf, device=device)
    t_b, sid_b, visits = traverse.trace_bvh4(
        prep_bvh.bvh_bounds, prep_bvh.bvh_children, prep_bvh.bvh_prim_index,
        prep_bvh.bvh_tri_rows, o, d, no_hit)
    mean_visits = visits.float().mean().item()
    log(f"BVH4 mesh70k: {prep_bvh.bvh_children.shape[0]} nodes built in {t_build:.2f} s, "
        f"primary rays: mean visits {mean_visits:.1f}, max {int(visits.max())}, "
        f"{n_tri} triangles, hit rate {(sid_b >= 0).float().mean().item():.3f}")
    if not mean_visits < 0.01 * n_tri:
        raise AssertionError("the BVH walk visits too many nodes")

    reset_counts()
    t0 = time.perf_counter()
    out_b = integrator.render_queue(prep_bvh, scene, st, cam, pix, W, H, SEED, 1024,
                                    return_iters=True)
    torch.cuda.synchronize()
    t_bvh = time.perf_counter() - t0
    launches = read_counts()
    expect_launches(launches, out_b[3], ("fused_shade", "fused_regen"),
                    twice_per_iteration=("fused_nearest",))
    t0 = time.perf_counter()
    out_s = integrator.render_queue(prep_sweep, scene, st, cam, pix, W, H, SEED, 1024)
    torch.cuda.synchronize()
    log(f"BVH4 render {t_bvh:.2f} s ({out_b[3]} iterations), sweep render "
        f"{time.perf_counter() - t0:.2f} s")
    agree_per_path(out_b[:2], out_s[:2], f"BVH4 vs dense sweep mesh70k {W}x{H} 1 spp")


def phase_pnee(device, record):
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera
    from wasm_pathtracer_tpu_torch.ops import integrator, photon, trace
    h = HEADLINE
    scene = scenes.museum(device)
    prep = trace.prepare(scene)
    st = RenderSettings(render_type=RenderType.PNEE, max_bounces=h["max_bounces"])
    lo, hi = photon.grid_bounds_for_scene(scene, st)

    def fresh():
        return photon.PhotonGrid.create(scene.num_lights, lo, hi, st.photon_grid_res, device)

    batch = 65_536
    photon.emit_photons(fresh(), prep, scene, st, 0, batch)       # warm-up
    torch.cuda.synchronize()
    grid, shots, seed = fresh(), 0, 1
    reset_counts()
    t0 = time.perf_counter()
    while int(grid.num_photons) < st.total_photons and shots < 64 * batch:
        grid = photon.emit_photons(grid, prep, scene, st, seed, batch)
        seed += 1
        shots += batch
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    landed = int(grid.num_photons)
    launches = read_counts()
    log(f"photon emission: {landed} landed of {shots} shot in {dt:.3f} s, "
        f"{landed / dt:.1f} landed/s, {shots / dt:.1f} shot/s, launches {launches}, "
        f"bins max {grid.bins.max().item():.3g}")
    expect_launches(launches, shots // batch, ("fused_nearest",))
    if landed < st.total_photons or not bool(torch.isfinite(grid.bins).all()):
        raise AssertionError("the photon budget was not reached")

    launches, iters, rec = run_queue("museum PNEE", integrator.render_queue, prep, scene,
                                     st, initial_camera(0, device), h, device,
                                     photon_grid=grid)
    expect_launches(launches, iters, ("fused_nearest", "fused_occluded", "fused_shade",
                                      "fused_regen"))
    rec.update(photons_landed_per_sec=landed / dt, photons_shot_per_sec=shots / dt)
    record["pnee_path"] = rec


def phase_adaptive(device, record):
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.runtime.session import Session
    batch = 262_144
    aset = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=8, adaptive=True,
                          ray_batch_size=batch, regen_lanes=16_384,
                          adaptive_bootstrap_spp=1)
    sess = Session(1920, 1080, scene_id=0, left=aset, right=aset, device=device)
    hw = 960 * 1080
    n_boot = -(-hw // batch)                              # batches of the bootstrap
    reset_counts()
    t0 = time.perf_counter()
    traced = sess.compute(2 * n_boot * batch)
    torch.cuda.synchronize()
    t_boot = time.perf_counter() - t0
    cnt = sess.buffer.count
    covered = [float(cnt[:, :960].min()), float(cnt[:, 960:].min())]
    log(f"adaptive 1080p bootstrap: {traced} paths in {t_boot:.3f} s, "
        f"{traced / t_boot:.1f} paths/s, min samples per pixel (left, right) {covered}")
    if traced != 2 * n_boot * batch or min(covered) < 1:
        raise AssertionError("the bootstrap sweep left pixels unsampled")
    if len(np.unique(sess.density.reshape(-1, 3), axis=0)) != 1:
        raise AssertionError("the density view should be its baseline while bootstrapping")

    t0 = time.perf_counter()
    traced = sess.compute(4 * batch)                      # two steady batches a half
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    sweeps = [int(sess.left._sweep), int(sess.right._sweep)]
    colours = len(np.unique(sess.results(show_sampling=True).reshape(-1, 3), axis=0))
    # the excess mass the last batch's cumulative sum ran over
    from wasm_pathtracer_tpu_torch.ops import accum, adaptive
    sub = accum.AccumBuffer(acc=sess.buffer.acc[:, :960], count=sess.buffer.count[:, :960])
    excess = float((adaptive.target_spp(sub, aset.adaptive_spp_scale) - 1.0).sum())
    log(f"adaptive 1080p steady state: {traced} paths in {dt:.3f} s, "
        f"{traced / dt:.1f} paths/s, floor sweeps at {sweeps} of {hw}, density view "
        f"{colours} colours, left half's excess mass {excess:.0f} (2^24 = {1 << 24}), "
        f"launches {launches}, total samples {int(cnt.sum())}; {card_line()}")
    if traced != 4 * batch or int(cnt.sum()) != (2 * n_boot + 4) * batch:
        raise AssertionError("adaptive steps lost samples")
    if colours < 16 or min(sweeps) <= (n_boot * batch) % hw:
        raise AssertionError("the adaptive allocator did not take over")
    if not bool(torch.isfinite(sess.buffer.acc).all()):
        raise AssertionError("non-finite radiance")
    expect_launches(launches, 0, at_least_once=("fused_nearest", "fused_occluded",
                                                "fused_shade", "fused_regen"))
    record["adaptive_1080p"] = dict(paths_per_sec=traced / dt, seconds=dt,
                                    bootstrap_paths_per_sec=2 * n_boot * batch / t_boot,
                                    excess_mass=excess)


def phase_cli_views(device, record):
    cli_render(0, ["--ticks", "1572864", "--right-type", "2", "--right-adaptive",
                   "--show-sampling", "--max-bounces", "8"])
    cli_render(4, ["--debug-view", "bvh"])


# ---------------------------------------------------------------------------
# the gradient slice: render_pixels under autograd, the train step, the warps
# ---------------------------------------------------------------------------

GRAD = dict(width=512, height=512, max_bounces=8, calls=3)
# the K1 and K2 calls of a gradient step (of 16 each) whose inputs phase
# grad checks: bounce 3 of the forward pass
GRAD_CALL = 3
# the K1 (of 32) and K5 (of ~900) calls of a mesh70k light step whose
# inputs phase train checks: bounce 2's nearest hit, an early round of
# the first cluster trace (most rays still probing) and a middle round
TRAIN_CALLS = ({"fused_nearest": 4, "probe_min": 8}, {"probe_min": 450})


def _museum_leaves(scene, cam, device):
    """Fresh leaf tensors for the museum's albedo and camera."""
    from wasm_pathtracer_tpu_torch.models.camera import Camera
    leaves = dict(albedo=scene.albedo.clone(), location=cam.location.clone(),
                  rot_x=cam.rot_x.clone(), rot_y=cam.rot_y.clone())
    for x in leaves.values():
        x.requires_grad_(True)
    return (scene.with_materials(albedo=leaves["albedo"]),
            Camera(leaves["location"], leaves["rot_x"], leaves["rot_y"]), leaves)


def grad_call(prep, scene, st, cam, px, py, w, h, seed, mask=None):
    """One step of the backward cell: loss mean(col^2) (over ``mask``'s
    pixels where given) and its gradients with respect to the museum's
    albedo and the camera.  Returns (col, {leaf: grad})."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import integrator
    sc, c, leaves = _museum_leaves(scene, cam, px.device)
    col, _ = integrator.render_pixels(prep, sc, st, c, px, py, w, h, seed)
    err = col ** 2 if mask is None else col ** 2 * mask[:, None]
    grads = torch.autograd.grad(err.sum() / (w * h), list(leaves.values()))
    return col.detach(), dict(zip(leaves, grads))


def phase_grad(device, record):
    """The backward cell at full width: museum, 512x512 = 262,144 rays,
    NEE, 8 bounces, loss mean(col^2), gradients with respect to albedo and
    camera, with per-bounce checkpointing on and then off.  Then K1 and
    K2 against their plain versions on the arguments of call
    ``GRAD_CALL`` of the checkpointed step whose launches were counted."""
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera
    from wasm_pathtracer_tpu_torch.ops import integrator, trace
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    g = GRAD
    w, h = g["width"], g["height"]
    scene = scenes.museum(device)
    prep, cam = trace.prepare(scene), initial_camera(0, device)
    pix = torch.arange(w * h, device=device)
    px, py = pix % w, pix // w
    rec, grads = {}, {}
    for remat in (True, False):
        st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=g["max_bounces"],
                            checkpoint_bounces=remat)
        key = "remat" if remat else "noremat"

        def fwd():
            with torch.no_grad():
                return integrator.render_pixels(prep, scene, st, cam, px, py, w, h, SEED)[0]

        fwd()
        grad_call(prep, scene, st, cam, px, py, w, h, SEED)        # warm-up
        torch.cuda.synchronize()
        reset_counts()
        fwd()
        torch.cuda.synchronize()
        fwd_launches = read_counts()
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        with recorded_calls(sk, {"fused_nearest": GRAD_CALL,
                                 "fused_occluded": GRAD_CALL}) as got:
            col, grads[key] = grad_call(prep, scene, st, cam, px, py, w, h, SEED)
            torch.cuda.synchronize()
        launches = read_counts()
        if remat:
            path_inputs, path_launches = got, launches
        peak = torch.cuda.max_memory_allocated(device)
        expect_launches(launches, 0, at_least_once=("fused_nearest", "fused_occluded"))
        for name in ("fused_nearest", "fused_occluded"):
            n, n_fwd = launches[name], fwd_launches[name]
            ok = n_fwd < n <= 2 * n_fwd if remat else n == n_fwd
            if not ok:
                raise AssertionError(f"grad {key}: {name} launched {n} times in a step, "
                                     f"{n_fwd} in the forward alone")
        if not (bool(torch.isfinite(col).all())
                and all(bool(torch.isfinite(x).all()) for x in grads[key].values())):
            raise AssertionError(f"grad {key}: non-finite radiance or gradient")
        times, fwd_times = [], []
        for _ in range(g["calls"]):
            t0 = time.perf_counter()
            grad_call(prep, scene, st, cam, px, py, w, h, SEED)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            fwd_times.append(time.perf_counter() - t0)
        # the re-evaluation's share of a step: the same step with the
        # winners' distances left detached (the gradient then misses the
        # hit distances' terms; only its time is read)
        bare = []
        real_winner_t = trace.winner_t
        trace.winner_t = lambda prep_, scene_, o, d, t_, sid: t_
        try:
            for _ in range(g["calls"]):
                t0 = time.perf_counter()
                grad_call(prep, scene, st, cam, px, py, w, h, SEED)
                torch.cuda.synchronize()
                bare.append(time.perf_counter() - t0)
        finally:
            trace.winner_t = real_winner_t
        t, tf, tb = (float(np.median(x)) for x in (times, fwd_times, bare))
        rec[key] = dict(grad_rays_per_sec=w * h / t, forward_rays_per_sec=w * h / tf,
                        grad_seconds=times, forward_seconds=fwd_times,
                        reeval_share=1.0 - tb / t, seconds_without_reeval=bare,
                        max_memory_allocated=peak, launches_per_step=launches,
                        forward_launches=fwd_launches)
        log(f"grad {key}: museum {w}x{h} NEE {g['max_bounces']} bounces, {w * h} rays: "
            f"grad {w * h / t:.1f} rays/s (median of {times}), forward {w * h / tf:.1f} "
            f"rays/s (median of {fwd_times}), re-evaluation {100 * (1 - tb / t):.1f}% of "
            f"a step (without it {bare}), max memory {peak / 2**30:.3f} GiB, launches "
            f"per step {launches} (forward alone {fwd_launches}); {card_line()}")
    for k in grads["remat"]:
        a, b = grads["remat"][k], grads["noremat"][k]
        scale = float(b.abs().max())
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-6 * scale):
            raise AssertionError(f"grad: {k} differs with and without checkpointing "
                                 f"(max |diff| {float((a - b).abs().max()):.3g})")
    log("grad: gradients with and without checkpointing agree (rtol 1e-5)")
    record["grad_path"] = rec
    check_path_inputs(record, path_inputs, f"grad path call {GRAD_CALL}", path_launches)


def check_path_inputs(record, got, what, launches):
    """K1, K2 and K5 against their plain versions on the arguments ``got``
    (``recorded_calls``) of one call of a path, at the path's own shapes,
    and their times there; ``launches`` are the counts of the run that
    made the call."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
    log(f"{what}: checking {sorted(got)} on the arguments of a run whose launches were "
        f"{launches}")
    key = what.replace(" ", "_")
    if "fused_nearest" in got:
        tables, o, d, sid_map = got["fused_nearest"]
        err, _ = check_nearest(tables, o, d, sid_map, what)
        rec = record.setdefault("fused_nearest", {})
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
        rec.setdefault("other_shapes", {})[key] = timed_nearest(tables, o, d, sid_map, what)
    if "fused_occluded" in got:
        tables, o, d, dist, lsid, code_of = got["fused_occluded"]
        err = check_occluded(tables, o, d, dist, lsid, code_of, what)
        rec = record.setdefault("fused_occluded", {})
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
        rec.setdefault("other_shapes", {})[key] = timed_occluded(
            tables, code_of, (o, d, dist, lsid), what)
    if "probe_min" in got:
        cs, o, d, cidx = got["probe_min"]
        out_k = pk.probe_min(cs, o, d, cidx)
        out_p = pk.probe_min_reference(cs, o, d, cidx)
        torch.cuda.synchronize()
        atol = cancellation_atol(cs, o, d, cidx, out_p[1])
        err, ties, rate = check_probe(cs, o, d, cidx, out_k, out_p, f"K5 {what}", atol)
        ms = cuda_ms(lambda: pk.probe_min(cs, o, d, cidx), 20)
        plain_ms = cuda_ms(lambda: pk.probe_min_reference(cs, o, d, cidx), 3, graph=False)
        b_ms, b_by = probe_bounds(cs, o, cidx)["probe_min"]
        log(f"K5 {what} B={o.shape[0]}: max |dt| {err:.3g}, {ties} ties, hit rate "
            f"{rate:.3f}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
            f"by {b_by}; SM clock now / max {sm_clocks()}")
        rec = record.setdefault("probe_min", {})
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
        rec.setdefault("other_shapes", {})[key] = dict(ms=ms, plain_ms=plain_ms,
                                                       bound_ms=b_ms, bound_by=b_by)


def phase_grad_gpu_vs_cpu(device, record):
    """The gradient path on the card (K1/K2 decide, the winners'
    distances re-evaluated) against the port on the CPU (plain versions):
    museum 64x64, 4 bounces.  Paths whose radiance differs (a discrete
    decision taken the other way on float rounding) must be <= 0.1%; the
    albedo and camera gradients of mean(col^2) over the other paths agree
    at rtol 1e-3."""
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera
    from wasm_pathtracer_tpu_torch.ops import trace
    W = H = 64
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=4)
    setups = {}
    for key, dev in (("card", device), ("cpu", torch.device("cpu"))):
        scene = scenes.museum(dev)
        pix = torch.arange(W * H, device=dev)
        setups[key] = (trace.prepare(scene), scene, st, initial_camera(0, dev), pix % W,
                       pix // W, W, H, SEED)
    cols = {k: grad_call(*s)[0].cpu() for k, s in setups.items()}
    same = torch.isclose(cols["card"], cols["cpu"], rtol=1e-3, atol=1e-4).all(-1)
    share = 1.0 - same.float().mean().item()
    grads = {k: grad_call(*s, mask=same.to(s[4].device).float())[1]
             for k, s in setups.items()}
    worst = {}
    for k in grads["cpu"]:
        a, b = grads["card"][k].cpu(), grads["cpu"][k]
        worst[k] = float(((a - b).abs() / (b.abs() + 1e-3 * b.abs().max())).max())
    log(f"grad GPU vs CPU museum {W}x{H} {st.max_bounces} bounces: paths that differ "
        f"{share:.5f} ({int((~same).sum())} of {W * H}); gradients over the others, max "
        f"|diff| / (|cpu| + 1e-3 max|cpu|): {worst}")
    record["grad_gpu_vs_cpu"] = dict(paths_differ_share=share, worst_rel=worst)
    if share > 1e-3:
        raise AssertionError("grad GPU vs CPU: more than 0.1% of paths differ")
    if max(worst.values()) > 1e-3:
        raise AssertionError("grad GPU vs CPU: gradients disagree beyond rtol 1e-3")


def phase_train(device, record):
    """``make_train_step`` on the card: the museum at 512x512 with albedo
    and camera (3 SGD steps), then mesh70k with its lights out of the
    cluster tables and the light rows trained (2 steps).  In the last
    light step, K1 and K5 against their plain versions on the arguments
    of calls ``TRAIN_CALLS``; the tables that step gathered for K1 equal
    a fresh prep's of the moved scene it was given, and K1 on them
    agrees with its plain version on rays aimed at the moved light, and
    hits it."""
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera
    from wasm_pathtracer_tpu_torch.ops import bvh, integrator, trace
    from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    from wasm_pathtracer_tpu_torch.parallel import make_ray_mesh, make_train_step
    g = GRAD
    w, h = g["width"], g["height"]
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=g["max_bounces"])
    rec = {}

    def run(what, step, scene, cam, target, n_steps, leaves, once, which=()):
        """``n_steps`` steps from (scene, cam); the last one records, for
        each dict of ``which``, those calls of K1 and K5 (one dict of
        arguments each).  Returns the last step's scene, the scene it
        returned, the per-step records and the recorded calls."""
        per_step = []
        for k in range(n_steps):
            torch.cuda.synchronize()
            reset_counts()
            recs = []
            with contextlib.ExitStack() as stack:
                for calls in (which if k == n_steps - 1 else ()):
                    recs.append({})
                    for module, names in ((sk, ("fused_nearest",)), (pk, ("probe_min",))):
                        recs[-1][module] = stack.enter_context(recorded_calls(
                            module, {n: c for n, c in calls.items() if n in names}))
                t0 = time.perf_counter()
                loss, scene2, cam2 = step(scene, cam, target, 100 + k)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            got = [{n: a for r in rec.values() for n, a in r.items()} for rec in recs]
            launches = read_counts()
            expect_launches(launches, 0, at_least_once=once)
            moved = {n: float((get(scene2, cam2) - get(scene, cam)).abs().max())
                     for n, get in leaves.items()}
            log(f"train {what} step {k}: loss {float(loss):.6g}, {dt:.3f} s, leaves moved "
                f"by {moved}, launches {launches}")
            if not (np.isfinite(float(loss)) and all(m > 0 for m in moved.values())):
                raise AssertionError(f"train {what}: step {k} is not finite or moved nothing")
            per_step.append(dict(loss=float(loss), seconds=dt, launches=launches))
            last, scene, cam = scene, scene2, cam2
        return last, scene, per_step, got

    scene = scenes.museum(device)
    prep, cam = trace.prepare(scene), initial_camera(0, device)
    pix = torch.arange(w * h, device=device)
    with torch.no_grad():
        target = integrator.render_pixels(prep, scene, st, cam, pix % w, pix // w, w, h,
                                          1)[0].reshape(h, w, 3)
    start = scene.with_materials(albedo=torch.clamp(scene.albedo * 0.8, 0.0, 1.0))
    lone = make_ray_mesh(device=device)
    step = make_train_step(lone, prep, st, w, h, lr=1e-3)
    rec["museum"] = run(
        "museum albedo+camera", step, start, cam, target, 3,
        dict(albedo=lambda s, c: s.albedo, rot_x=lambda s, c: c.rot_x),
        ("fused_nearest", "fused_occluded"))[2]
    rec["museum_early_exit"] = train_early_exit_ab(step, start, cam, target)

    mesh = scenes.mesh_scene(scenes.surface_mesh(188), device)
    mprep = bvh.attach_clusters(trace.prepare(mesh), mesh, exclude_lights=True)
    if mprep.cluster is None or mprep.cluster.has_baked_lights:
        raise AssertionError("mesh70k: the lights must stay out of the cluster tables")
    step = make_train_step(lone, mprep, st, w, h, lr=0.05, train_lights=True,
                           train_materials=False, train_camera=False)
    lid = mesh.light_shape.long()
    given, _, rec["mesh70k_lights"], got = run(
        "mesh70k lights", step, mesh, mesh_camera(device),
        torch.zeros((h, w, 3), device=device) + 0.3, 2,
        dict(light_rows=lambda s, c: s.params[lid]), ("fused_nearest", "probe_min"),
        TRAIN_CALLS)
    for calls, args in zip(TRAIN_CALLS, got):
        if set(args) != set(calls):
            raise AssertionError(f"train: the light step made too few calls to record "
                                 f"{calls} (recorded {sorted(args)})")
        check_path_inputs(record, args, "train light step " + " ".join(
            f"{n} call {c}" for n, c in calls.items()), rec["mesh70k_lights"][-1]["launches"])

    # the tables the last step gathered trace the light where the step
    # before it moved it
    tables, _, _, sid_map = got[0]["fused_nearest"]
    fresh = trace.prepare_from_sets(given, [getattr(mprep, a) for a in trace.INDEX_FIELDS])
    if not torch.equal(tables.flat, fresh.tables.flat):
        raise AssertionError("train: the step's tables are not the moved scene's")
    if torch.equal(tables.flat, mprep.tables.flat):
        raise AssertionError("train: the light did not move in the step's tables")
    c = given.params[lid][:, :9].reshape(-1, 3, 3).mean(1)
    r = torch.randn((4096, 3), generator=torch.Generator().manual_seed(3)).to(device)
    tgt = c[torch.arange(4096, device=device) % c.shape[0]] + 0.2 * r * torch.tensor(
        [1.0, 0.0, 1.0], device=device)
    o = tgt - torch.tensor([0.0, 4.0, 0.0], device=device) + 0.5 * r
    d = tgt - o
    d = (d / d.norm(dim=-1, keepdim=True)).contiguous()
    o = o.contiguous()
    check_nearest(tables, o, d, sid_map, "moved light (the step's tables)")
    _, sid = sk.fused_nearest(tables, o, d, sid_map)
    on_light = torch.isin(sid, lid).float().mean().item()
    log(f"train: {on_light:.3f} of the rays aimed at the moved light hit it")
    if on_light < 0.5:
        raise AssertionError("train: the step's tables miss the moved light")
    record["train"] = rec


def train_early_exit_ab(step, scene, cam, target):
    """The museum step as ``make_train_step`` builds it (every bounce
    runs, ``early_exit=False``) against the same step with the host's
    early exit after each bounce, in turns (False, True, True, False),
    from the same leaves and seed: the losses must be bit-equal.
    Returns seconds and launches by setting."""
    import torch
    if step.settings.early_exit:
        raise AssertionError("make_train_step must run every bounce (early_exit=False)")
    out = {False: [], True: []}
    losses = {}
    for early_exit in (False, True, True, False):
        step.settings = step.settings.replace(early_exit=early_exit)
        (loss, _, _), dt, launches = counted_run(lambda: step(scene, cam, target, 7))
        losses.setdefault(early_exit, float(loss))
        out[early_exit].append(dict(seconds=dt, launches=launches))
    step.settings = step.settings.replace(early_exit=False)
    log(f"train museum early_exit A/B (same leaves, seed 7): every bounce "
        f"{[r['seconds'] for r in out[False]]} s, early exit "
        f"{[r['seconds'] for r in out[True]]} s; launches {out[False][0]['launches']} vs "
        f"{out[True][0]['launches']}; loss {losses[False]!r} vs {losses[True]!r}; "
        f"{card_line()}")
    if losses[False] != losses[True]:
        raise AssertionError("train: early_exit changed the loss")
    return {"every_bounce": out[False], "early_exit": out[True]}


def phase_edges(device, record):
    """The warps on the card: sphere_plane at 64x64, the screen warp
    (``render_pixels_edgeaware``) and the NEE warp (``edge_aware_nee``)
    with camera and light rows on the autograd path.  The forward equals
    the plain render's; the camera and light-row gradients agree with
    the port's on the CPU over the paths whose radiance agrees."""
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import Camera
    from wasm_pathtracer_tpu_torch.ops import edges, integrator, trace
    W = H = 64
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=4, rr_clamp_min=0.9,
                        rr_clamp_max=0.9, edge_aware_nee=True)

    def render(dev, warp, mask=None):
        scene = scenes.sphere_plane(dev)
        leaves = dict(location=torch.tensor([0.0, 1.5, -2.0], device=dev),
                      rot_x=torch.tensor(0.45, device=dev), rot_y=torch.tensor(0.0, device=dev),
                      light_rows=scene.params[scene.light_shape.long()].clone())
        for x in leaves.values():
            x.requires_grad_(True)
        sc = scene.with_light_rows(leaves["light_rows"])
        cam = Camera(leaves["location"], leaves["rot_x"], leaves["rot_y"])
        pix = torch.arange(W * H, device=dev)
        fn = edges.render_pixels_edgeaware if warp else integrator.render_pixels
        s = st if warp else st.replace(edge_aware_nee=False)
        col, _ = fn(trace.prepare(scene), sc, s, cam, pix % W, pix // W, W, H, 5)
        m = torch.ones(W * H, device=dev) if mask is None else mask.to(dev)
        grads = torch.autograd.grad((col.mean(-1) * m).sum() / (W * H), list(leaves.values()))
        return col.detach().cpu(), {k: x.cpu() for k, x in zip(leaves, grads)}

    col_w, _ = render(device, True)
    col_p, _ = render(device, False)
    if not torch.allclose(col_w, col_p, rtol=1e-5, atol=1e-6):
        raise AssertionError("edges: the warped render differs from the plain one")
    col_c, _ = render(torch.device("cpu"), True)
    same = torch.isclose(col_w, col_c, rtol=1e-3, atol=1e-4).all(-1)
    share = 1.0 - same.float().mean().item()
    _, g_g = render(device, True, same.float())
    _, g_c = render(torch.device("cpu"), True, same.float())
    worst = {k: float(((g_g[k] - g_c[k]).abs() / (g_c[k].abs() + 1e-3 * g_c[k].abs().max()))
                      .max()) for k in g_c}
    log(f"edges sphere_plane {W}x{H}: warped forward equals the plain render; GPU vs CPU "
        f"paths that differ {share:.5f}; gradients (camera {[float(g_g[k]) for k in ('rot_x',)]}"
        f") over the others, max |diff| / (|cpu| + 1e-3 max|cpu|): {worst}")
    record["edges"] = dict(paths_differ_share=share, worst_rel=worst)
    if share > 1e-3 or max(worst.values()) > 1e-3:
        raise AssertionError("edges: the card's warped gradients disagree with the CPU's")


# ---------------------------------------------------------------------------
# the Whitted path and the live runtime
# ---------------------------------------------------------------------------

# (name, scene, camera, depth) of the Whitted frames at 512x512; "lit" is
# scene 101 with a point, a spot and a directional light, "cloud" the
# 10k-triangle cloud of scene 4 with the session's cluster prep
WHITTED = (("whitted_d4", 4), ("museum_d1", 1), ("lit_d2", 2), ("cloud_d1", 1))
WHITTED_CAMERA = dict(location=(0.0, 1.0, -4.0), rot_x=0.1, rot_y=0.0)
# the call of each wrapper whose arguments phase whitted checks and
# times, by frame: K1 on the first refracted rays of scene 101 (call 16)
# and on the first mirror rays of the others (call 1); K2's first
# area-light chunk of scene 101, the museum's
# last chunk (4,194,304 rays, four padded slots of light id -2), the
# lit scene's point light (light id -1); K5 in an early round of the
# cloud's first cluster trace
WHITTED_CALLS = {"whitted_d4": {"fused_nearest": 16, "fused_occluded": 0},
                 "museum_d1": {"fused_nearest": 1, "fused_occluded": 6},
                 "lit_d2": {"fused_nearest": 1, "fused_occluded": 1},
                 "cloud_d1": {"fused_nearest": 0, "probe_min": 4}}
# the Whitted frames' and the live session's width and height
WHITTED_SIZE = 512
LIVE_SIZE = 512


def whitted_lit(device):
    """Scene 101 with a point, a spot and a directional light added."""
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.scene import Material, SceneBuilder
    b = SceneBuilder(background=(135.0 / 255.0, 206.0 / 255.0, 250.0 / 255.0))
    tex = b.add_texture(scenes.checker_texture())
    b.add_square((0.0, -1.0, 4.0), 8.0, Material.diffuse(1.0, 1.0, 1.0, texture_id=tex))
    b.add_sphere((-1.3, 1.0, -0.2), 0.7, Material.refract((0.5, 1.0, 0.5), 1.02))
    b.add_sphere((-0.4, 0.0, 1.0), 0.6, Material.reflect(1.0, 1.0, 1.0, 0.3))
    light = Material.emissive(10.0, 10.0, 10.0)
    b.add_triangle((1.0, 6.0, -2.0), (1.0, 6.0, -4.0), (-1.0, 6.0, -4.0), light)
    b.add_triangle((-1.0, 6.0, -2.0), (1.0, 6.0, -2.0), (-1.0, 6.0, -4.0), light)
    b.add_point_light((1.5, 3.0, -1.0), (1.0, 0.9, 0.8), 20.0)
    b.add_spot_light((0.0, 4.0, 1.0), (0.0, -1.0, 0.0), 0.4, (0.2, 0.4, 1.0), 30.0)
    b.add_directional_light((0.3, -1.0, 0.5), (0.3, 0.3, 0.3))
    return b.build(device)


def whitted_frame(name, device):
    """(prep, scene, camera) of a Whitted frame of ``WHITTED``."""
    from wasm_pathtracer_tpu_torch.config import RenderSettings
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import Camera, initial_camera
    from wasm_pathtracer_tpu_torch.ops import bvh, trace
    cam = Camera.create(**WHITTED_CAMERA, device=device)
    if name == "museum_d1":
        scene, cam = scenes.museum(device), initial_camera(0, device)
    elif name == "lit_d2":
        scene = whitted_lit(device)
    elif name == "cloud_d1":
        scene, cam = scenes.select_scene(4, {}, {}, device), initial_camera(4, device)
    else:
        scene = scenes.whitted(device=device)
    prep = trace.prepare(scene)
    if name == "cloud_d1":
        st = RenderSettings()
        prep = bvh.attach_clusters(prep, scene, num_bins=st.bvh_num_bins,
                                   min_count=st.bvh_min_triangles)
    return prep, scene, cam


def whitted_counts(scene, depth, clustered):
    """(K1 launches, K2 launches, traces per pixel, shadow rays per pixel)
    of one frame: 2^(depth+1) - 1 trace nodes, and at each node one
    shadow query per chunk of 16 area lights and per 0-sized light.  A
    query is one K2 call on a dense prep and one trace (K1 on the dense
    remainder, K5 in the cluster rounds) on a cluster prep."""
    nodes = 2 ** (depth + 1) - 1
    L, PL = scene.num_lights, scene.num_plights
    chunks = -(-L // min(16, L)) if L else 0
    lanes = chunks * min(16, L) + PL
    queries = nodes * (chunks + PL)
    if clustered:
        return nodes + queries, 0, nodes, nodes * lanes
    return nodes, queries, nodes, nodes * lanes


def check_occluded_far(tables, o, d, dist, lsid, code_of, what):
    """K2 against its plain version on the rays of one call of a path:
    from origins within 50 units of the world origin verdicts agree on
    > 99.9% of rays; from farther origins every differing verdict is a
    rounding tie (``rounding_ties``, checked 128 rays at a time) and
    >= 98% agree.  Returns 1.0 if any verdict differs, else 0.0."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    occ_k = sk.fused_occluded(tables, o, d, dist, lsid, code_of)
    occ_p = plain_occluded(tables, o, d, dist, lsid, code_of)
    torch.cuda.synchronize()
    far = o.abs().amax(1) > 50.0
    diff = occ_k != occ_p
    n_near, n_far = int((~far).sum()), int(far.sum())
    d_near, d_far = int((diff & ~far).sum()), int((diff & far).sum())
    idx = torch.nonzero(diff & far)[:, 0]
    ties = torch.cat([rounding_ties(tables, code_of, *(x[idx[i:i + 128]]
                                                       for x in (o, d, dist, lsid)))
                      for i in range(0, idx.numel(), 128)] or
                     [torch.zeros(0, dtype=torch.bool, device=o.device)])
    excl = lsid.unique().tolist()
    log(f"K2 {what}: {o.shape[0]} rays, light ids {excl[:3]}{'...' if len(excl) > 3 else ''}"
        f"; near origins {d_near} of {n_near} differ, far origins {d_far} of {n_far} "
        f"differ ({int(ties.sum())} rounding ties); occluded rate "
        f"{occ_p.float().mean().item():.3f}")
    if not (1 - d_near / max(n_near, 1) > 0.999 and 1 - d_far / max(n_far, 1) >= 0.98
            and bool(ties.all())):
        raise AssertionError(f"K2 disagrees with its plain version on {what}")
    return float(d_near + d_far > 0)


def phase_whitted(device, record):
    """Whitted frames at 512x512 through ``ops.whitted.render_whitted``:
    scene 101 at depth 4, the museum at depth 1 (108 lights, 7 chunks of
    4,194,304 shadow rays a node), scene 101 with point, spot and
    directional lights at depth 2, and the 10k-triangle cloud on its
    cluster prep at depth 1 (K1 and K5 trace, shadow rays are traces).
    Each frame three times, each time with the counts set to 0 before and
    read after: the launches equal ``whitted_counts``, the image is finite
    and not black.  Median frame seconds and rays/s (traces and shadow
    rays over the frame time).  Then K1, K2 and K5 against their plain
    versions on the arguments of one call of the frame (``WHITTED_CALLS``)
    and timed there."""
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings
    from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    from wasm_pathtracer_tpu_torch.ops import whitted
    W = H = WHITTED_SIZE
    st = RenderSettings()
    pix = torch.arange(W * H, device=device)
    px, py = pix % W, pix // W
    out = {}
    for name, depth in WHITTED:
        prep, scene, cam = whitted_frame(name, device)
        clustered = prep.cluster is not None
        k1, k2, nodes, shadow = whitted_counts(scene, depth, clustered)

        def frame():
            with torch.no_grad():
                return whitted.render_whitted(prep, scene, st, cam, px, py, W, H, depth)

        frame()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            reset_counts()
            t0 = time.perf_counter()
            img = frame()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches = read_counts()
            if clustered:
                expect_launches(launches, k1, ("fused_nearest",), ("probe_min",))
            else:
                expect_launches(launches, 0, at_least_once=("fused_nearest",
                                                            "fused_occluded"))
                if (launches["fused_nearest"], launches["fused_occluded"]) != (k1, k2):
                    raise AssertionError(f"whitted {name}: launches {launches}, expected "
                                         f"K1 {k1} and K2 {k2}")
        if not (bool(torch.isfinite(img).all()) and img.max().item() > 0):
            raise AssertionError(f"whitted {name}: non-finite or black image")
        sec = float(np.median(times))
        rays = W * H * (nodes + shadow)
        out[name] = dict(depth=depth, frame_seconds=times, median_seconds=sec,
                         rays_per_frame=rays, rays_per_sec=rays / sec, launches=launches,
                         mean_radiance=img.mean(0).tolist())
        log(f"whitted {name}: {W}x{H} depth {depth}, {scene.num_lights} area + "
            f"{scene.num_plights} 0-sized lights, cluster prep {clustered}: median "
            f"{sec:.4f} s of {times}, {rays} rays ({W * H * nodes} traced + "
            f"{W * H * shadow} shadow), {rays / sec:.4g} rays/s, launches {launches}, "
            f"mean radiance {out[name]['mean_radiance']}; {card_line()}")

        which = WHITTED_CALLS[name]
        mods = [(sk, {k: v for k, v in which.items() if k != "probe_min"})]
        if "probe_min" in which:
            mods.append((pk, {"probe_min": which["probe_min"]}))
        with contextlib.ExitStack() as stack:
            parts = [stack.enter_context(recorded_calls(mod, w)) for mod, w in mods]
            frame()
            torch.cuda.synchronize()
        got = {k: v for part in parts for k, v in part.items()}
        if set(got) != set(which):
            raise AssertionError(f"whitted {name}: the frame made fewer calls than "
                                 f"{which} (recorded {sorted(got)})")
        key = f"whitted_{name}"
        if "fused_occluded" in got:
            tables, o, d, dist, lsid, code_of = got.pop("fused_occluded")
            err = check_occluded_far(tables, o, d, dist, lsid, code_of,
                                     f"whitted {name} call {which['fused_occluded']}")
            rec = record.setdefault("fused_occluded", {})
            rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
            rec.setdefault("other_shapes", {})[key] = timed_occluded(
                tables, code_of, (o, d, dist, lsid), f"whitted {name}")
        if "fused_nearest" in got:
            tables, o, d, sid_map = got.pop("fused_nearest")
            what = f"whitted {name} call {which['fused_nearest']}"
            err, _ = check_nearest(tables, o, d, sid_map, what, spread=True)
            rec = record.setdefault("fused_nearest", {})
            rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
            rec.setdefault("other_shapes", {})[key] = timed_nearest(tables, o, d, sid_map,
                                                                    f"whitted {name}")
        check_path_inputs(record, got, f"whitted {name}", launches)
    record["whitted"] = out


def whitted_gpu_vs_cpu_grads(device, W, H, depth, mask=None):
    """{"card" | "cpu": (image, {leaf: gradient of mean(img^2) over ``mask``})}
    of scene 101 at W x H, with respect to its albedo and the camera."""
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import Camera
    from wasm_pathtracer_tpu_torch.ops import trace, whitted
    out = {}
    for key, dev in (("card", device), ("cpu", torch.device("cpu"))):
        scene = scenes.whitted(device=dev)
        cam = Camera.create(**WHITTED_CAMERA, device=dev)
        leaves = dict(albedo=scene.albedo.clone(), location=cam.location.clone(),
                      rot_x=cam.rot_x.clone(), rot_y=cam.rot_y.clone())
        for x in leaves.values():
            x.requires_grad_(True)
        pix = torch.arange(W * H, device=dev)
        img = whitted.render_whitted(trace.prepare(scene),
                                     scene.with_materials(albedo=leaves["albedo"]),
                                     RenderSettings(),
                                     Camera(leaves["location"], leaves["rot_x"],
                                            leaves["rot_y"]),
                                     pix % W, pix // W, W, H, depth)
        m = torch.ones(W * H, device=dev) if mask is None else mask.to(dev)
        g = torch.autograd.grad((img ** 2 * m[:, None]).sum() / (W * H),
                                list(leaves.values()))
        out[key] = (img.detach().cpu(), {k: x.cpu() for k, x in zip(leaves, g)})
    return out


def phase_whitted_gpu_vs_cpu(device, record):
    """Whitted on the card against the plain versions on the CPU: scene
    101 at 64x64, depth 4, and the museum at 32x32, depth 1: >= 99.5% of
    pixels within rtol 1e-3 / atol 1e-3.  Then the gradients of mean(img^2)
    with respect to albedo and camera on scene 101 at 64x64, depth 2,
    over the pixels whose images agree: within 1e-3 relative (atol 1e-3 of
    the largest), as phase grad_gpu_vs_cpu compares."""
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings
    from wasm_pathtracer_tpu_torch.ops import whitted
    rec = {}
    for name, size, depth in (("whitted_d4", 64, 4), ("museum_d1", 32, 1)):
        imgs = []
        for dev in (device, torch.device("cpu")):
            prep, scene, cam = whitted_frame(name, dev)
            pix = torch.arange(size * size, device=dev)
            with torch.no_grad():
                imgs.append(whitted.render_whitted(prep, scene, RenderSettings(), cam,
                                                   pix % size, pix // size, size, size,
                                                   depth).cpu())
        same = torch.isclose(imgs[0], imgs[1], rtol=1e-3, atol=1e-3).all(-1)
        share = same.float().mean().item()
        rec[name] = dict(pixels_agree=share, max_abs_diff=(imgs[0] - imgs[1]).abs().max().item())
        log(f"whitted GPU vs CPU {name} {size}x{size} depth {depth}: pixels agree {share:.5f}, "
            f"max |diff| {rec[name]['max_abs_diff']:.3g}")
        if share < 0.995:
            raise AssertionError(f"whitted GPU vs CPU {name}: {share:.4f} of pixels agree")
    first = whitted_gpu_vs_cpu_grads(device, 64, 64, 2)
    same = torch.isclose(first["card"][0], first["cpu"][0], rtol=1e-3, atol=1e-3).all(-1)
    grads = whitted_gpu_vs_cpu_grads(device, 64, 64, 2, same.float())
    worst = {}
    for k, b in grads["cpu"][1].items():
        a = grads["card"][1][k]
        worst[k] = float(((a - b).abs() / (b.abs() + 1e-3 * b.abs().max())).max())
    rec["grad_pixels_agree"] = same.float().mean().item()
    rec["grad_worst_rel"] = worst
    log(f"whitted GPU vs CPU gradients 64x64 depth 2 over {int(same.sum())} of 4096 "
        f"pixels: max |diff| / (|cpu| + 1e-3 max|cpu|) {worst}")
    record["whitted_gpu_vs_cpu"] = rec
    if max(worst.values()) > 1e-3:
        raise AssertionError("whitted GPU vs CPU: gradients disagree beyond rtol 1e-3")


def phase_live(device, record):
    """The live server on the card: ``Session(512, 512, scene 0)``, both
    halves NEE with 8 bounces, a ``LiveSession`` and a ``LiveServer`` on
    127.0.0.1 (port 0), both started; a sequence of requests through
    ``urllib`` (10 s timeouts): frames until ``frame_id`` >= 3, the PNG,
    a camera key, paths/s over 5 s, pause and resume, a settings switch
    to PNEE on the left half, a scene switch, a viewport switch, pan and
    recenter.  Latencies of ``/frame.png`` and ``/status``, and K1/K2
    launches during the phase.  Fails if the render thread died, the
    ticks did not grow, or a thread does not stop within 30 s."""
    import urllib.request

    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.runtime import live as lv
    from wasm_pathtracer_tpu_torch.runtime.session import Session
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=8)
    sess = Session(LIVE_SIZE, LIVE_SIZE, 0, left=st, right=st, device=device)
    live = lv.LiveSession(sess)
    server = lv.LiveServer(live, port=0)
    base = f"http://127.0.0.1:{server.port}"
    lat = {"/frame.png": [], "/status": []}
    answered = [0]

    def get(path):
        t0 = time.perf_counter()
        with urllib.request.urlopen(base + path, timeout=10) as r:
            body = r.read()
        answered[0] += 1
        key = path.split("?")[0]
        if key in lat:
            lat[key].append(time.perf_counter() - t0)
        return body

    def status():
        return json.loads(get("/status"))

    def wait_for(cond, what, seconds=120.0):
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            s = status()
            if cond(s):
                return s
            time.sleep(0.01)
        raise AssertionError(f"live: timed out waiting for {what}; status {s}")

    reset_counts()
    server.start()
    live.start()
    rec = {}
    try:
        if b"wasm_pathtracer_tpu" not in get("/"):
            raise AssertionError("live: the page is not the viewer")
        wait_for(lambda s: s["frame_id"] >= 3, "three frames")
        img = png_pixels(get("/frame.png"))
        if img.shape != (LIVE_SIZE, LIVE_SIZE, 3) or img.max() == 0:
            raise AssertionError(f"live: frame {img.shape} max {img.max()}")
        # a camera key: 0.3 units along the view direction within two ticks
        loc0 = sess.camera.location.cpu()
        rx, ry = float(sess.camera.rot_x), float(sess.camera.rot_y)
        f0 = status()["frame_id"]
        get("/key?k=w&n=10")
        end = time.monotonic() + 30
        while torch.equal(sess.camera.location.cpu(), loc0) and time.monotonic() < end:
            time.sleep(0.002)
        frames = status()["frame_id"] - f0
        moved = (sess.camera.location.cpu() - loc0).numpy()
        fwd = np.array([np.sin(ry) * np.cos(rx), -np.sin(rx), np.cos(ry) * np.cos(rx)])
        log(f"live: key w x10 moved the camera by {moved.tolist()} ({frames} frames after "
            f"the request), view direction {fwd.tolist()}")
        if not (np.allclose(moved, 0.3 * fwd, atol=1e-4) and frames <= 3):
            raise AssertionError("live: the key did not move the camera 0.3 forward "
                                 "within two ticks")
        # throughput over 5 s unpaused
        s0, t0 = status(), time.perf_counter()
        time.sleep(5.0)
        s1, dt = status(), time.perf_counter() - t0
        rec["paths_per_sec"] = (s1["total_ticks"] - s0["total_ticks"]) / dt
        rec["ticks_per_step"] = s1["ticks_per_step"]
        rec["frames_per_sec"] = (s1["frame_id"] - s0["frame_id"]) / dt
        log(f"live: {rec['paths_per_sec']:.1f} paths/s served over {dt:.2f} s "
            f"({rec['frames_per_sec']:.2f} frames/s), ticks_per_step "
            f"{s1['ticks_per_step']} against the {live.driver.target_tick * 1e3:.0f} ms "
            f"target (ray batch {st.ray_batch_size} a half)")
        # pause holds the ticks for 1 s, resume moves them
        get("/pause")
        sp = wait_for(lambda s: s["paused"], "the pause")
        time.sleep(1.0)
        if status()["total_ticks"] != sp["total_ticks"]:
            raise AssertionError("live: ticks grew while paused")
        get("/resume")
        wait_for(lambda s: s["total_ticks"] > sp["total_ticks"], "ticks after resume")
        # PNEE on the left half (K1 for the emission), adaptive on the right
        n1 = read_counts()["fused_nearest"]
        get("/settings?left=2&right=1&right_adaptive=1")
        wait_for(lambda s: sess.left.settings.render_type == RenderType.PNEE
                 and sess.right.settings.adaptive and s["total_ticks"] > 0, "PNEE")
        f1 = status()["frame_id"]
        wait_for(lambda s: s["frame_id"] >= f1 + 2, "two PNEE frames")
        n_photons = int(sess.left.photon_grid.num_photons)
        log(f"live: left half PNEE with {n_photons} photons after two frames, K1 "
            f"launches since the switch {read_counts()['fused_nearest'] - n1}, ticks_per_step "
            f"{status()['ticks_per_step']}")
        get("/scene?id=101")
        wait_for(lambda s: s["scene"] == 101, "scene 101")
        get("/viewport?w=256&h=256")
        wait_for(lambda s: (s["width"], s["height"]) == (256, 256), "the viewport")
        f2 = status()["frame_id"]
        wait_for(lambda s: s["frame_id"] > f2, "a 256x256 frame")
        img = png_pixels(get("/frame.png"))
        if img.shape != (256, 256, 3):
            raise AssertionError(f"live: frame {img.shape} after the viewport switch")
        pans = [json.loads(get(p)) for p in ("/recenter", "/pan?dx=-40&dy=0", "/recenter")]
        if pans != [{"x": 128, "y": 128}, {"x": 88, "y": 128}, {"x": 128, "y": 128}]:
            raise AssertionError(f"live: pan offsets {pans}")
        for _ in range(20):
            get("/frame.png")
            get("/status")
        alive = live._thread.is_alive()
        final = status()
    finally:
        t0 = time.perf_counter()
        thread, server_thread = live._thread, server._thread
        live.stop()
        server.stop()
        stop_s = time.perf_counter() - t0
    launches = read_counts()
    rec.update({f"{k}_latency_ms": dict(median=1e3 * float(np.median(v)),
                                        max=1e3 * float(np.max(v)), n=len(v))
                for k, v in lat.items()})
    rec.update(requests=answered[0], launches=launches, total_ticks=final["total_ticks"],
               stop_seconds=stop_s)
    log(f"live: {answered[0]} requests answered; /frame.png latency median "
        f"{rec['/frame.png_latency_ms']['median']:.2f} ms max "
        f"{rec['/frame.png_latency_ms']['max']:.2f} ms, /status median "
        f"{rec['/status_latency_ms']['median']:.2f} ms max "
        f"{rec['/status_latency_ms']['max']:.2f} ms; launches {launches}; stopped in "
        f"{stop_s:.2f} s; {card_line()}")
    record["live"] = rec
    if not alive:
        raise AssertionError("live: the render thread died")
    if thread is not None and thread.is_alive():
        raise AssertionError("live: the render thread did not stop within 30 s")
    if server_thread is not None and server_thread.is_alive():
        raise AssertionError("live: the server thread did not stop")
    if final["total_ticks"] <= 0:
        raise AssertionError("live: the ticks did not grow")
    expect_launches(launches, 0, at_least_once=("fused_nearest", "fused_occluded",
                                                "fused_shade", "fused_regen"))


def phase_cli_runtime(device, record):
    """The CLI's Whitted and run-loop flags, each run a process of its
    own: ``--whitted 4`` on scene 101, ``--whitted 1`` on scene 4 (the
    cluster prep: K1 and K5), and ``--seconds 2 --checkpoint`` on the
    museum resumed with ``--resume --ticks 65536``: PNGs not black, the
    resumed counts the checkpoint's plus 65,536."""
    cli_render(101, ("--whitted", "4"))
    cli_render(4, ("--whitted", "1"))
    with tempfile.TemporaryDirectory() as tmp:
        c1, c2 = os.path.join(tmp, "c1.npz"), os.path.join(tmp, "c2.npz")
        cli_render(0, ("--seconds", "2", "--checkpoint", c1))
        cli_render(0, ("--resume", c1, "--ticks", "65536", "--checkpoint", c2))
        n1, n2 = (float(np.load(c)["count"].sum()) for c in (c1, c2))
    log(f"CLI checkpoint: {n1:.0f} samples after --seconds 2, {n2:.0f} after resuming "
        f"with --ticks 65536")
    record["cli_runtime"] = dict(samples_after_seconds=n1, samples_after_resume=n2)
    if not n1 > 0 or n2 != n1 + 65536:
        raise AssertionError("CLI: the resumed render did not continue from the checkpoint")


# device counts of the scaling harness: one card gives the first row
SHARD_SCALING = (1, 2, 4, 8)


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sharded_against_unsharded(what, unsharded_fn, sharded_fn, mesh, prep, scene, st, cam,
                              h, device, kernels):
    """The sharded queue against the unsharded loop on one queue of
    ``h['S']`` paths with the same seed: unsharded, sharded, sharded,
    unsharded, each with its launches counted (each kernel of ``kernels``
    once per iteration).  Counts equal and every sample counted; frame sums
    within rtol 1e-5 (the loops add finished paths with ``index_add_``,
    whose float atomics sum a pixel's paths in any order), then bit for
    bit in one pair more with deterministic algorithms.  Returns the
    record."""
    import torch
    import torch.distributed as dist
    W, H, B = h["width"], h["height"], h["B"]
    unsharded_fn(prep, scene, st, cam, headline_queue(device, 2 * B), W, H, 1, B)
    sharded_fn(mesh, prep, scene, st, cam, headline_queue(device, 2 * B), W, H, 1, B)
    pix = headline_queue(device, h["S"])

    def unsharded():
        return unsharded_fn(prep, scene, st, cam, pix, W, H, 2, B, return_iters=True)

    def sharded():
        return sharded_fn(mesh, prep, scene, st, cam, pix, W, H, 2, B)

    runs = [(name,) + counted_run(fn) for name, fn in (
        ("unsharded", unsharded), ("sharded", sharded), ("sharded", sharded),
        ("unsharded", unsharded))]
    iters = runs[0][1][3]
    ref_acc, ref_cnt = runs[0][1][0], runs[0][1][1]
    rec = dict(iterations=iters, runs=[])
    for name, out, dt, launches in runs:
        expect_launches(launches, iters, kernels)
        acc, cnt = out[0], out[1]
        total = int(cnt.sum())
        diff = float((acc - ref_acc).abs().max())
        log(f"shard {what} {name}: {dt:.3f} s, {h['S'] / dt:.1f} paths/s, samples {total}, "
            f"max |acc - first unsharded| {diff:.3g}, launches {launches}; {card_line()}")
        if total != h["S"] or not torch.equal(cnt, ref_cnt):
            raise AssertionError(f"shard {what} {name}: counts differ from the unsharded loop")
        if not bool(torch.isfinite(acc).all()) or not torch.allclose(acc, ref_acc, rtol=1e-5,
                                                                     atol=1e-6):
            raise AssertionError(f"shard {what} {name}: frame sums differ (max {diff})")
        rec["runs"].append(dict(path=name, seconds=dt, paths_per_sec=h["S"] / dt,
                                launches=launches))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a, b = unsharded(), sharded()
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    rec["bit_equal"] = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    rec["cost"] = [int(a[2].sum()), float(b[2])]
    log(f"shard {what}: with deterministic algorithms the sharded frame sums and counts "
        f"equal the unsharded loop's bit for bit: {rec['bit_equal']}; primitive tests "
        f"{rec['cost'][0]} unsharded, {rec['cost'][1]:.0f} sharded (summed in float32); "
        f"group backend {dist.get_backend(mesh.group)}")
    if not rec["bit_equal"]:
        raise AssertionError(f"shard {what}: not bit-equal to the unsharded loop")
    return rec


def phase_shard(device, record):
    """The sharded paths on a world-1 NCCL group (``distributed.initialize``
    over a TCP store on 127.0.0.1): the museum headline and mesh70k flat
    at full width against their unsharded loops, the museum frame against
    ``render_pixels``, the train step with and without the group, the
    inverse-render demo, the scaling harness and the all-reduce's cost.
    The group is destroyed at the end."""
    import torch
    import torch.distributed as dist
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import Camera, initial_camera
    from wasm_pathtracer_tpu_torch.models.scene import MatKind
    from wasm_pathtracer_tpu_torch.ops import integrator, trace, wavefront
    from wasm_pathtracer_tpu_torch.parallel import (make_ray_mesh, make_train_step,
                                                    render_image_sharded,
                                                    render_queue_flat_sharded,
                                                    render_queue_sharded)
    from wasm_pathtracer_tpu_torch.parallel.distributed import initialize, measure_scaling
    from wasm_pathtracer_tpu_torch.parallel.shard import RayMesh

    world = initialize(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        mesh = make_ray_mesh()
        backend = str(dist.get_backend(mesh.group))
        log(f"shard: world {world}, mesh rank {mesh.rank} of {mesh.size} on {mesh.device}, "
            f"backend {backend}")
        if (world, mesh.rank, mesh.size, backend) != (1, 0, 1, "nccl") \
                or mesh.device != device:
            raise AssertionError("shard: the mesh is not a world-1 NCCL group on the card")
        rec = dict(backend=backend, world=world)

        h = HEADLINE
        scene = scenes.museum(device)
        st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=h["max_bounces"])
        prep, cam = trace.prepare(scene), initial_camera(0, device)
        rec["museum"] = sharded_against_unsharded(
            "museum headline", integrator.render_queue, render_queue_sharded, mesh, prep,
            scene, st, cam, h, device, ("fused_nearest", "fused_occluded", "fused_shade",
                                        "fused_regen"))
        mscene, mprep = mesh70k(device)
        rec["mesh70k_flat"] = sharded_against_unsharded(
            "mesh70k flat", wavefront.render_queue_flat, render_queue_flat_sharded, mesh,
            mprep, mscene, st, mesh_camera(device), MESH, device,
            ("select_scan", "probe_pair", "fused_shade", "fused_regen"))

        # the frame: render_image_sharded against render_pixels
        W, H = h["width"], h["height"]
        pix = torch.arange(W * H, device=device)
        with torch.no_grad():
            want, dt0, l0 = counted_run(lambda: integrator.render_pixels(
                prep, scene, st, cam, pix % W, pix // W, W, H, 7)[0].reshape(H, W, 3))
            img, dt1, l1 = counted_run(lambda: render_image_sharded(
                mesh, prep, scene, st, cam, W, H, 7))
        log(f"shard image: museum {W}x{H}, render_pixels {dt0:.3f} s, render_image_sharded "
            f"{dt1:.3f} s, bit-equal {torch.equal(img, want)}, launches {l1} ({l0})")
        if not torch.equal(img, want) or l0 != l1:
            raise AssertionError("shard: the sharded frame differs from render_pixels")
        expect_launches(l1, 0, at_least_once=("fused_nearest", "fused_occluded",
                                              "fused_shade"))
        rec["image"] = dict(seconds=dt1, seconds_unsharded=dt0, launches=l1)

        # the train step with and without the group
        lone = RayMesh(None, 0, 1, device)
        with torch.no_grad():
            target = integrator.render_pixels(prep, scene, st, cam, pix % W, pix // W, W, H,
                                              1)[0].reshape(H, W, 3)
        start = scene.with_materials(albedo=torch.clamp(scene.albedo * 0.8, 0.0, 1.0))
        steps = {"group": make_train_step(mesh, prep, st, W, H, lr=1e-3),
                 "no group": make_train_step(lone, prep, st, W, H, lr=1e-3)}
        steps["no group"](start, cam, target, 100)     # the first backward warms up
        runs = [(name,) + counted_run(lambda: steps[name](start, cam, target, 100))
                for name in ("group", "no group", "no group", "group")]
        (lg, sg, cg), _, launches = runs[0][1:]
        expect_launches(launches, 0, at_least_once=("fused_nearest", "fused_occluded"))
        moved = float((sg.albedo - start.albedo).abs().max())
        diffs, bit_equal = {}, True
        for name, (ln, sn, cn), _, _ in runs[1:]:
            d = dict(loss=abs(float(lg) - float(ln)),
                     albedo=float((sg.albedo - sn.albedo).abs().max()),
                     emission=float((sg.emission - sn.emission).abs().max()),
                     rot_x=float((cg.rot_x - cn.rot_x).abs().max()))
            diffs = {k: max(v, diffs.get(k, 0.0)) for k, v in d.items()}
            bit_equal &= (torch.equal(lg, ln) and torch.equal(sg.albedo, sn.albedo)
                          and torch.equal(sg.emission, sn.emission)
                          and torch.equal(cg.location, cn.location)
                          and torch.equal(cg.rot_x, cn.rot_x))
        seconds = {name: [r[2] for r in runs if r[0] == name] for name in steps}
        log(f"shard train: museum {W}x{H}, loss {float(lg):.8g}; s a step {seconds} "
            f"(group, no group, no group, group); albedo moved by {moved:.3g}; largest "
            f"|group - other run| {diffs}; all bit-equal {bit_equal}; launches {launches}")
        if not (moved > 0 and diffs["loss"] <= 1e-5 * abs(float(lg))
                and diffs["albedo"] <= 1e-4 * moved):
            raise AssertionError("shard train: the step differs with the group")
        rec["train"] = dict(loss=float(lg), seconds=seconds, diffs=diffs,
                            bit_equal=bit_equal, launches=launches)

        # the inverse-render demo (tests/test_sharding.py's train case) at 64x64
        sp = scenes.sphere_plane(device)
        sprep = trace.prepare(sp)
        scam = Camera.create((0.0, 1.5, -2.0), 0.25, 0.0, device=device)
        sst = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=4)
        w = 64
        with torch.no_grad():
            target = render_image_sharded(mesh, sprep, sp, sst, scam, w, w, 100, spp=4)
        wrong = sp.with_materials(albedo=torch.clamp(sp.albedo + 0.15, 0.0, 1.0))
        step = make_train_step(mesh, sprep, sst, w, w, lr=0.5)
        diffuse = (sp.mat_kind == int(MatKind.DIFFUSE))[:, None]

        def albedo_err(s):
            return float(torch.where(diffuse, (s.albedo - sp.albedo).abs(), 0.0).max())

        # the loss at one fixed seed before and after: a step's own loss
        # moves with its seed's noise more than with the albedo
        before = float(step(wrong, scam, target, 999)[0])
        cur, cc, losses = wrong, scam, []
        t0 = time.perf_counter()
        for i in range(6):
            loss, cur, cc = step(cur, cc, target, 200 + i)
            losses.append(float(loss))
        dt = (time.perf_counter() - t0) / 6
        after = float(step(cur, cc, target, 999)[0])
        log(f"shard inverse render: {w}x{w}, albedo +0.15, 6 steps of {dt:.3f} s: step "
            f"losses {losses}; loss at seed 999 {before:.6g} -> {after:.6g}; max diffuse "
            f"albedo error {albedo_err(wrong):.4f} -> {albedo_err(cur):.4f}")
        if not (np.isfinite(losses).all() and after < 0.9 * before
                and albedo_err(cur) < albedo_err(wrong)):
            raise AssertionError("shard inverse render: the loss did not fall")
        rec["inverse_render"] = dict(losses=losses, before=before, after=after,
                                     seconds_per_step=dt)

        # the scaling harness: one card, one row
        def render(m, seed):
            with torch.no_grad():
                return render_image_sharded(m, prep, scene, st, cam, W, H, seed)

        rows = measure_scaling(render, SHARD_SCALING, iters=5)
        log(f"shard scaling (museum {W}x{H} frames): {rows}; {card_line()}")
        if [r["devices"] for r in rows] != [1] or rows[0]["efficiency"] != 1.0:
            raise AssertionError("shard: measure_scaling on one card gives one row")
        rec["scaling"] = rows

        # the all-reduce of a frame's sums and counts
        acc = torch.rand((W * H, 3), device=device)
        cnt = torch.randint(0, 8, (W * H,), dtype=torch.int32, device=device)
        rec["all_reduce_ms"] = {
            "float32 (262144, 3)": cuda_ms(lambda: mesh.all_reduce(acc), 50, graph=False),
            "int32 (262144,)": cuda_ms(lambda: mesh.all_reduce(cnt), 50, graph=False)}
        log(f"shard: NCCL all_reduce ms (world 1, CUDA events, 50 calls) "
            f"{rec['all_reduce_ms']}; {card_line()}")
        record["shard"] = rec
    finally:
        dist.destroy_process_group()

def tensors_of(x):
    """Every tensor ``x`` holds, through tuples, lists and dataclasses."""
    import dataclasses
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tensors_of(v)]
    return []


def phase_defaults(device, record):
    """The JAX API written call for call, with no device anywhere: the
    museum through ``scenes.museum()``, ``trace.prepare``,
    ``initial_camera(0)``, ``adaptive.random_pixels`` and one
    ``render_queue`` batch of 16,384 paths at 512x512 (NEE, 8 bounces,
    16,384 lanes).  Every tensor lands on the card, and K1, K2 and the
    shade kernel (only they) launch."""
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera
    from wasm_pathtracer_tpu_torch.ops import adaptive, integrator, trace
    h = HEADLINE
    W, H, B = h["width"], h["height"], h["B"]
    scene = scenes.museum()
    prep = trace.prepare(scene)
    cam = initial_camera(0)
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=h["max_bounces"])
    px, py = adaptive.random_pixels(B, 1, 0, 0, W, H)
    pix = py * W + px
    out, dt, launches = counted_run(
        lambda: integrator.render_queue(prep, scene, st, cam, pix, W, H, 2, B))
    held = tensors_of((scene, prep, cam, px, py, out))
    where = sorted({str(t.device) for t in held})
    acc, cnt, _ = out
    log(f"defaults: museum {W}x{H}, one render_queue batch of {B} paths with no device "
        f"argument: {len(held)} tensors on {where}, {dt:.3f} s, launches {launches}, "
        f"samples {int(cnt.sum())}; {card_line()}")
    if any(t.device.type != "cuda" for t in held):
        raise AssertionError(f"defaults: tensors off the card ({where})")
    expect_launches(launches, 0, at_least_once=("fused_nearest", "fused_occluded",
                                                "fused_shade", "fused_regen"))
    if int(cnt.sum()) != B or not bool(torch.isfinite(acc).all()):
        raise AssertionError("defaults: the batch lost samples or is not finite")
    record["defaults"] = dict(tensors=len(held), devices=where, seconds=dt,
                              launches=launches)


# the per-pixel session phase: viewport, bounces, and the batches of
# 32,768 paths in each timed run
NO_REGEN = dict(width=512, height=512, max_bounces=8, batches=8)
# the calls of the first timed per-pixel run whose inputs phase no_regen
# checks, by scene: bounce 2 of the first batch (K1 and K2 once a bounce
# on the museum, K1 twice on scene 4) and a round of its first cluster
# trace (about 378 K5 rounds a batch)
NO_REGEN_CALLS = {0: {"fused_nearest": 2, "fused_occluded": 2},
                  4: {"fused_nearest": 2, "probe_min": 100}}
# the K1 and K2 calls (of 1,680 each) of the example's run that phase
# inverse_render checks: a bounce of about its 20th train step
INVERSE_CALL = 840


def session_run(sess, ticks):
    """(paths traced, seconds, launches) of one ``sess.compute(ticks)``."""
    return counted_run(lambda: sess.compute(ticks))


def sessions_agree(gpu, cpu, what):
    """Counts equal; >= 99% of the sampled pixels' sums within rtol 1e-3
    / atol 2e-3 (the per-path rule)."""
    c_g, c_c = gpu.buffer.count.cpu().numpy(), cpu.buffer.count.cpu().numpy()
    a_g, a_c = gpu.buffer.acc.cpu().numpy(), cpu.buffer.acc.cpu().numpy()
    sampled = c_c > 0
    close = np.isclose(a_g, a_c, rtol=1e-3, atol=2e-3).all(-1)[sampled].mean()
    same = np.array_equal(c_g, c_c)
    log(f"{what}: counts equal {same} ({int(c_c.sum())} samples on {int(sampled.sum())} "
        f"pixels), per-pixel agreement {close:.4f}, primitive tests {gpu.num_bvh_hits} vs "
        f"{cpu.num_bvh_hits}")
    if not (same and close >= 0.99):
        raise AssertionError(f"{what}: the card's session and the CPU's disagree")
    return dict(agreement=float(close), samples=int(c_c.sum()),
                prim_tests=[gpu.num_bvh_hits, cpu.num_bvh_hits])


def phase_no_regen(device, record):
    """The session's per-pixel step (``use_regen=False``): each batch of
    picked pixels renders one sample a pixel through
    ``integrator.render_pixels`` and ``accum.write_samples``.  The museum
    (NEE both halves, 8 bounces) at 512x512: two batches of 16,384 a
    half on the card against the same session on the CPU; then, at the
    default batch of 32,768, paths/s over ``NO_REGEN['batches']`` batches beside a
    regenerating session's (``use_regen=True``, ``render_queue``), in
    turns (per-pixel, regenerating, regenerating, per-pixel), launches
    counted: K1, K2 and the shade kernel only on the museum; K1, K5 (the
    lockstep cluster trace) and the shade kernel on scene 4, the
    10k-triangle cloud on its cluster prep, whose regenerating session
    takes the flat wavefront (K3, K4 and the shade kernel).
    Scene 4's CPU comparison takes batches of 1,024 (the plain cluster
    trace is slow on the CPU).  K1, K2 and K5 are held against their
    plain versions on the arguments of calls ``NO_REGEN_CALLS`` of the
    first timed per-pixel run, the batches of 32,768 whose launches and
    paths/s are reported."""
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    from wasm_pathtracer_tpu_torch.runtime.session import Session
    n = NO_REGEN
    W, H = n["width"], n["height"]
    rec = {}
    for scene_id, per_pixel_kernels, regen_kernels, cpu_batch in (
            (0, ("fused_nearest", "fused_occluded", "fused_shade"),
             ("fused_nearest", "fused_occluded", "fused_shade", "fused_regen"), 16_384),
            (4, ("fused_nearest", "probe_min", "fused_shade"),
             ("select_scan", "probe_pair", "fused_shade", "fused_regen"), 1_024)):
        what = f"no_regen scene {scene_id}"

        def session(dev, use_regen, batch=32_768):
            st = RenderSettings(render_type=RenderType.NORMAL_NEE,
                                max_bounces=n["max_bounces"], use_regen=use_regen,
                                ray_batch_size=batch)
            return Session(W, H, scene_id=scene_id, left=st, right=st, device=dev)

        gpu, cpu = session(device, False, cpu_batch), session("cpu", False, cpu_batch)
        _, _, launches = session_run(gpu, 4 * cpu_batch)
        t0 = time.perf_counter()
        cpu.compute(4 * cpu_batch)
        t_cpu = time.perf_counter() - t0
        log(f"{what}: {W}x{H}, two batches of {cpu_batch} a half on the card (launches "
            f"{launches}) and on the CPU ({t_cpu:.1f} s)")
        expect_launches(launches, 0, at_least_once=per_pixel_kernels)
        agree = sessions_agree(gpu, cpu, f"{what} GPU vs CPU")

        sessions = {False: session(device, False), True: session(device, True)}
        ticks = n["batches"] * 32_768
        for sess in sessions.values():
            sess.compute(2 * 32_768)              # warm-up: one batch a half
        runs = {False: [], True: []}
        for use_regen in (False, True, True, False):
            with contextlib.ExitStack() as stack:
                first = not use_regen and not runs[False]
                parts = [stack.enter_context(recorded_calls(module, {
                    k: c for k, c in NO_REGEN_CALLS[scene_id].items() if k in names}))
                    for module, names in ((sk, ("fused_nearest", "fused_occluded")),
                                          (pk, ("probe_min",))) if first]
                traced, dt, launches = session_run(sessions[use_regen], ticks)
            if first:
                got = {k: v for part in parts for k, v in part.items()}
                got_launches = launches
            if traced != ticks:
                raise AssertionError(f"{what}: traced {traced} of {ticks} paths")
            expect_launches(launches, 0, at_least_once=(
                regen_kernels if use_regen else per_pixel_kernels))
            runs[use_regen].append(dict(paths_per_sec=ticks / dt, seconds=dt,
                                        launches=launches))
        for sess in sessions.values():
            if not bool(torch.isfinite(sess.buffer.acc).all()):
                raise AssertionError(f"{what}: non-finite radiance")
        if set(got) != set(NO_REGEN_CALLS[scene_id]):
            raise AssertionError(f"{what}: the per-pixel run made too few calls to record "
                                 f"{NO_REGEN_CALLS[scene_id]} (recorded {sorted(got)})")
        check_path_inputs(record, got, f"{what} per-pixel " + " ".join(
            f"{k} call {c}" for k, c in NO_REGEN_CALLS[scene_id].items()), got_launches)
        log(f"{what}: {ticks} paths a run, paths/s per-pixel "
            f"{[r['paths_per_sec'] for r in runs[False]]}, regenerating "
            f"{[r['paths_per_sec'] for r in runs[True]]}; launches a run "
            f"{runs[False][0]['launches']} vs {runs[True][0]['launches']}; {card_line()}")
        rec[f"scene_{scene_id}"] = dict(gpu_vs_cpu=agree, per_pixel=runs[False],
                                        regenerating=runs[True])
    record["no_regen"] = rec


def phase_inverse_render(device, record):
    """The port's inverse-render example (``python -m
    wasm_pathtracer_tpu_torch.examples.inverse_render``) at its own
    defaults (40 steps, 48x48, lr 0.8, no device argument: the card):
    it must return 0, the largest diffuse albedo error below 0.8x its
    start.  Its train steps are timed by wrapping
    ``parallel.make_train_step``; its launches are counted (the shade
    kernel only in the renders outside the steps, which shade eagerly on
    the autograd path), and K1 and K2 held against their plain versions
    on the arguments of their call ``INVERSE_CALL`` in that run."""
    import io
    import torch
    from wasm_pathtracer_tpu_torch import parallel
    from wasm_pathtracer_tpu_torch.examples import inverse_render
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    from wasm_pathtracer_tpu_torch.ops import shade_kernels as shk
    make = parallel.make_train_step
    times, shaded_in_steps = [], []

    def timed_make(*args, **kw):
        step = make(*args, **kw)

        def timed(*a):
            torch.cuda.synchronize()
            n0 = shk.fused_shade.launches
            t0 = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            shaded_in_steps.append(shk.fused_shade.launches - n0)
            return out
        return timed

    buf = io.StringIO()
    parallel.make_train_step = timed_make
    which = {"fused_nearest": INVERSE_CALL, "fused_occluded": INVERSE_CALL}
    try:
        with contextlib.redirect_stdout(buf), recorded_calls(sk, which) as got:
            rc, dt, launches = counted_run(lambda: inverse_render.main([]))
    finally:
        parallel.make_train_step = make
    for line in buf.getvalue().splitlines():
        log(f"inverse_render | {line}")
    errs = [line.split(":")[1].split("->") for line in buf.getvalue().splitlines()
            if line.startswith("max albedo error:")]
    before, after = (float(x) for x in errs[0]) if errs else (float("nan"),) * 2
    log(f"inverse_render: exit {rc}, max diffuse albedo error {before} -> {after}, "
        f"{len(times)} steps at {len(times) / sum(times) if times else 0:.3f} steps/s "
        f"(median step {sorted(times)[len(times) // 2] if times else 0:.4f} s), "
        f"{dt:.1f} s in all, launches {launches}; {card_line()}")
    if rc != 0 or len(times) != 40:
        raise AssertionError("inverse_render: the example did not succeed at its defaults")
    expect_launches(launches, 0, at_least_once=("fused_nearest", "fused_occluded",
                                                "fused_shade"))
    if any(shaded_in_steps):
        raise AssertionError(f"inverse_render: train steps launched the shade kernel "
                             f"{shaded_in_steps} times")
    if set(got) != set(which):
        raise AssertionError(f"inverse_render: the run made fewer than {INVERSE_CALL + 1} "
                             f"calls of K1 and K2 (recorded {sorted(got)})")
    check_path_inputs(record, got, f"inverse_render call {INVERSE_CALL}", launches)
    record["inverse_render"] = dict(exit=rc, albedo_err_before=before,
                                    albedo_err_after=after, steps=len(times),
                                    steps_per_sec=len(times) / sum(times),
                                    step_seconds=times, seconds=dt, launches=launches)


def shade_inputs(device):
    """{"uniform": call, "pnee": call}: the arguments of the sixth
    ``shade_kernels.fused_shade`` call of each half of a 512x512 museum
    session, in ``fused_shade``'s order, recorded by wrapping
    ``integrator._shade_core``."""
    from wasm_pathtracer_tpu_torch.config import RenderType
    from wasm_pathtracer_tpu_torch.ops import integrator
    from wasm_pathtracer_tpu_torch.runtime.session import Session
    sess = Session(512, 512, scene_id=0, device=device)
    real = integrator._shade_core
    seen, got = {}, {}

    def recording(scene, settings, light_tab, *args, **kw):
        key = "pnee" if settings.render_type == RenderType.PNEE else "uniform"
        seen[key] = seen.get(key, 0) + 1
        if seen[key] == 6:
            got[key] = (scene, settings, light_tab, *args, kw["packed_rows"],
                        kw["photon_grid"])
        return real(scene, settings, light_tab, *args, **kw)

    integrator._shade_core = recording
    try:
        with eager_queue():
            while len(got) < 2:
                sess.compute(65_536)
    finally:
        integrator._shade_core = real
    return got


def shade_bytes(args, settings, photon_grid, n_rows, n_lights) -> int:
    """Bytes the shade kernel needs for one call: each lane's inputs and
    outputs once, the hit-row and light tables once; with PNEE each
    lane's CDF row and eight neighbour probabilities (cells the lanes
    share count once per lane)."""
    o, slot0 = args[0], args[7]
    R = o.shape[0]
    lane_in = 5 * 12 + 4 + 3 + 8 + 8 + (8 if hasattr(slot0, "shape") else 0)
    lane_out = 5 * 12 + 2 + (3 * 12 + 1 + 8 if settings.has_nee else 0)
    total = R * (lane_in + lane_out) + 96 * n_rows + 64 * n_lights
    if photon_grid is not None:
        total += R * 4 * (photon_grid.bins.shape[1] + 8)
    return total


def phase_shade(device, record):
    """The shade kernel against the eager ``_shade_core`` bit for bit, and
    both timed: on the main path's own call ``HEADLINE_CALL`` (16,384
    lanes), then on the session calls of ``shade_inputs`` (8,192 lanes,
    and the same lanes four times over) as other shapes.  Its launches
    are phase main's."""
    import torch
    from wasm_pathtracer_tpu_torch.config import RenderType
    from wasm_pathtracer_tpu_torch.ops import integrator
    from wasm_pathtracer_tpu_torch.ops import shade_kernels as shk
    calls = [("main path", headline_inputs(device)["fused_shade"], 1)]
    sessions = shade_inputs(device)
    calls += [(key, sessions[key], k) for key in ("uniform", "pnee") for k in (1, 4)]
    rec = record.setdefault("fused_shade", {})
    rec["other_shapes"] = {}
    for key, args, k in calls:
        scene, settings, light_tab = args[:3]
        lanes = [x.repeat(k, *([1] * (x.dim() - 1))) if torch.is_tensor(x) else x
                 for x in args[3:-2]] + list(args[-2:])
        grid = args[-1] if settings.render_type == RenderType.PNEE else None

        def eager():
            return integrator._shade_eager(scene, settings, light_tab, *lanes)

        def fused():
            return shk.fused_shade(scene, settings, light_tab, *lanes)

        (rc, rq), (gc, gq) = eager(), fused()
        outs = list(zip(rc, gc)) + ([(rq[n], gq[n]) for n in rq] if rq else [])
        differ = 0
        for r, g in outs:
            same = r == g
            if r.is_floating_point():
                same |= torch.isnan(r) & torch.isnan(g)
            differ += int((~same).sum())
        R = lanes[0].shape[0]
        if differ or (rq is None) != (gq is None):
            raise AssertionError(f"shade kernel, {key} at {R} lanes: {differ} values differ "
                                 "from the eager _shade_core")
        flops = R * (SHADE_FLOPS + (SHADE_PNEE_FLOPS + grid.bins.shape[1] if grid else 0))
        bound_ms, bound_by = bound(flops, shade_bytes(
            lanes, settings, grid, scene.params.shape[0], light_tab[0].shape[0]))
        ms = cuda_ms(fused, 50)
        plain_ms = cuda_ms(eager, 5, graph=False)
        row = dict(lanes=R, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, max_abs_err=0.0)
        log(f"shade kernel, {key} at {R} lanes: bit-equal, {ms:.4f} ms, eager "
            f"{plain_ms:.2f} ms, bound {bound_ms:.5f} ms by {bound_by} "
            f"({100 * bound_ms / ms:.1f}%)")
        if key == "main path":
            rec.update(row)
        else:
            rec["other_shapes"][f"{key}_{R}"] = row


# the regen kernel replaces the eager regeneration, no TPU kernel
REGEN_KERNEL = ("fused_regen", None, "wasm_pathtracer_tpu_torch/csrc/regen_kernels.cu")
# which regeneration of a queue loop ``regen_inputs`` records, counted from 0
REGEN_CALL = 2


def regen_inputs(device, route, lanes):
    """``(q, lanes, was, fin)``, copies of the arguments of regeneration
    ``REGEN_CALL`` of a queue loop on ``lanes`` lanes over 8 x ``lanes``
    random pixels of a 512x512 frame, 8 bounces, NEE: the museum through
    ``render_queue`` (``route`` "queue") or mesh70k through
    ``render_queue_flat`` ("flat"), recorded by wrapping
    ``regen_kernels.fused_regen``."""
    import dataclasses
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera
    from wasm_pathtracer_tpu_torch.ops import integrator, trace, wavefront
    from wasm_pathtracer_tpu_torch.ops import regen as rg
    from wasm_pathtracer_tpu_torch.ops import regen_kernels as rgk
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=8)
    if route == "flat":
        (scene, prep), cam, fn = mesh70k(device), mesh_camera(device), wavefront.render_queue_flat
    else:
        scene = scenes.museum(device)
        prep, cam, fn = trace.prepare(scene), initial_camera(0, device), integrator.render_queue
    real, got, calls = rgk.fused_regen, [], [0]

    def recording(q, ln, was=None, fin=None):
        if calls[0] == REGEN_CALL:
            got.append((dataclasses.replace(q, acc=q.acc.clone(), cnt=q.cnt.clone()),
                        rg.Lanes(**{f.name: None if getattr(ln, f.name) is None
                                    else getattr(ln, f.name).clone()
                                    for f in dataclasses.fields(ln)}), was, fin))
        calls[0] += 1
        real(q, ln, was, fin)

    # the wrapper counts its launches on whatever its module name holds
    recording.launches = real.launches
    rgk.fused_regen = recording
    try:
        with eager_queue():
            fn(prep, scene, st, cam, headline_queue(device, 8 * lanes), 512, 512, 6, lanes)
    finally:
        real.launches = recording.launches
        rgk.fused_regen = real
    if not got:
        raise AssertionError(f"regen inputs: the {route} loop made {calls[0]} regenerations")
    return got[0]


def packed_lanes(ln):
    """A uint8 buffer holding a copy of every register of ``ln``, 256-byte
    aligned, and a ``Lanes`` of views into it, so that one copy restores
    them all."""
    import dataclasses
    import torch
    from wasm_pathtracer_tpu_torch.ops import regen as rg
    regs = {f.name: getattr(ln, f.name) for f in dataclasses.fields(ln)
            if getattr(ln, f.name) is not None}
    offs, total = {}, 0
    for k, t in regs.items():
        offs[k] = total
        total += -(-t.numel() * t.element_size() // 256) * 256
    buf = ln.o.new_empty((total,), dtype=torch.uint8)
    views = {}
    for k, t in regs.items():
        n = t.numel() * t.element_size()
        views[k] = buf[offs[k]:offs[k] + n].view(t.dtype).view(t.shape)
        views[k].copy_(t)
    return buf, rg.Lanes(**views)


def regen_bytes(ln, fin, claims) -> int:
    """Bytes the regen kernel needs for one call: each lane register read
    and written once, the route's other per-lane inputs read once (the
    path's alive flag before the bounce, or the flat route's FINALIZE
    flags and shadow rays), and the queue entry each claim gathers.  The
    frame's atomic adds are left out."""
    import dataclasses
    regs = sum(getattr(ln, f.name).numel() * getattr(ln, f.name).element_size()
               for f in dataclasses.fields(ln) if getattr(ln, f.name) is not None)
    B = ln.pid.shape[0]
    inputs = B * (5 + 24) if fin is not None else B
    return 2 * regs + inputs + 8 * claims


def same_bits(a, b) -> bool:
    """Equal tensors, float32 compared bit for bit (-0 against +0 too)."""
    import torch
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def phase_regen(device, record):
    """The regen kernel against the eager ``regen.regen`` bit for bit on
    real loop iterations (``regen_inputs``: the museum's queue route and
    mesh70k's flat route, 8,192 and 16,384 lanes), then both timed on
    them.  The kernel writes its registers in place, so each timed call
    first restores them with one copy (``packed_lanes``); the copy alone
    is timed and taken off.  Its launches are phase main's."""
    import dataclasses
    import torch
    from wasm_pathtracer_tpu_torch.ops import regen as rg
    from wasm_pathtracer_tpu_torch.ops import regen_kernels as rgk
    rec = record.setdefault("fused_regen", {})
    rec["other_shapes"] = {}
    for route, lanes in (("queue", 16_384), ("queue", 8_192), ("flat", 16_384),
                         ("flat", 8_192)):
        q, ln, was, fin = regen_inputs(device, route, lanes)
        buf, work = packed_lanes(ln)
        pristine = buf.clone()

        def frame_copy():
            return dataclasses.replace(q, acc=q.acc.clone(), cnt=q.cnt.clone())

        eager_ln, eq = dataclasses.replace(work), frame_copy()
        rg.regen(eq, eager_ln, was, fin)
        claims = int(eager_ln.issued) - int(ln.issued)
        kq = frame_copy()
        rgk.fused_regen(kq, work, was, fin)
        differ = [f.name for f in dataclasses.fields(work) if getattr(work, f.name) is not None
                  and not same_bits(getattr(work, f.name), getattr(eager_ln, f.name))]
        if differ or not torch.equal(kq.cnt, eq.cnt) or not torch.allclose(
                kq.acc[:-1], eq.acc[:-1], rtol=1e-5, atol=1e-6):
            raise AssertionError(f"regen kernel, {route} route at {lanes} lanes: differs from "
                                 f"the eager regen in {differ or 'the frame'}")
        tq = frame_copy()

        def call():
            buf.copy_(pristine)
            rgk.fused_regen(tq, work, was, fin)

        copy_ms = cuda_ms(lambda: buf.copy_(pristine), 50)
        ms = cuda_ms(call, 50) - copy_ms
        plain_ms = cuda_ms(lambda: rg.regen(tq, dataclasses.replace(work), was, fin), 5,
                           graph=False)
        bound_ms, bound_by = bound(0, regen_bytes(work, fin, claims))
        row = dict(lanes=lanes, route=route, claims=claims, ms=ms, copy_ms=copy_ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=0.0)
        log(f"regen kernel, {route} route at {lanes} lanes ({claims} claims): bit-equal, "
            f"{ms:.4f} ms (less the {copy_ms:.4f}-ms restoring copy), eager {plain_ms:.2f} ms, "
            f"bound {bound_ms:.5f} ms by {bound_by} ({100 * bound_ms / ms:.1f}%); "
            f"{card_line()}")
        if (route, lanes) == ("queue", 16_384):
            rec.update(row)
        else:
            rec["other_shapes"][f"{route}_{lanes}"] = row

PHASES = {
    "k1": phase_kernel_k1,
    "k2": phase_kernel_k2,
    "main": phase_main_path,
    "gpu_vs_cpu": phase_gpu_vs_cpu,
    "cli": phase_cli,
    "k8": phase_kernel_k8,
    "clusters": phase_cluster_kernels,
    "mesh": phase_mesh_path,
    "mesh_gpu_vs_cpu": phase_mesh_gpu_vs_cpu,
    "lockstep": phase_lockstep,
    "k6_path": phase_k6_path,
    "cli_cloud": phase_cli_cloud,
    "sweep": phase_sweep_path,
    "bvh4": phase_bvh4,
    "pnee": phase_pnee,
    "adaptive": phase_adaptive,
    "cli_views": phase_cli_views,
    "grad": phase_grad,
    "grad_gpu_vs_cpu": phase_grad_gpu_vs_cpu,
    "train": phase_train,
    "edges": phase_edges,
    "whitted": phase_whitted,
    "whitted_gpu_vs_cpu": phase_whitted_gpu_vs_cpu,
    "live": phase_live,
    "cli_runtime": phase_cli_runtime,
    "shard": phase_shard,
    "defaults": phase_defaults,
    "no_regen": phase_no_regen,
    "inverse_render": phase_inverse_render,
    "shade": phase_shade,
    "regen": phase_regen,
}


def main(argv) -> int:
    import torch
    unknown = [p for p in argv if p not in PHASES]
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}; known: {list(PHASES)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    try:
        from wasm_pathtracer_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable ({e}); run "
              "from the root of a checkout", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    log(card_line())

    t0 = time.perf_counter()
    lib = _build.build()
    log(f"built {lib} in {time.perf_counter() - t0:.1f} s")
    log((lib.parent / "ptxas.txt").read_text().strip())

    record = {}
    for name in argv or PHASES:
        t0 = time.perf_counter()
        PHASES[name](device, record)
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    if argv:
        log(json.dumps(record))
        return 0

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=record[name]["launches"],
                    max_abs_err=record[name]["max_abs_err"],
                    ms=record[name]["ms"], plain_ms=record[name]["plain_ms"],
                    bound_ms=record[name]["bound_ms"], bound_by=record[name]["bound_by"],
                    library_ms=None, other_shapes=record[name].get("other_shapes", {}))
               for name, rep, src in KERNELS + (SHADE_KERNEL, REGEN_KERNEL)]
    log(json.dumps({k: record[k] for k in ("main_path", "mesh_path", "sweep_path",
                                           "pnee_path", "adaptive_1080p", "grad_path",
                                           "grad_gpu_vs_cpu", "train", "edges", "whitted",
                                           "whitted_gpu_vs_cpu", "live", "cli_runtime",
                                           "shard", "defaults", "no_regen",
                                           "inverse_render")}))
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
