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
   the plain version does not).  Kernel and plain device times at
   16,384 rays on the museum (``torch.profiler`` kernel durations).
4. K2, the any-hit shadow kernel, on shadow rays from those rays' hits
   toward random light points.  From origins within the scenes'
   geometry, verdicts agree on > 99.9% of rays.  From far origins
   (grazing ground hits 50 to ~10^5 units away) every verdict that
   differs must be a float32 rounding tie: the plain version's own
   verdict flips when the origin moves by at most 16 ulp (and >= 98%
   agree).
5. The main path at full width: the museum, 512x512, NEE, 8 bounces,
   S = 2,621,440 paths through ``render_queue`` with 16,384 lanes.
   Every sample is counted once, the radiance is finite, and each
   kernel's launch count equals the loop's iteration count.
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
   versions at 16,384 mesh70k rays.
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
   within rtol 1e-5 / atol 1e-5, slots on > 99% (the kernel's rsqrt is
   approximate and nvcc contracts to FMA; a slot may differ on a tie).
   Device times at 16,384 mesh70k rays.
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
   wall time the device was busy.
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

Each kernel's ``bound_ms`` is the least time the card could take for the
call that was timed: the larger of its bytes (each input and output
once) over 3.35 TB/s and its float32 operations over 67 TFLOP/s, the
H100's published rates.  Operations are counted from the inputs with the
per-test costs in ``FLOPS`` (one per add, multiply, compare, min, max,
divide or square root of the test as written in ``csrc``); torus marches
are counted at the steps these rays take (``torus_work``), and K8 at the
TPU kernel's 78 per pair.  No single PyTorch call computes any of the
eight functions, so ``library_ms`` is null.

The last lines of standard output are a JSON record of the paths, the
card's name and power limit, a JSON record of each kernel (launches in
the run of the path it serves, max |kernel - plain|, kernel, plain and
bound ms) and a JSON status line.  The whole script takes about two and
a half minutes on an H100.
"""

from __future__ import annotations

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


def cuda_ms(fn, n):
    """Mean device time of ``fn`` over ``n`` calls: the summed durations
    of the CUDA kernels it launched, from ``torch.profiler``.  (Events
    around the calls would also count the gaps in which the device waits
    for the host to launch the next kernel: a wrapper's Python takes
    longer than these kernels run.)  Raises when the profiler records no
    device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no CUDA kernel time")
    return us / 1e3 / n


PEAK_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM HBM3
# operations of one ray-primitive test as csrc/scene_families.cuh writes
# it, by family; "box" is one slab test, "sdf" one torus march step,
# "newton" one polish step, "sweep" K8's pair with the plane precomputed
FLOPS = {0: 19, 1: 30, 2: 113, 4: 27, 5: 15, "box": 27, "sdf": 22, "newton": 45,
         "sweep": 78}


def bound(flops, n_bytes):
    """(bound_ms, bound_by) of a call needing ``flops`` operations and
    ``n_bytes`` bytes of traffic."""
    t_ops, t_bytes = flops / PEAK_FLOPS, n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def torus_work(rows, o, d, t_max=None):
    """Operations the torus tests of (R, 3) rays against ``rows`` (n, 5)
    need on these inputs: a box test per pair, then for each pair whose
    box is hit (before ``t_max`` (R,), if given) the march steps and
    Newton steps taken until they reach their fixed point, as
    ``torus_march`` in ``csrc/scene_families.cuh`` exits."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import intersect as isx
    if rows.shape[0] == 0:
        return 0
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
    if t_max is not None:
        live &= t_lo < t_max[:, None]

    def sdf(t):
        return isx._torus_sdf(lo + ld * t[..., None], big_r, small_r)

    t = t_lo
    sign0 = torch.sign(sdf(t))
    sign0 = torch.where(sign0 == 0, 1.0, sign0)
    dist = sign0 * sdf(t)
    relaxed = torch.ones_like(live)
    marching = live.clone()
    n_sdf = 0
    for _ in range(24):
        step = dist * torch.where(relaxed, 1.6, 1.0)
        can = (dist > 1e-4) & (t < t_out)
        t2_ = t + torch.where(can, step, 0.0)
        d2 = sign0 * sdf(t2_)
        n_sdf += int(marching.sum())
        accept = (step <= 1e-4) | (d2 + dist >= step)
        marching &= can | (d2 != dist)
        t = torch.where(accept, t2_, t)
        dist = torch.where(accept, d2, dist)
        relaxed = accept
    # a Newton step runs while |f| > 1e-6; four at most (counted as the
    # march leaves them: converged marches take none)
    n_newton = 4 * int((live & (dist.abs() > 1e-6)).sum())
    return (o.shape[0] * rows.shape[0] * FLOPS["box"] + n_sdf * FLOPS["sdf"]
            + n_newton * FLOPS["newton"])


def scene_flops(tables, o, d, t_max=None):
    """Operations one whole-scene test of these rays needs (K1, K2, K3's
    dense half)."""
    R = o.shape[0]
    total = sum(R * tables.counts[f] * FLOPS[f] for f in (0, 1, 2, 4, 5))
    return total + torus_work(tables.family(3), o, d, t_max)


def probe_flops(cs, cidx):
    """Operations one probe round needs: each ray's cluster's real slots
    at their family's cost (mesh70k and the clouds hold triangles only;
    a torus slot is counted at its box test)."""
    bt = cs.btype[cidx.long().clamp(0, cs.num_clusters - 1)]
    return sum(int((bt == f).sum()) * FLOPS.get(f, FLOPS["box"]) for f in cs.families)


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


def wrappers():
    """Kernel wrapper of each name in ``KERNELS``."""
    from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    from wasm_pathtracer_tpu_torch.ops import traverse_kernels as tk
    return {"fused_nearest": sk.fused_nearest, "fused_occluded": sk.fused_occluded,
            "select_scan": pk.select_scan, "probe_pair": pk.probe_pair,
            "probe_min": pk.probe_min, "select_blocks": pk.select_blocks,
            "probe_blocks": pk.probe_blocks, "dense_tri_nearest": tk.dense_tri_nearest}


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
    lights, with the light's kernel code as the exclusion (-1 on every
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
    excl = prep.code_of[lsid].to(torch.int32)
    excl[::10] = -1
    return oo, dd, dist.contiguous(), excl.contiguous(), hit & (t >= 50.0)


def rounding_ties(tables, o, d, dist, excl, max_ulps=16, n_jitter=2048, seed=0):
    """(R,) bool: shadow rays whose verdict float32 does not settle.  The
    plain version is evaluated with each origin coordinate moved by up
    to ``max_ulps`` units in the last place (``n_jitter`` random moves);
    a ray is a tie when both verdicts occur.  The kernel (the Pallas
    kernel's formulas, FMA-contracted) and the plain version (the dense
    formulas, separately rounded) compute t = (n.v0 - n.o) / (n.d) and
    o + d t with different roundings; from an origin 10^4 units out the
    cancellation leaves errors of several ulp of the origin, more at
    grazing angles."""
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

    v = sk.fused_occluded_reference(tables, oj, rep(d), rep(dist),
                                    rep(excl)).view(n_jitter, R)
    return v.any(0) & ~v.all(0)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernel_k1(device, record):
    import torch
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    from wasm_pathtracer_tpu_torch.ops import trace
    worst = 0.0
    for i, (name, scene) in enumerate(smoke_scenes(device).items()):
        prep = trace.prepare(scene)
        tables = prep.tables
        o, d = test_rays(16_384 + 37, 100 + i, device)
        t_k, f_k, s_k = sk.fused_nearest(tables, o, d)
        t_p, f_p, s_p = sk.fused_nearest_reference(tables, o, d)
        torch.cuda.synchronize()
        hit_k, hit_p = f_k >= 0, f_p >= 0
        both = hit_k & hit_p
        hit_agree = (hit_k == hit_p).float().mean().item()
        err = (t_k[both] - t_p[both]).abs().max().item() if both.any() else 0.0
        t_ok = torch.allclose(t_k[both], t_p[both], rtol=1e-5, atol=1e-4)
        sid_agree = ((f_k == f_p) & (s_k == s_p))[both].float().mean().item()
        log(f"K1 {name}: hit agreement {hit_agree:.6f}, max |dt| {err:.3g}, "
            f"shape-id agreement {sid_agree:.6f}, hit rate "
            f"{hit_p.float().mean().item():.3f}")
        if not (hit_agree > 0.999 and t_ok and sid_agree > 0.995):
            raise AssertionError(f"K1 disagrees with its plain version on {name}")
        worst = max(worst, err)
        if name == "museum":
            o16, d16 = o[:16_384].contiguous(), d[:16_384].contiguous()
            ms = cuda_ms(lambda: sk.fused_nearest(tables, o16, d16), 50)
            plain_ms = cuda_ms(lambda: sk.fused_nearest_reference(tables, o16, d16), 5)
            b_ms, b_by = bound(scene_flops(tables, o16, d16),
                               4 * tables.flat.numel() + 16_384 * (24 + 12))
    log(f"K1 museum B=16384: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms by {b_by}")
    record.setdefault("fused_nearest", {}).update(max_abs_err=worst, ms=ms,
                                                  plain_ms=plain_ms, bound_ms=b_ms,
                                                  bound_by=b_by)


def phase_kernel_k2(device, record):
    """Near origins (within the scenes' geometry): verdicts agree on
    > 99.9% of rays.  Far origins (grazing hits > 50 units away, where a
    float32 ulp of the origin is 4e-6 to 8e-3): every verdict that
    differs is a rounding tie (``rounding_ties``), and >= 98% agree.
    Ties are common there (the origin sits on the ground plane within an
    ulp), so the share of ties among far rays is printed beside them."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    from wasm_pathtracer_tpu_torch.ops import trace
    worst = 0.0
    for i, (name, scene) in enumerate(smoke_scenes(device).items()):
        prep = trace.prepare(scene)
        tables = prep.tables
        o, d = test_rays(16_384 + 37, 200 + i, device)
        so, sd, dist, excl, far = shadow_rays(prep, scene, o, d, 300 + i)
        occ_k = sk.fused_occluded(tables, so, sd, dist, excl)
        occ_p = sk.fused_occluded_reference(tables, so, sd, dist, excl)
        torch.cuda.synchronize()
        diff = occ_k != occ_p
        n_near, n_far = int((~far).sum()), int(far.sum())
        d_near, d_far = int((diff & ~far).sum()), int((diff & far).sum())
        agree_near = 1.0 - d_near / max(n_near, 1)
        agree_far = 1.0 - d_far / max(n_far, 1)
        idx = torch.nonzero(diff & far)[:, 0]
        ties = rounding_ties(tables, *(x[idx] for x in (so, sd, dist, excl)))
        # how common ties are among far rays in general (256 of them)
        sample = torch.nonzero(far)[:256, 0]
        base = rounding_ties(tables, *(x[sample] for x in (so, sd, dist, excl)))
        log(f"K2 {name}: near origins {d_near} of {n_near} differ (agreement "
            f"{agree_near:.6f}); far origins {d_far} of {n_far} differ (agreement "
            f"{agree_far:.6f}), {int(ties.sum())} of them rounding ties, ties among "
            f"{sample.numel()} far rays {base.float().mean().item() if sample.numel() else 0.0:.4f}; "
            f"occluded rate {occ_p.float().mean().item():.3f}")
        for j, tie in list(zip(idx.tolist(), ties.tolist()))[:8]:
            log(f"  differs: |origin| {so[j].abs().max().item():.6g}, light at "
                f"{dist[j].item():.6g}, excl {int(excl[j])}, kernel "
                f"{bool(occ_k[j])}, tie {tie}")
        if not (agree_near > 0.999 and agree_far >= 0.98 and bool(ties.all())):
            raise AssertionError(f"K2 disagrees with its plain version on {name}")
        worst = max(worst, diff.float().max().item())
        if name == "museum":
            args = [x[:16_384].contiguous() for x in (so, sd, dist, excl)]
            ms = cuda_ms(lambda: sk.fused_occluded(tables, *args), 50)
            plain_ms = cuda_ms(lambda: sk.fused_occluded_reference(tables, *args), 5)
            # a torus whose box entry lies beyond the light cannot occlude
            b_ms, b_by = bound(scene_flops(tables, args[0], args[1], t_max=args[2]),
                               4 * tables.flat.numel() + 16_384 * (24 + 8 + 1))
    log(f"K2 museum B=16384: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms by {b_by}")
    record.setdefault("fused_occluded", {}).update(max_abs_err=worst, ms=ms,
                                                   plain_ms=plain_ms, bound_ms=b_ms,
                                                   bound_by=b_by)


def busy_share(fn):
    """Share of the wall time of ``fn()`` in which the device ran a
    kernel: summed kernel durations from ``torch.profiler`` over the host
    clock (the profiler's own overhead is in the wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.device_time)
    total = sum(us for _, us in by_name.values())
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no CUDA kernel time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
    log(f"device time {total / 1e3:.1f} ms of {1e3 * wall:.1f} ms wall in "
        f"{sum(n for n, _ in by_name.values())} kernels; top: " + "; ".join(
            f"{name[:48]} x{n} {us / 1e3:.1f} ms" for name, (n, us) in top))
    return total / 1e6 / wall


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
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    acc, cnt, cost, iters = queue_fn(prep, scene, st, cam, pix, h["width"], h["height"],
                                     2, h["B"], return_iters=True, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
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
    launches, iters, rec = run_queue("main path: museum", integrator.render_queue,
                                     trace.prepare(scene), scene, st,
                                     initial_camera(0, device), h, device)
    expect_launches(launches, iters, ("fused_nearest", "fused_occluded"))
    for name in ("fused_nearest", "fused_occluded"):
        record.setdefault(name, {})["launches"] = launches[name]
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


def png_pixels(path) -> np.ndarray:
    """Decode an 8-bit RGB PNG as written by ``utils.png`` (filter 0)."""
    data = open(path, "rb").read()
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
        img = png_pixels(out)
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


def check_probe(cs, o, d, cidx, out_k, out_p, what):
    """Hold one probe round's (t, sid) against its plain version's.
    Returns (max |dt|, ids that differ on a rounding tie, hit rate)."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import cluster as cl
    (t_k, s_k), (t_p, s_p) = out_k, out_p
    fin_k, fin_p = torch.isfinite(t_k), torch.isfinite(t_p)
    both = fin_k & fin_p
    agree = (fin_k == fin_p).float().mean().item()
    if not (agree > 0.999 and torch.allclose(t_k[both], t_p[both], rtol=1e-5, atol=1e-5)
            and bool((s_k[~fin_k] == -1).all())):
        raise AssertionError(f"{what}: distances disagree (hit agreement {agree:.6f})")
    worst = (t_k[both] - t_p[both]).abs().max().item() if both.any() else 0.0
    idx = torch.nonzero(both & (s_k != s_p))[:, 0]
    if idx.numel():
        c = cidx[idx].long().clamp(0, cs.num_clusters - 1)
        t_slots = cl._block_test(o[idx], d[idx], cs.blocks[c], cs.btype[c], cs.families)
        grid = cs.slot_to_sid.view(cs.num_clusters, cs.group)[c]
        jk = (grid == s_k[idx, None]).int().argmax(1)
        jp = (grid == s_p[idx, None]).int().argmax(1)
        rows = torch.arange(idx.numel(), device=o.device)
        if not torch.isclose(t_slots[rows, jk], t_slots[rows, jp], rtol=1e-5,
                             atol=1e-5).all():
            raise AssertionError(f"{what}: shape ids differ off a tie")
    return worst, idx.numel(), fin_p.float().mean().item()


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


def phase_cluster_kernels(device, record):
    """K3-K7 against their plain versions on three cluster sets."""
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
        times = {k: (cuda_ms(kern, 20), cuda_ms(plain, 3))
                 for k, (kern, plain) in calls.items()}
        log(f"{name} B=16384 device ms (kernel, plain): " + ", ".join(
            f"{k} {ms:.4f} / {pms:.4f}" for k, (ms, pms) in times.items()))
        if name == "mesh70k":
            C, G, B = cs.num_clusters, cs.group, 16_384
            slab = B * C * FLOPS["box"]
            rays, boxes, table = B * 24, 4 * 6 * C, 4 * cs.table.numel()
            probe = probe_flops(cs, a)
            bounds = {
                "select_blocks": bound(slab, rays + B * 8 + boxes + B * 20),
                "select_scan": bound(slab + scene_flops(prep.tables, o16, d16),
                                     rays + B * 8 + boxes + 4 * prep.tables.flat.numel()
                                     + B * 28),
                "probe_pair": bound(probe + probe_flops(cs, b), rays + B * 8 + table + B * 16),
                "probe_min": bound(probe, rays + B * 4 + table + B * 8),
                "probe_blocks": bound(probe, rays + B * 4 + table + B * G * 4)}
            for k, (ms, pms) in times.items():
                record.setdefault(k, {}).update(ms=ms, plain_ms=pms, bound_ms=bounds[k][0],
                                                bound_by=bounds[k][1])
            log("mesh70k bounds: " + ", ".join(f"{k} {v[0]:.5f} ms by {v[1]}"
                                               for k, v in bounds.items()))
    for k, err in errs.items():
        record.setdefault(k, {})["max_abs_err"] = err


def phase_kernel_k8(device, record):
    """K8 against its plain version: mesh70k's 70,314 triangles and
    cloud300k's, 16,384 + 37 camera and random rays each.  Hits agree on
    > 99.9% of rays, t within rtol 1e-5 / atol 1e-5 where both hit, slots
    on > 99% (the rule of the JAX package's ``tests/test_pallas_dense.py``:
    the kernel's rsqrt is approximate and nvcc contracts to FMA), a miss
    reads slot -1.  Device times at 16,384 rays on mesh70k."""
    import torch
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera
    from wasm_pathtracer_tpu_torch.ops import trace
    from wasm_pathtracer_tpu_torch.ops import traverse_kernels as tk
    sets = {"mesh70k": (scenes.mesh_scene(scenes.surface_mesh(188), device),
                        mesh_camera(device)),
            "cloud300k": (scenes.cloud(300_000, device=device), initial_camera(5, device))}
    worst = 0.0
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
        if name == "mesh70k":
            o16, d16 = o[:16_384].contiguous(), d[:16_384].contiguous()
            ms = cuda_ms(lambda: tk.dense_tri_nearest(rows, o16, d16), 5)
            plain_ms = cuda_ms(lambda: tk.dense_tri_nearest_reference(rows, o16, d16), 1)
            b_ms, b_by = bound(16_384 * rows.shape[0] * FLOPS["sweep"],
                               4 * rows.numel() + 16_384 * (24 + 8))
            log(f"K8 mesh70k B=16384: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {b_ms:.4f} ms by {b_by}")
            record.setdefault("dense_tri_nearest", {}).update(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    record["dense_tri_nearest"]["max_abs_err"] = worst


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
    expect_launches(launches, iters, ("select_scan", "probe_pair"))
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
    expect_launches(launches, iters, at_least_once=("fused_nearest", "probe_min"))
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
    expect_launches(launches7, iters7, at_least_once=("fused_nearest", "probe_blocks"))
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
    expect_launches(launches, iters, ("select_blocks", "fused_nearest", "probe_pair"))
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
    expect_launches(launches, iters,
                    twice_per_iteration=("dense_tri_nearest", "fused_nearest"))
    record.setdefault("dense_tri_nearest", {})["launches"] = launches["dense_tri_nearest"]
    short = headline_queue(device, 8 * h["B"])
    rec["device_busy_share"] = busy_share(lambda: integrator.render_queue(
        prep, scene, st, cam, short, h["width"], h["height"], 3, h["B"]))
    log(f"dense-sweep path: device busy {100 * rec['device_busy_share']:.1f}% of wall "
        f"time under the profiler (S={short.numel()})")
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
    expect_launches(launches, out_b[3], twice_per_iteration=("fused_nearest",))
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
    expect_launches(launches, iters, ("fused_nearest", "fused_occluded"))
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
    expect_launches(launches, 0, at_least_once=("fused_nearest", "fused_occluded"))
    record["adaptive_1080p"] = dict(paths_per_sec=traced / dt, seconds=dt,
                                    bootstrap_paths_per_sec=2 * n_boot * batch / t_boot,
                                    excess_mass=excess)


def phase_cli_views(device, record):
    cli_render(0, ["--ticks", "1572864", "--right-type", "2", "--right-adaptive",
                   "--show-sampling", "--max-bounces", "8"])
    cli_render(4, ["--debug-view", "bvh"])


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
                    library_ms=None)
               for name, rep, src in KERNELS]
    log(json.dumps({k: record[k] for k in ("main_path", "mesh_path", "sweep_path",
                                           "pnee_path", "adaptive_1080p")}))
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
