"""Traffic kind ``frames_regen_ranks4``: a viewer watching a session that
converges over several cards, one process a card.

The closed loop of ``session_frames`` (imported, its file unchanged) with
each batch sharded over the configuration's ``workers`` ranks.  The ranks
are started through the port's own launch path,
``parallel.distributed.launch`` (as ``runtime/cli.py --ranks`` starts
them): one process a card, forked by a server that has imported torch
and the port once, NCCL, each rank's host threads on a disjoint share of
the CPUs, the communicator made by a warm all-reduce before the session
exists, and the kernels built once, here, before any rank starts.
Every rank holds the whole session (``Session(..., mesh=)``); a frame is
``Session.compute(frame_ticks)`` on every rank, one batch a half of
``workers x ray_batch_size`` paths of which each rank traces its shard,
and ``Session.results()`` on rank 0, the viewer's.

Set-up is ``session_frames``'s on every rank (photons, ``warm_frames``,
one adaptive pick), closed by a barrier of all ranks.  The window opens
and closes at a barrier too, and rank 0's clock decides before each frame
whether it starts (``distributed.rank0_decides``: a host message, no
device work), so every rank renders the same frames.  ``paths_per_s``
counts every rank's paths: rank 0's ``compute`` returns the whole
frame's.  Nothing is read for a frame's latency: a frame over four
processes ends with the slowest of them, so its tail is the host jitter
of four (``museum.session`` keeps the one-card frame latency of the same
code).

What is checked (``reference/sharded_check.py``): rank 0's frames as
``session_frames`` checks them, with the sampled queue entries drawn from
every rank's shard; each rank's own sample counts before the all-reduce
(``shard_count_mismatch_px``); every rank's buffer against rank 0's,
gathered after the window (``rank_buffer_mismatch_bytes``).  Every
rank's loaded modules are gathered last (``modules_of_ranks``), and a
rank that loaded JAX refuses the run, as the launching process's own
check does.  With ``control`` the run also judges the bfloat16 control
and, in three short runs of the same ranks, the planted faults of
``FAULTS``.

Parameters (``traffic/<name>.json``): ``session_frames``'s, and
``rank_timeout_s``, the process group's timeout.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import time

from portbench import harness
from portbench.traffic import session_frames as sf

# faults planted in the ranks of a control run, each aimed at one check:
# a rank that keeps its own sums past the all-reduce (rank_buffer_mismatch_bytes),
# a rank whose shard is never traced (shard_count_mismatch_px), and paths
# keyed by their index in the rank's shard (radiance_mismatch_pct)
FAULTS = ("rank_keeps_own_sums", "shard_skipped", "local_keys")
# the window of a fault's run, seconds at most
FAULT_SECONDS = 3.0
# a full-size configuration is rendered on the cards only
CPU_MAX_PIXELS = 64 * 64


def _launch_path():
    """The port's ``launch``, refused when the program cannot shard a
    session (an older commit)."""
    try:
        from wasm_pathtracer_tpu_torch.parallel import distributed
        from wasm_pathtracer_tpu_torch.runtime.session import Session
    except ImportError as e:
        raise harness.Refused(f"the port cannot be imported: {e}") from None
    if not hasattr(distributed, "launch") or \
            "mesh" not in inspect.signature(Session).parameters:
        raise harness.Refused("this port's Session takes no mesh and it has no launch "
                              "path: it cannot shard a session over ranks")
    return distributed.launch


def run(run, control: bool = False) -> dict:
    launch = _launch_path()
    cfg, tf = run.config, run.traffic
    ranks = int(cfg["workers"])
    if tf["frame_ticks"] != 2 * ranks * cfg["settings"]["ray_batch_size"]:
        raise harness.Refused("a frame must trace one batch a half, ray_batch_size a rank")
    if run.device == "cpu" and cfg["width"] * cfg["height"] > CPU_MAX_PIXELS:
        raise harness.Refused(f"{run.name} at {cfg['width']}x{cfg['height']} runs on "
                              f"{ranks} CUDA cards; the CPU renders it cut only")
    if run.device != "cpu":
        from wasm_pathtracer_tpu_torch.ops import _build
        _build.build()
    built = time.perf_counter() - run.t0
    # the ranks import this file by its module name to find rank_main
    me = importlib.import_module("portbench.traffic.frames_regen_ranks4")

    def go(r, fault=None):
        return launch(me.rank_main, ranks, args=(r, control, fault), device=r.device,
                      timeout_s=float(tf["rank_timeout_s"]))

    out = go(run)
    if out["jax_modules"]:
        raise harness.Refused(f"a rank loaded {out['jax_modules']}; no result")
    out["note"] += f"; kernels built at {built:.2f} s"
    if control:
        short = dataclasses.replace(run, seconds=min(run.seconds, FAULT_SECONDS),
                                    trace=False)
        for fault in FAULTS:
            out[f"fault_{fault}"] = go(short, fault)["checks"]
    return out


def plant(fault: str, mesh, integrator, wavefront):
    """Break this rank's program underneath the session, as ``fault``
    says (rank 1 for a fault of one rank)."""
    from wasm_pathtracer_tpu_torch.parallel import shard
    if fault == "rank_keeps_own_sums":
        if mesh.rank == 1:
            reduce = shard.RayMesh.all_reduce

            def keep(self, t):
                # the collective still runs, so the peers do not wait
                reduce(self, t.clone())
                return t
            shard.RayMesh.all_reduce = keep
        return
    for mod, name in ((integrator, "render_queue"), (wavefront, "render_queue_flat")):
        fn = getattr(mod, name)

        def broken(prep, scene, settings, camera, pix_queue, width, height, seed, lanes,
                   _fn=fn, **kw):
            if fault == "shard_skipped" and mesh.rank == 1:
                import torch
                dev = pix_queue.device
                return (torch.zeros((width * height, 3), device=dev),
                        torch.zeros(width * height, dtype=torch.int32, device=dev),
                        torch.zeros(1, dtype=torch.int32, device=dev))
            if fault == "local_keys":
                kw["rid_base"] = (kw["rid_base"] - mesh.rank * pix_queue.shape[0]) & harness.M32
            return _fn(prep, scene, settings, camera, pix_queue, width, height, seed,
                       lanes, **kw)
        setattr(mod, name, broken)


def modules_of_ranks(group) -> list:
    """``harness.jax_modules()`` of every rank, joined, on every rank (a
    collective over the host group ``group``): the rendering happens in
    the ranks, which the launching process's own check does not see."""
    import torch.distributed as dist
    lists = [None] * dist.get_world_size(group)
    dist.all_gather_object(lists, harness.jax_modules(), group=group)
    return sorted(set().union(*lists))


class ShardCounts:
    """Records, in the frames ``frame`` names, each batch's own sample
    counts on this rank (its shard's, before the all-reduce sums them),
    keyed by (frame, half, the half's batch index) from ``cap``."""

    def __init__(self, cap, integrator, wavefront):
        self.cap = cap
        self.frame = None
        self.got: dict = {}
        for mod, name in ((integrator, "render_queue"), (wavefront, "render_queue_flat")):
            setattr(mod, name, self._spy(getattr(mod, name)))

    def _spy(self, fn):
        def spied(*args, **kw):
            acc, cnt, cost = fn(*args, **kw)
            if self.frame is not None:
                half = self.cap.half
                self.got[(self.frame, half, self.cap.batches[half])] = cnt.clone()
            return acc, cnt, cost
        return spied


def rank_main(mesh, run, control: bool = False, fault: str | None = None):
    """One rank of the cell; rank 0 returns the run's result."""
    import torch
    import torch.distributed as dist
    from wasm_pathtracer_tpu_torch.ops import accum, adaptive, integrator, wavefront
    from wasm_pathtracer_tpu_torch.parallel import distributed
    from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    from wasm_pathtracer_tpu_torch.runtime.session import Session

    from portbench.reference import sharded_check as shc

    root = mesh.rank == 0
    # set-up's phases, seconds from the run's start
    stamps = {"joined": time.perf_counter() - run.t0}
    # rank 0's word, heard by every rank: host messages only
    ctrl = distributed.host_group()
    agree = distributed.rank0_decides

    cfg, tf, dev = run.config, run.traffic, run.device
    if fault is not None:
        plant(fault, mesh, integrator, wavefront)
    modules = {"scene_kernels": sk, "probe_kernels": pk}
    wrappers = {w: getattr(modules[m], w) for m, ks in sf.KERNELS.items() for w in ks}
    W, H = cfg["width"], cfg["height"]
    session_seed = harness.fold(run.seed, 0x5E55)
    left = sf.settings_of(cfg, "left", tf["use_regen"])
    right = sf.settings_of(cfg, "right", tf["use_regen"])
    sess = Session(W, H, cfg["scene_id"], left=left, right=right, seed=session_seed,
                   device=dev, mesh=mesh)
    halves = (sess.left, sess.right)
    whole = shc.whole_batch_config(cfg)
    stamps["session"] = time.perf_counter() - run.t0

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    def frame():
        with run.span("compute"):
            n = sess.compute(tf["frame_ticks"])
        img = None
        if root:
            with run.span("results"):
                img = sess.results()
        return n, img

    def photons_pending():
        return any(h.photon_grid is not None
                   and int(h.photon_grid.num_photons) < h.settings.total_photons
                   for h in halves)

    has_adaptive = cfg["left"]["adaptive"] or cfg["right"]["adaptive"]
    fixed = sf.check_frames(run)
    checked = set(fixed)
    drawn, eligible = None, 0
    before, after, frames_u8 = {}, {}, {}
    paths, failed = 0, 0
    with sf.Capture(accum, adaptive, sess.right.x0) as cap:
        shards = ShardCounts(cap, integrator, wavefront)
        n_setup = 0
        while photons_pending() or n_setup == 0:
            if n_setup == sf.MAX_PHOTON_FRAMES:
                raise RuntimeError(f"the photons are not done after {n_setup} frames")
            frame()
            n_setup += 1
        sync()
        stamps["photons"] = time.perf_counter() - run.t0
        for _ in range(tf["warm_frames"]):
            frame()
        for h in halves:
            if h.settings.adaptive:
                adaptive.pick_pixels(sess.buffer, h.settings.ray_batch_size * mesh.size, 1,
                                     False, h.settings.adaptive_spp_scale, h.x0, h.y0,
                                     h.width, h.height)
        sync()
        stamps["warm"] = time.perf_counter() - run.t0
        l0, b0 = harness.launches(wrappers), sum(cap.batches)
        iters0 = sess.num_queue_iters
        cap.chain = []
        # set-up ends and the window opens when every rank is here
        dist.barrier(group=ctrl)
        t_start = time.perf_counter()
        setup_s = t_start - run.t0
        w = 0
        while agree(time.perf_counter() - t_start < run.seconds):
            if has_adaptive and sf.adaptive_past_bootstrap(whole, cap.batches):
                # one frame past the bootstrap, uniform over those rendered
                eligible += 1
                if harness.fold(run.seed, 0xAD000 + eligible) % eligible == 0:
                    if drawn is not None and drawn not in fixed:
                        checked.discard(drawn)
                        for d in (before, after, frames_u8, cap.got):
                            d.pop(drawn, None)
                        shards.got = {k: v for k, v in shards.got.items() if k[0] != drawn}
                    drawn = w
                    checked.add(w)
            shards.frame = w if w in checked else None
            cap.frame = shards.frame if root else None
            if cap.frame is not None:
                before[w] = (sess.buffer.acc.clone(), sess.buffer.count.clone())
            n = sess.compute(tf["frame_ticks"])
            if root:
                if cap.frame is not None:
                    after[w] = (sess.buffer.acc.clone(), sess.buffer.count.clone())
                img = sess.results()
                if cap.frame is not None:
                    frames_u8[w] = img
            paths += n
            failed += n < tf["frame_ticks"]
            w += 1
        sync()
        dist.barrier(group=ctrl)
        window_s = time.perf_counter() - t_start
        cap.frame = shards.frame = None
        chain = [(h, b, 0 if pos is None else int(pos), int(new))
                 for h, b, pos, new in cap.chain]
        cap.chain = None
        batches = sum(cap.batches) - b0
        iters = sess.num_queue_iters - iters0
        l1 = harness.launches(wrappers)

        profile, slice_bytes = None, 0
        if run.trace:
            if root:
                stride, most = tf["roofline_sample"]
                samples = [(modules[m], {k: (stride, most) for k in ks})
                           for m, ks in sf.KERNELS.items()]
                kernels = {k: v for ks in sf.KERNELS.values() for k, v in ks.items()}

                def slice_frames():
                    nonlocal slice_bytes
                    agree(True)
                    b = mesh.bytes_all_reduced
                    for _ in range(tf["profile_frames"]):
                        frame()
                    slice_bytes = mesh.bytes_all_reduced - b

                try:
                    profile = harness.profile_slice(slice_frames, wrappers, kernels, samples,
                                                    tf["profile_frames"])
                finally:
                    agree(False)
            else:
                while agree(False):
                    for _ in range(tf["profile_frames"]):
                        frame()

    # every rank's window iterations, memory peak and buffer, and each
    # checked batch's shard counts, gathered on every rank
    peak = int(torch.cuda.max_memory_allocated()) if dev != "cpu" else 0
    gathered = torch.cat(mesh.all_gather(torch.tensor(
        [iters, peak] + [int(1e6 * v) for v in stamps.values()], dtype=torch.int64,
        device=sess.device)[None])).tolist()
    rank_iters, peaks = [g[0] for g in gathered], [g[1] for g in gathered]
    phases = {k: [round(g[2 + i] / 1e6, 2) for g in gathered] for i, k in enumerate(stamps)}
    rank_buffers = list(zip(mesh.all_gather(sess.buffer.acc),
                            mesh.all_gather(sess.buffer.count)))
    HW = W * H
    shard_counts = {}
    for key in sorted(k for k in shards.got if k[0] in checked):
        mine = shards.got[key].to(device=sess.device, dtype=torch.int32)
        shard_counts[key] = mesh.all_gather(mine.reshape(HW))
    prog_bins = [None if h.photon_grid is None else h.photon_grid.bins.clone() for h in halves]
    device = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if root and dev != "cpu":
        device = dict(harness.card(), count=mesh.size, memory_peak_bytes=max(peaks))
    del sess, halves
    if dev != "cpu":
        torch.cuda.empty_cache()
    if not root:
        modules_of_ranks(ctrl)      # rank 0 judges
        return None

    e2e = {"setup_s": {"value": setup_s, "unit": "s"},
           "paths_per_s": {"value": paths / window_s, "unit": "paths/s"}}
    e2e = {m["name"]: e2e[m["name"]] for m in run.end_to_end if m["name"] in e2e}
    obs = harness.Observed(
        config=cfg,
        counters={"launches": {k: l1[k] - l0[k] for k in l1}, "batches": batches,
                  "paths": paths, "frames": w, "ranks": mesh.size,
                  "rank_queue_iters": rank_iters, "slice_bytes_all_reduced": slice_bytes},
        host={"window_s": window_s}, profile=profile)
    out = {"end_to_end": e2e, "attempted": w, "failed": int(failed), "device": device}
    if run.trace:
        out["per_layer"] = harness.read_per_layer(run, obs)
        out["breakdown"] = harness.breakdown(profile)
        out["device"]["busy_s"] = profile.busy_s()
        out["device"]["window_s"] = profile.wall_s
    t_ref = time.perf_counter()
    if has_adaptive and drawn is None:
        checked.add(-1)     # due past the bootstrap, never rendered: missing
    out["checks"] = shc.judge(run, session_seed, cap.got, before, after, frames_u8, prog_bins,
                              checked, chain, shard_counts, rank_buffers, mesh.size)
    if control and fault is None:
        ctrl_ref = shc.reference(run.config, session_seed, dev, "bfloat16")

        def lower(half, b, px, py, idx):
            return ctrl_ref.queue_radiance(half, b, py * W + px, idx)

        bins = [None if h.grid is None else h.grid.bins for h in ctrl_ref.halves]
        out["control_checks"] = shc.judge(run, session_seed, cap.got, before, after, frames_u8,
                                          bins, checked, chain, shard_counts, rank_buffers,
                                          mesh.size, program=lower)
    out["reference_s"] = time.perf_counter() - t_ref
    out["note"] = (f"checked frames {sorted(checked)}; {mesh.size} ranks, queue iterations "
                   f"{rank_iters}; set-up phases by rank (s) {phases}, set-up {setup_s:.2f} s")
    out["jax_modules"] = modules_of_ranks(ctrl)
    return out
