"""Traffic kind ``session_frames``: a viewer watching a session converge.

A closed loop of frames on one ``Session`` (the port's
``runtime/session.py``), as the live viewer runs them: a frame is
``Session.compute(frame_ticks)`` (one batch per half) and then
``Session.results()``, the uint8 frame on the host.  Set-up builds the
session from the configuration, renders until every PNEE half holds its
photons, renders ``warm_frames`` more and draws one variance-guided
pick, so that every kernel and every shape of the window has run once.
The window then renders frames until ``--seconds`` have passed.  Where
a half is adaptive, one more frame is checked: one past every adaptive
half's bootstrap, drawn from the seed among those the window rendered.

Parameters (``traffic/<name>.json``): ``frame_ticks``, ``use_regen``
(the regenerating queue, or one sample a picked pixel through
``render_pixels``), ``warm_frames``, ``check_frames`` (ranges of window
frames; one frame of each range, drawn from the seed, is checked),
``profile_frames`` (frames in a traced run's profiled slice, after the
window) and ``roofline_sample`` ([stride, most] of the kernel calls whose
work is counted there).
"""

from __future__ import annotations

import time

from portbench import harness

# the port's kernel wrappers, by module, and the CUDA kernel each launches
KERNELS = {
    "scene_kernels": {"fused_nearest": "fused_nearest_kernel",
                      "fused_occluded": "fused_occluded_kernel"},
    "probe_kernels": {"select_scan": "select_kernel", "select_blocks": "select_kernel",
                      "probe_pair": "probe_kernel", "probe_min": "probe_kernel",
                      "probe_blocks": "probe_kernel"},
}


# set-up frames a PNEE half may spend on its photons
MAX_PHOTON_FRAMES = 64


class Capture:
    """Follows the session's batches: which half picks (``random_pixels``
    / ``pick_pixels``) and what each batch hands to the accumulation
    buffer (``accum.write_sums`` / ``write_samples``), counting every
    half's batches from the start.  In a checked frame (``frame`` set) it
    records each batch's output and the buffer and sweep position an
    adaptive pick reads, keyed by (half, the half's batch index).  While
    ``chain`` is a list it gathers every adaptive pick's (half, batch
    index, sweep position read, position returned), as device scalars."""

    def __init__(self, accum, adaptive, x_right: int):
        self.accum, self.adaptive = accum, adaptive
        self.x_right = x_right
        self.frame = None       # the checked frame being rendered
        self.got: dict = {}     # frame -> {"out": [...], "pick": {...}}
        self.batches = [0, 0]   # batches written, per half
        self.chain = None
        self.half = 0
        self._saved = {}

    def __enter__(self):
        acc, ad = self.accum, self.adaptive
        self._saved = {(acc, "write_sums"): acc.write_sums,
                       (acc, "write_samples"): acc.write_samples,
                       (ad, "pick_pixels"): ad.pick_pixels,
                       (ad, "random_pixels"): ad.random_pixels}
        write_sums, write_samples = acc.write_sums, acc.write_samples
        pick_pixels, random_pixels = ad.pick_pixels, ad.random_pixels

        def written(item):
            if self.frame is not None:
                g = self.got.setdefault(self.frame, {"out": [], "pick": {}})
                g["out"].append((self.half, self.batches[self.half], item))
            self.batches[self.half] += 1

        def sums(buf, color_sum, counts):
            written(("sums", color_sum, counts))
            return write_sums(buf, color_sum, counts)

        def samples(buf, px, py, color):
            written(("samples", px, py, color))
            return write_samples(buf, px, py, color)

        def pick(buf, batch, seed, bootstrap, spp_scale, x0, *args, **kw):
            self.half = int(x0 >= self.x_right)
            sweep = kw.get("sweep_pos")
            if self.frame is not None:
                g = self.got.setdefault(self.frame, {"out": [], "pick": {}})
                g["pick"][(self.half, self.batches[self.half])] = (
                    seed, buf.acc.clone(), buf.count.clone(), sweep)
            res = pick_pixels(buf, batch, seed, bootstrap, spp_scale, x0, *args, **kw)
            if self.chain is not None:
                self.chain.append((self.half, self.batches[self.half], sweep, res[3]))
            return res

        def uniform(batch, seed, x0, *args, **kw):
            self.half = int(x0 >= self.x_right)
            return random_pixels(batch, seed, x0, *args, **kw)

        acc.write_sums, acc.write_samples = sums, samples
        ad.pick_pixels, ad.random_pixels = pick, uniform
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self._saved.items():
            setattr(mod, name, fn)


def settings_of(cfg: dict, half: str, use_regen: bool):
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    st = dict(cfg["settings"], **cfg[half])
    st["render_type"] = RenderType(st["render_type"])
    return RenderSettings(use_regen=use_regen, **st)


def check_frames(run) -> set:
    """The window frames to check: one drawn from the seed in each range
    of ``check_frames``."""
    return {lo + harness.fold(run.seed, 0xC0 + i) % (hi - lo)
            for i, (lo, hi) in enumerate(run.traffic["check_frames"])}


def adaptive_past_bootstrap(cfg: dict, batches) -> bool:
    """Whether every adaptive half's next batch (``batches``: the
    half's batches so far) is past its bootstrap."""
    from portbench.reference import session_check as sc
    return all(not sc.in_bootstrap(dict(cfg["settings"], **cfg[key]), w, cfg["height"], b)
               for (_, w, key, _), b in zip(sc.half_layout(cfg), batches)
               if cfg[key]["adaptive"])


def run(run, control: bool = False) -> dict:
    """One run of the cell.  With ``control`` it also judges the control,
    the reference in bfloat16 put in the program's place, on the same
    frames (``out["control_checks"]``)."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import accum, adaptive
    from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    from wasm_pathtracer_tpu_torch.runtime.session import Session

    cfg, tf, dev = run.config, run.traffic, run.device
    modules = {"scene_kernels": sk, "probe_kernels": pk}
    wrappers = {w: getattr(modules[m], w) for m, ks in KERNELS.items() for w in ks}
    W, H = cfg["width"], cfg["height"]
    session_seed = harness.fold(run.seed, 0x5E55)
    left = settings_of(cfg, "left", tf["use_regen"])
    right = settings_of(cfg, "right", tf["use_regen"])
    for st in (left, right):
        if tf["frame_ticks"] // 2 != st.ray_batch_size:
            raise harness.Refused("a frame must trace one batch a half")
    sess = Session(W, H, cfg["scene_id"], left=left, right=right, seed=session_seed,
                   device=dev)
    halves = (sess.left, sess.right)

    def frame():
        with run.span("compute"):
            n = sess.compute(tf["frame_ticks"])
        with run.span("results"):
            img = sess.results()
        return n, img

    def photons_pending():
        return any(h.photon_grid is not None
                   and int(h.photon_grid.num_photons) < h.settings.total_photons
                   for h in halves)

    has_adaptive = cfg["left"]["adaptive"] or cfg["right"]["adaptive"]
    fixed = check_frames(run)
    checked = set(fixed)
    drawn, eligible = None, 0   # the frame past the bootstrap checked, of how many
    before, after, frames_u8 = {}, {}, {}
    frame_ms, compute_s, readout_s = [], [], []
    paths, failed = 0, 0
    with Capture(accum, adaptive, sess.right.x0) as cap:
        n_setup = 0
        while photons_pending() or n_setup == 0:
            if n_setup == MAX_PHOTON_FRAMES:
                raise RuntimeError(f"the photons are not done after {n_setup} frames")
            frame()
            n_setup += 1
        for _ in range(tf["warm_frames"]):
            frame()
        for h in halves:
            if h.settings.adaptive:
                adaptive.pick_pixels(sess.buffer, h.settings.ray_batch_size, 1, False,
                                     h.settings.adaptive_spp_scale, h.x0, h.y0, h.width,
                                     h.height)
        if dev != "cpu":
            torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - run.t0

        l0, hits0, b0 = harness.launches(wrappers), sess.num_bvh_hits, sum(cap.batches)
        cap.chain = []
        t_start = time.perf_counter()
        w = 0
        while time.perf_counter() - t_start < run.seconds:
            if has_adaptive and adaptive_past_bootstrap(cfg, cap.batches):
                # one frame past the bootstrap, uniform over those rendered
                eligible += 1
                if harness.fold(run.seed, 0xAD000 + eligible) % eligible == 0:
                    if drawn is not None and drawn not in fixed:
                        checked.discard(drawn)
                        for d in (before, after, frames_u8, cap.got):
                            d.pop(drawn, None)
                    drawn = w
                    checked.add(w)
            cap.frame = w if w in checked else None
            if cap.frame is not None:
                before[w] = (sess.buffer.acc.clone(), sess.buffer.count.clone())
            t_a = time.perf_counter()
            n = sess.compute(tf["frame_ticks"])
            t_b = time.perf_counter()
            if cap.frame is not None:
                after[w] = (sess.buffer.acc.clone(), sess.buffer.count.clone())
            img = sess.results()
            t_c = time.perf_counter()
            if cap.frame is not None:
                frames_u8[w] = img
            frame_ms.append(1e3 * (t_c - t_a))
            compute_s.append(t_b - t_a)
            readout_s.append(t_c - t_b)
            paths += n
            failed += n < tf["frame_ticks"]
            w += 1
        window_s = time.perf_counter() - t_start
        cap.frame = None
        chain = [(h, b, 0 if pos is None else int(pos), int(new))
                 for h, b, pos, new in cap.chain]
        cap.chain = None
        batches = sum(cap.batches) - b0
    l1 = harness.launches(wrappers)
    device = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if dev != "cpu":
        device = harness.card()
        device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())

    e2e = {"setup_s": {"value": setup_s, "unit": "s"},
           "paths_per_s": {"value": paths / window_s, "unit": "paths/s"}}
    if any(m["name"] == "frame_ms_p90" for m in run.end_to_end) and len(frame_ms) >= 2:
        e2e["frame_ms_p90"] = {"value": harness.p90(frame_ms), "unit": "ms"}
    e2e = {m["name"]: e2e[m["name"]] for m in run.end_to_end if m["name"] in e2e}

    obs = harness.Observed(
        config=cfg,
        counters={"launches": {k: l1[k] - l0[k] for k in l1}, "batches": batches,
                  "paths": paths, "frames": w, "bvh_hits": sess.num_bvh_hits - hits0},
        host={"window_s": window_s, "compute_s": compute_s, "readout_s": readout_s},
        profile=None)
    out = {"end_to_end": e2e, "attempted": w, "failed": int(failed), "device": device}
    if run.trace:
        stride, most = tf["roofline_sample"]
        samples = [(modules[m], {k: (stride, most) for k in ks}) for m, ks in KERNELS.items()]
        kernels = {k: v for ks in KERNELS.values() for k, v in ks.items()}
        obs.profile = harness.profile_slice(
            lambda: [frame() for _ in range(tf["profile_frames"])], wrappers, kernels,
            samples, tf["profile_frames"])
        out["per_layer"] = harness.read_per_layer(run, obs)
        out["breakdown"] = harness.breakdown(obs.profile)
        out["device"]["busy_s"] = obs.profile.busy_s()
        out["device"]["window_s"] = obs.profile.wall_s
    prog_bins = [None if h.photon_grid is None else h.photon_grid.bins.clone() for h in halves]
    del sess, halves, obs
    if dev != "cpu":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if has_adaptive and drawn is None:
        checked.add(-1)     # due past the bootstrap, never rendered: missing
    out["checks"] = judge(run, session_seed, cap.got, before, after, frames_u8, prog_bins,
                          checked, chain)
    out["reference_s"] = time.perf_counter() - t_ref
    out["note"] = f"checked frames {sorted(checked)}"
    if control:
        from portbench.reference import session_check as sc
        ctrl = sc.SessionReference(cfg, session_seed, dev, "bfloat16")

        def lower(half, b, px, py, idx):
            if tf["use_regen"]:
                return ctrl.queue_radiance(half, b, py * W + px, idx)
            return ctrl.pixel_radiance(half, b, px[idx], py[idx])

        bins = [None if h.grid is None else h.grid.bins for h in ctrl.halves]
        out["control_checks"] = judge(run, session_seed, cap.got, before, after, frames_u8,
                                      bins, checked, chain, program=lower)
    return out


def judge(run, session_seed, got, before, after, frames_u8, prog_bins, checked, chain,
          precision: str = "float32", program=None) -> list:
    """The numbers that decide ``correct``, each beside its limit.

    ``got`` holds, per checked frame, each batch's output keyed by its
    half and the half's batch index, and the state each adaptive pick
    read; ``chain`` every adaptive pick of the window as (half, batch
    index, sweep position read, position returned).  A checked frame
    that was never rendered is missing.  ``program`` replaces the program's radiance by another
    source's (the control: the reference in a lower precision), as a
    function ``(ref, half, batch, px, py, qidx) -> radiance``."""
    import torch
    from portbench.reference import session_check as sc
    lim = run.checks["limits"]
    rtol, atol = run.checks["radiance_rtol"], run.checks["radiance_atol"]
    ref = sc.SessionReference(run.config, session_seed, run.device, precision)
    W, H = run.config["width"], run.config["height"]
    HW = W * H
    counts_bad = accum_bad = readout_bad = missing = 0
    rad_bad = rad_n = 0
    due = sorted(f for f in checked if f in after)
    missing += len(checked) - len(due)
    steps = {(h, b): (pos, new) for h, b, pos, new in chain}
    for half in (0, 1):
        counts_bad += sc.sweep_gap(ref, half, [(b, pos, new) for h, b, pos, new in chain
                                               if h == half])
    for f in due:
        g = got.get(f, {"out": [], "pick": {}})
        if sorted(h for h, _, _ in g["out"]) != [0, 1]:
            missing += 1
            continue
        sums = []
        for half, b, item in sorted(g["out"], key=lambda x: x[0]):
            h = ref.halves[half]
            state = None
            if h.settings["adaptive"]:
                if (half, b) not in g["pick"]:
                    missing += 1
                    continue
                seed, acc, count, sweep = g["pick"][(half, b)]
                sweep = 0 if sweep is None else int(sweep)
                counts_bad += int(seed != ref.round_seed(half, b))
                if ref.bootstrap(half, b):
                    # the start: a bootstrap batch's sweep follows from the batch count
                    counts_bad += int(sweep != ref.sweep_start(half, b))
                state = (acc, count, sweep)
            px, py, new = ref.picks(half, b, state)
            if new is not None:
                # the checked pick's own step of the sweep, exactly
                counts_bad += int(steps.get((half, b)) != (state[2], new))
            pix = py * W + px
            gen = torch.Generator().manual_seed(harness.fold(run.seed, 0x5A00 + 2 * f + half))
            n = run.checks["check_paths"]
            if item[0] == "sums":
                _, p_sum, p_cnt = item
                sums.append((p_sum, p_cnt))
                r_cnt = torch.bincount(pix, minlength=HW)
                counts_bad += int((r_cnt != p_cnt.to(r_cnt.dtype)).sum())
                qidx, px_set = sc.sample_queue(pix, n, gen)
                col = ref.queue_radiance(half, b, pix, qidx)
                r_sum = torch.zeros((HW, 3), dtype=col.dtype, device=col.device)
                r_sum.index_add_(0, pix[qidx], col)
                if program is not None:
                    c2 = program(half, b, px, py, qidx)
                    p_pix = torch.zeros_like(r_sum).index_add_(0, pix[qidx], c2)[px_set]
                else:
                    p_pix = p_sum[px_set].to(col.dtype)
                bad = sc.mismatch(p_pix, r_sum[px_set], rtol, atol)
            else:
                _, p_px, p_py, p_col = item
                flat = (p_py * W + p_px).long()
                sums.append((torch.zeros((HW, 3), dtype=p_col.dtype, device=p_col.device)
                             .index_add_(0, flat, p_col), torch.bincount(flat, minlength=HW)))
                counts_bad += int(((p_px != px) | (p_py != py)).sum())
                q = torch.randperm(px.shape[0], generator=gen)[:n].to(px.device)
                col = ref.pixel_radiance(half, b, px[q], py[q])
                p = program(half, b, px, py, q) if program is not None else p_col[q]
                bad = sc.mismatch(p.to(col.dtype), col, rtol, atol)
            rad_bad += int(bad.sum())
            rad_n += int(bad.numel())
        if program is None:
            accum_bad += sc.accumulation_gap(before[f], sums, after[f])
            readout_bad += sc.readout_gap(after[f], frames_u8[f])
    checks = [
        {"name": "missing_answers", "value": missing, "limit": 0},
        {"name": "pick_mismatch", "value": counts_bad, "limit": lim["pick_mismatch"]},
        {"name": "radiance_mismatch_pct", "value": 100.0 * rad_bad / max(rad_n, 1),
         "limit": lim["radiance_mismatch_pct"]},
    ]
    if program is None:
        checks += [{"name": "accum_mismatch_px", "value": accum_bad,
                    "limit": lim["accum_mismatch_px"]},
                   {"name": "readout_mismatch_bytes", "value": readout_bad,
                    "limit": lim["readout_mismatch_bytes"]}]
    for half, pb in enumerate(prog_bins):
        h = ref.halves[half]
        if h.grid is not None and pb is not None:
            checks.append({"name": f"photon_bins_gap.{('left', 'right')[half]}",
                           "value": sc.bins_gap(pb.to(h.grid.bins.device), h.grid.bins),
                           "limit": lim["photon_bins_gap"]})
    return checks
