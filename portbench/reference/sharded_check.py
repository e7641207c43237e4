"""The reference of a session sharded over ranks (``museum_sharded4``):
this configuration's copy of the session cells' check
(``session_check.py``, used unchanged).

Semantics.  A session over n ranks renders what one rank renders with a
batch n times as large (``ray_batch_size`` is each rank's share): every
rank draws the same picks from its copy of the buffer, traces the
contiguous shard ``[r * S/n, (r + 1) * S/n)`` of the batch's queue of S
picks (padded to a multiple of n with an id past the frame), each path
keyed by its global queue index, and adds the sum over the ranks of the
shards' sums to its buffer.  Photons are emitted alike on every rank.
So the reference is ``SessionReference`` of the configuration with the
whole batch, and two things only a sharded run has are checked exactly:

- ``shard_count_mismatch_px``: pixels where a rank's own sample counts
  (before the all-reduce) differ from the picks of its contiguous shard,
  so that the shards' counts add up to the picks;
- ``rank_buffer_mismatch_bytes``: bytes of every rank's accumulation
  buffer (sums and counts) that differ from rank 0's, after the window.

Rank 0's buffer is read for the adaptive picks, and the queue entries
whose radiance is compared are drawn from every rank's shard, at least
one a rank, under their global keys.
"""

from __future__ import annotations

import torch

from portbench import harness
from portbench.reference import session_check as sc


def whole_batch_config(config: dict) -> dict:
    """``config`` with one rank's ``ray_batch_size`` made the whole
    batch of its ``workers``."""
    st = dict(config["settings"])
    st["ray_batch_size"] = st["ray_batch_size"] * int(config["workers"])
    return dict(config, settings=st)


def reference(config: dict, session_seed: int, device, precision: str = "float32"):
    return sc.SessionReference(whole_batch_config(config), session_seed, device, precision)


def shard_bounds(n_queue: int, ranks: int) -> list:
    """[(start, end)] of each rank's contiguous shard of a queue of
    ``n_queue`` entries (the program pads the queue to a multiple of the
    ranks; the pad lies past ``n_queue``)."""
    shard = -(-max(n_queue, 1) // ranks)
    return [(min(r * shard, n_queue), min((r + 1) * shard, n_queue)) for r in range(ranks)]


def sample_shards(pix, n: int, ranks: int, gen: torch.Generator):
    """(queue indices, pixel ids) of every path whose pixel is one of
    those of ``n // ranks`` (at least 1) queue entries drawn with ``gen``
    from each rank's shard."""
    per = max(n // ranks, 1)
    q = torch.cat([lo + torch.randperm(hi - lo, generator=gen)[:per]
                   for lo, hi in shard_bounds(pix.shape[0], ranks) if hi > lo])
    px_set = torch.unique(pix[q.to(pix.device)])
    qidx = torch.nonzero(torch.isin(pix, px_set)).squeeze(1)
    return qidx, px_set


def shard_count_gap(pix, counts: list, hw: int) -> int:
    """Pixels where some rank's counts ``counts[r]`` (hw,) differ from
    the picks ``pix`` of its contiguous shard."""
    bad = torch.zeros(hw, dtype=torch.bool, device=pix.device)
    for (lo, hi), c in zip(shard_bounds(pix.shape[0], len(counts)), counts):
        want = torch.bincount(pix[lo:hi], minlength=hw)
        bad |= c.to(device=pix.device, dtype=want.dtype) != want
    return int(bad.sum())


def buffer_gap(rank_buffers: list) -> int:
    """Bytes of each rank's (acc, count) that differ from rank 0's."""
    def as_bytes(t):
        return t.contiguous().view(torch.uint8).reshape(-1)

    first = [as_bytes(t) for t in rank_buffers[0]]
    return sum(int((as_bytes(t) != f).sum())
               for buf in rank_buffers[1:] for t, f in zip(buf, first))


def judge(run, session_seed, got, before, after, frames_u8, prog_bins, checked, chain,
          shard_counts, rank_buffers, ranks: int, precision: str = "float32",
          program=None) -> list:
    """The numbers that decide ``correct``, each beside its limit.

    ``got``, ``before``, ``after``, ``frames_u8``, ``prog_bins``,
    ``checked`` and ``chain`` are rank 0's, as the session cells'
    ``judge`` takes them; ``shard_counts`` maps (frame, half, batch index)
    to every rank's own counts of that batch; ``rank_buffers`` holds every
    rank's (acc, count) after the window.  ``program`` replaces the
    program's radiance by another source's (the control), which leaves
    out the numbers that read the program's own state."""
    lim = run.checks["limits"]
    rtol, atol = run.checks["radiance_rtol"], run.checks["radiance_atol"]
    ref = reference(run.config, session_seed, run.device, precision)
    W, H = run.config["width"], run.config["height"]
    HW = W * H
    counts_bad = accum_bad = readout_bad = missing = shard_bad = 0
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
                    counts_bad += int(sweep != ref.sweep_start(half, b))
                state = (acc, count, sweep)
            px, py, new = ref.picks(half, b, state)
            if new is not None:
                counts_bad += int(steps.get((half, b)) != (state[2], new))
            pix = py * W + px
            _, p_sum, p_cnt = item
            sums.append((p_sum, p_cnt))
            r_cnt = torch.bincount(pix, minlength=HW)
            counts_bad += int((r_cnt != p_cnt.to(r_cnt.dtype)).sum())
            if program is None:
                if (f, half, b) in shard_counts:
                    shard_bad += shard_count_gap(pix, shard_counts[(f, half, b)], HW)
                else:
                    missing += 1
            gen = torch.Generator().manual_seed(harness.fold(run.seed, 0x5A00 + 2 * f + half))
            qidx, px_set = sample_shards(pix, run.checks["check_paths"], ranks, gen)
            col = ref.queue_radiance(half, b, pix, qidx)
            r_sum = torch.zeros((HW, 3), dtype=col.dtype, device=col.device)
            r_sum.index_add_(0, pix[qidx], col)
            if program is not None:
                c2 = program(half, b, px, py, qidx)
                p_pix = torch.zeros_like(r_sum).index_add_(0, pix[qidx], c2)[px_set]
            else:
                p_pix = p_sum[px_set].to(col.dtype)
            bad = sc.mismatch(p_pix, r_sum[px_set], rtol, atol)
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
                    "limit": lim["readout_mismatch_bytes"]},
                   {"name": "shard_count_mismatch_px", "value": shard_bad,
                    "limit": lim["shard_count_mismatch_px"]},
                   {"name": "rank_buffer_mismatch_bytes", "value": buffer_gap(rank_buffers),
                    "limit": lim["rank_buffer_mismatch_bytes"]}]
    for half, pb in enumerate(prog_bins):
        h = ref.halves[half]
        if h.grid is not None and pb is not None:
            checks.append({"name": f"photon_bins_gap.{('left', 'right')[half]}",
                           "value": sc.bins_gap(pb.to(h.grid.bins.device), h.grid.bins),
                           "limit": lim["photon_bins_gap"]})
    return checks
