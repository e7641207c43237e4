"""The span arithmetic of ``portbench/spans.py`` and the readers of the
port's own spans: exact on a synthetic profiled slice, silent (None) on
a slice of a program that records no span, and reported by a traced run
of every cell that lists them."""

from __future__ import annotations

import pytest

from conftest import PORTBENCH, run_cut, spec

MS = 1_000_000      # ns


def span_metrics(cell=None) -> list:
    return [m["name"] for m in spec()["per_layer"] if m["source"] == "program_span"
            and (cell is None or cell in m["workloads"])]


def slice_of(host, device, units=1):
    from portbench import harness
    ns = [(n, s * MS, e * MS) for n, s, e in host]
    return harness.Profile(device_ops=[(n, s * MS, e * MS) for n, s, e in device],
                           host_events=sorted(ns, key=lambda x: x[1]), wall_s=0.14,
                           launched={}, calls={}, units=units)


# two queue iterations of one batch and a readout, in ms; the device is
# busy over [15, 45] and [95, 125]
HOST = [("portbench/compute", 0, 100), ("wpt/session.batch", 0, 100),
        ("wpt/queue", 0, 100),
        ("wpt/sync.queue_alive", 0, 5), ("wpt/queue.iter", 10, 50),
        ("wpt/trace", 10, 20), ("aten::add", 12, 14), ("wpt/shade", 20, 40),
        ("wpt/regen", 40, 48),
        ("wpt/sync.queue_alive", 50, 55), ("wpt/queue.iter", 60, 90),
        ("wpt/trace", 60, 70), ("wpt/shade", 70, 80), ("wpt/regen", 80, 88),
        ("wpt/sync.queue_alive", 90, 95),
        ("wpt/session.results", 130, 140), ("wpt/sync.readout", 132, 138)]
DEVICE = [("k", 15, 30), ("k", 25, 45), ("k", 95, 125)]


def test_nesting_self_time_and_idle_inside_spans():
    from portbench import spans
    p = slice_of(HOST, DEVICE)
    sp = spans.spans_of(p)
    names = [(s.name, sp[s.parent].name if s.parent >= 0 else None) for s in sp]
    assert names[:4] == [("session.batch", None), ("queue", "session.batch"),
                         ("sync.queue_alive", "queue"), ("queue.iter", "queue")]
    assert ("trace", "queue.iter") in names and ("sync.readout", "session.results") in names
    self_ms = dict(zip((s.name for s in sp), spans.self_ms(sp)))  # the last of each name
    assert self_ms["queue"] == 15 and self_ms["queue.iter"] == 2
    assert self_ms["session.batch"] == 0 and self_ms["session.results"] == 4
    assert spans.busy_intervals(p) == ([15 * MS, 95 * MS], [45 * MS, 125 * MS])
    assert spans.idle_ms_inside(p, spans.select(sp, "queue")) == 65
    assert spans.total_ms(spans.select(sp, "trace", inside="queue.iter")) == 20
    assert spans.select(sp, "trace", inside="session.results") == []
    by = spans.idle_by_span(p)
    assert by["idle_s"] == pytest.approx(0.080)
    assert by["outermost"] == pytest.approx({"session.batch": 0.065, "session.results": 0.010,
                                             "none": 0.005})
    assert by["innermost"] == pytest.approx({
        "sync.queue_alive": 0.015, "trace": 0.015, "regen": 0.011, "queue": 0.010,
        "shade": 0.010, "queue.iter": 0.004, "session.results": 0.004,
        "sync.readout": 0.006, "session.batch": 0.0, "none": 0.005})
    assert spans.syncs_by_site(p) == {"sync.queue_alive": 3, "sync.readout": 1}
    copies = slice_of([], [("Memcpy DtoH (Device -> Pageable)", 1, 2), ("k", 2, 3)], units=2)
    assert spans.copies_to_host(copies) == 0.5


def test_readers_on_a_synthetic_slice():
    from portbench import harness
    obs = harness.Observed(config={}, counters={}, host={}, profile=slice_of(HOST, DEVICE))
    got = {n: harness.load_module(PORTBENCH / "metrics" / f"{n}.py").read(obs)
           for n in span_metrics()}
    none = {"session.pick_ms_per_batch", "train.forward_ms", "train.backward_ms"}
    assert all(got[n] is None for n in none)
    assert {n: v for n, v in got.items() if n not in none} == pytest.approx({
        "queue.iters_per_batch": 2.0, "queue.iter_host_ms": 35.0,
        "queue.trace_ms_per_iter": 10.0, "queue.shade_ms_per_iter": 15.0,
        "queue.regen_ms_per_iter": 8.0, "queue.idle_ms_per_iter": 32.5,
        "host_syncs_per_frame": 4.0, "host_sync_ms_per_frame": 21.0,
        "readout.span_ms": 10.0})


def test_readers_are_silent_without_the_programs_spans():
    """An older program records no ``wpt/`` span: every reader returns
    None and raises nothing."""
    from portbench import harness
    host = [h for h in HOST if not h[0].startswith("wpt/")]
    for profile in (slice_of(host, DEVICE), None):
        obs = harness.Observed(config={}, counters={}, host={}, profile=profile)
        for n in span_metrics():
            assert harness.load_module(PORTBENCH / "metrics" / f"{n}.py").read(obs) is None, n


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_traced_run_reports_the_span_metrics(cut, cell):
    line, _ = run_cut(cut, cell, trace=True)
    assert line["correct"] is True, line["check"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    # the CPU has no device operations to be idle between
    want = set(span_metrics(cell)) - {"queue.idle_ms_per_iter"}
    assert want and want <= set(m)
    if "queue.iter_host_ms" in want:
        phases = sum(m[f"queue.{p}_ms_per_iter"] for p in ("trace", "shade", "regen"))
        assert 0 < phases <= m["queue.iter_host_ms"]
        assert m["queue.iters_per_batch"] >= 1
    if "host_syncs_per_frame" in want:
        assert m["host_syncs_per_frame"] == int(m["host_syncs_per_frame"]) >= 4
