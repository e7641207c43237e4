"""The port's own host spans in a profiled slice, for the per-layer readers.

The port records ``wpt/<name>`` spans at its layer boundaries
(``wasm_pathtracer_tpu_torch/utils/spans.py``) whenever a profiler runs,
so they sit among ``Profile.host_events``, on the clock of the device
operations.  Here: their nesting by interval on the host clock, self
time, and the device's idle time inside a span.  A program that records
no such span (an older commit) gives empty lists, and the readers then
return None.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

makes one traced run of a cell on the card and prints, before its result
line, one JSON line with the profiled slice's device-idle seconds by
innermost and by outermost span (``"none"`` where no span of the
program ran), each span name's host self seconds, the host reads a
frame or step by site (``sync.<site>``) and the device-to-host copies a
frame or step (every read of a device value makes one, so a program
without spans can be counted too).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

PREFIX = "wpt/"
NONE = "none"


@dataclasses.dataclass
class Span:
    """One span of the program: its name without the prefix, its
    interval in ns, and the index of the innermost span whose interval
    holds it (-1 for none)."""

    name: str
    start: int
    end: int
    parent: int


def spans_of(p) -> list:
    """The program's spans of a profiled slice, in start order (an
    enclosing span before the spans it holds), nested by interval."""
    if p is None:
        return []
    raw = sorted(((n[len(PREFIX):], s, e) for n, s, e in p.host_events
                  if n.startswith(PREFIX)), key=lambda x: (x[1], -x[2]))
    out, stack = [], []
    for name, s, e in raw:
        while stack and out[stack[-1]].end < e:
            stack.pop()
        out.append(Span(name, s, e, stack[-1] if stack else -1))
        stack.append(len(out) - 1)
    return out


def ancestors(sp: list, i: int):
    """Names of the spans holding span ``i``, innermost first."""
    j = sp[i].parent
    while j >= 0:
        yield sp[j].name
        j = sp[j].parent


def select(sp: list, name: str, inside: str | None = None) -> list:
    """Spans named ``name`` held by no span of the same name (so a
    duration is counted once), and, with ``inside``, held by a span
    named ``inside``.  A name ending in ``.`` matches every name it
    starts."""
    def named(n):
        return n.startswith(name) if name.endswith(".") else n == name
    out = []
    for i, s in enumerate(sp):
        if not named(s.name):
            continue
        up = list(ancestors(sp, i))
        if any(named(a) for a in up) or (inside is not None and inside not in up):
            continue
        out.append(s)
    return out


def total_ms(spans: list) -> float:
    return sum(s.end - s.start for s in spans) / 1e6


def self_intervals(sp: list) -> list:
    """For each span, the parts of its interval that none of the spans
    it holds covers: ``[(start, end), ...]`` per span."""
    children: list = [[] for _ in sp]
    for i, s in enumerate(sp):
        if s.parent >= 0:
            children[s.parent].append(i)
    out = []
    for i, s in enumerate(sp):
        free, t = [], s.start
        for c in children[i]:
            a, b = max(sp[c].start, t), min(sp[c].end, s.end)
            if a > t:
                free.append((t, a))
            t = max(t, b)
        if s.end > t:
            free.append((t, s.end))
        out.append(free)
    return out


def self_ms(sp: list) -> list:
    """Each span's self time: its duration less what its child spans
    cover, in ms."""
    return [sum(b - a for a, b in f) / 1e6 for f in self_intervals(sp)]


def busy_intervals(p) -> tuple:
    """The union of the slice's device operations as disjoint intervals
    in ns, in order: ``(starts, ends)``."""
    starts: list = []
    ends: list = []
    for _, s, e in sorted(p.device_ops, key=lambda x: x[1]):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return starts, ends


def idle_ns(busy: tuple, intervals) -> int:
    """ns of ``intervals`` (disjoint) in which no device operation ran;
    ``busy`` from :func:`busy_intervals`."""
    starts, ends = busy
    idle = 0
    for a, b in intervals:
        j = bisect.bisect_right(ends, a)
        covered = 0
        while j < len(starts) and starts[j] < b:
            covered += min(b, ends[j]) - max(a, starts[j])
            j += 1
        idle += (b - a) - covered
    return idle


def idle_ms_inside(p, spans: list):
    """Device-idle ms inside ``spans`` (none of them inside another);
    None for a slice without device operations."""
    if p is None or not p.device_ops:
        return None
    return idle_ns(busy_intervals(p), [(s.start, s.end) for s in spans]) / 1e6


def idle_by_span(p) -> dict:
    """The slice's device-idle seconds by the innermost and by the
    outermost span of the program running at the time, ``"none"`` where
    none ran; the slice runs from its first host event or device
    operation to its last."""
    sp = spans_of(p)
    busy = busy_intervals(p)
    events = p.host_events + p.device_ops
    lo, hi = min(s for _, s, _ in events), max(e for _, _, e in events)
    whole = idle_ns(busy, [(lo, hi)])
    inner: dict = {}
    for s, free in zip(sp, self_intervals(sp)):
        inner[s.name] = inner.get(s.name, 0) + idle_ns(busy, free)
    outer: dict = {}
    for s in sp:
        if s.parent < 0:
            outer[s.name] = outer.get(s.name, 0) + idle_ns(busy, [(s.start, s.end)])
    inner[NONE] = outer[NONE] = whole - sum(outer.values())
    return {k: {n: v / 1e9 for n, v in sorted(d.items(), key=lambda kv: -kv[1])}
            for k, d in (("innermost", inner), ("outermost", outer))} | {"idle_s": whole / 1e9}


def host_self_s(p) -> dict:
    """Host seconds of the slice by span name, each span's self time."""
    sp = spans_of(p)
    out: dict = {}
    for s, ms in zip(sp, self_ms(sp)):
        out[s.name] = out.get(s.name, 0.0) + ms / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def syncs_by_site(p) -> dict:
    """Host reads of the slice by site, per frame or step."""
    out: dict = {}
    for s in select(spans_of(p), "sync."):
        out[s.name] = out.get(s.name, 0) + 1
    return {k: v / p.units for k, v in sorted(out.items())}


def copies_to_host(p) -> float:
    """Device-to-host copies of the slice a frame or step."""
    return sum(1 for n, _, _ in p.device_ops if "DtoH" in n) / p.units


def main(argv=None) -> int:
    a = argparse.ArgumentParser(prog="python3 -m portbench.spans")
    a.add_argument("--workload", required=True)
    a.add_argument("--seed", type=int, required=True)
    a.add_argument("--seconds", type=float, required=True)
    args = a.parse_args(sys.argv[1:] if argv is None else argv)
    from portbench import harness
    from portbench import run as prun
    kept = []
    profile_slice = harness.profile_slice

    def keep(*args, **kw):
        kept.append(profile_slice(*args, **kw))
        return kept[-1]
    harness.profile_slice = keep
    run = harness.make_run(harness.load_json(harness.SPEC), args.workload, args.seed,
                           args.seconds, True, "cuda", T0)
    line = prun.run_cell(run)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "idle_by_span": idle_by_span(kept[-1]),
                      "host_self_s": host_self_s(kept[-1]),
                      "syncs_per_unit": syncs_by_site(kept[-1]),
                      "dtoh_per_unit": copies_to_host(kept[-1])}))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
