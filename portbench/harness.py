"""The benchmark's machinery, shared by every cell.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration, ``configs/<config>.json``, and a traffic mix,
``traffic/<traffic>.json``, whose ``kind`` names the generator
``traffic/<kind>.py`` that drives the port.  ``cells/<cell>.json`` holds
what the cell's correctness check samples and the limit of each number
it compares.  Each per-layer metric is read by ``metrics/<metric>.py``
from what the run observed (:class:`Observed`).  A new configuration,
traffic mix, cell or per-layer metric is a new file found by its name;
no file here changes.

The generator builds the program's state (set-up), measures for
``--seconds`` and returns the end-to-end numbers, what it observed for
the per-layer readers and the answers to check; the reference under
``reference/`` then judges the answers, after the device's peak memory
was read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack, contextmanager, nullcontext

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
SPEC = REPO / "BENCHMARK.json"
# modules that may not be loaded in the process that prints a result,
# compared by their top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "wasm_pathtracer_tpu")
M32 = 0xFFFFFFFF
# the benchmark's own host spans, told apart from the program's operations
SPAN_PREFIX = "portbench/"


class Refused(RuntimeError):
    """The run cannot give a result (no card, a name not found)."""


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """The Python file ``path`` as a module (its name may hold dots)."""
    name = "portbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise Refused(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fold(seed: int, k: int) -> int:
    """A 32-bit value drawn from the run's seed (any size) and ``k``."""
    from portbench.reference.rng import _pcg3d
    x, y, _ = _pcg3d(seed & M32, (seed >> 32) & M32, k & M32)
    return x ^ y


@dataclasses.dataclass
class Run:
    """One run of one cell."""

    name: str
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list
    per_layer: list
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    root: pathlib.Path = HERE

    def span(self, name: str):
        """A host span around a call into a layer, recorded by the
        profiler in a traced run."""
        if not self.trace:
            return nullcontext()
        import torch
        return torch.profiler.record_function(SPAN_PREFIX + name)


def make_run(spec: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str, t0: float, root: pathlib.Path = HERE) -> Run:
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in the benchmark ({sorted(cells)})")
    cell = cells[workload]

    def listed(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if listed(m)]
    per_layer = [m for m in spec["per_layer"] if listed(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in per_layer if m["moves"] in reported]
    return Run(name=workload,
               config=load_json(root / "configs" / f"{cell['config']}.json"),
               traffic=load_json(root / "traffic" / f"{cell['traffic']}.json"),
               checks=load_json(root / "cells" / f"{workload}.json"),
               end_to_end=e2e, per_layer=per_layer, seed=int(seed), seconds=float(seconds),
               trace=bool(trace), device=device, t0=t0, root=root)


# ---------------------------------------------------------------------------
# What a run observed, for the per-layer readers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Profile:
    """A profiled slice: device operations ``(name, start_ns, end_ns)``
    in start order, host events ``(name, start_ns, end_ns)``, the slice's
    wall seconds by the host clock, the wrappers' launches in the slice,
    and the arguments of the sampled calls ``{wrapper: [(call index,
    args)]}``."""

    device_ops: list
    host_events: list
    wall_s: float
    launched: dict
    calls: dict
    units: int

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union
        of the operations' intervals)."""
        busy, end = 0.0, -math.inf
        for _, s, e in self.device_ops:
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy / 1e9

    def times_of(self, kernel: str) -> list:
        """Device seconds of each launch of the CUDA kernel ``kernel``,
        in launch order."""
        return [(e - s) / 1e9 for n, s, e in self.device_ops if kernel in n]


@dataclasses.dataclass
class Observed:
    """Everything a per-layer reader may read.  ``counters`` and ``host``
    come from the measured window; ``profile`` from the profiled slice
    after it (None outside a traced run)."""

    config: dict
    counters: dict
    host: dict
    profile: Profile | None


def read_per_layer(run: Run, obs: Observed) -> dict:
    """{metric: {"value", "unit"}} of the readers that found something."""
    out = {}
    for m in run.per_layer:
        reader = load_module(run.root / "metrics" / f"{m['name']}.py")
        value = reader.read(obs)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


@contextmanager
def recorded_calls(module, sample: dict):
    """Within the block, each wrapper ``module.<name>`` of ``sample``
    ({name: (stride, most)}) records the arguments of every ``stride``-th
    call, at most ``most`` of them, as ``(call index, args)`` into the
    dict the block gets.  The wrapper counts its launches on whatever its
    module name holds, so the counts made in the block are carried back
    when it is put back."""
    saved = {name: getattr(module, name) for name in sample}
    got = {name: [] for name in sample}

    def spy(name, fn):
        stride, most = sample[name]
        calls = [0]

        def wrapped(*args):
            k = calls[0]
            if k % stride == 0 and len(got[name]) < most:
                got[name].append((k, args))
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


def launches(wrappers: dict) -> dict:
    return {name: fn.launches for name, fn in wrappers.items()}


def profile_slice(fn, wrappers: dict, kernels: dict, module_samples: list, units: int,
                  attempts: int = 3) -> Profile:
    """Profile ``fn()`` (host and device).  ``wrappers`` maps a wrapper's
    name to the wrapper, ``kernels`` a wrapper's name to the name of the
    CUDA kernel it launches: the trace must hold each kernel as often as
    its wrappers counted launches, else it lost operations and is taken
    again (``chip_smoke.py::busy_share``'s rule), ``attempts`` times at
    most.  ``module_samples`` lists ``(module, {wrapper: (stride,
    most)})`` whose calls are recorded (:func:`recorded_calls`).
    ``units`` is the number of frames or steps ``fn`` runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    for attempt in range(attempts):
        sync()
        before = launches(wrappers)
        with ExitStack() as stack:
            recs = [stack.enter_context(recorded_calls(m, s)) for m, s in module_samples]
            prof = stack.enter_context(profile(activities=activities))
            t0 = time.perf_counter()
            fn()
            sync()
            wall = time.perf_counter() - t0
        after = launches(wrappers)
        launched = {k: after[k] - before[k] for k in wrappers}
        dev, host = trace_events(prof)
        dev.sort(key=lambda x: x[1])
        host.sort(key=lambda x: x[1])
        want = {k: 0 for k in kernels.values()}
        for w, k in kernels.items():
            want[k] += launched[w]
        traced = {k: sum(1 for n, _, _ in dev if k in n) for k in want}
        if traced == want:
            calls = {k: v for r in recs for k, v in r.items()}
            return Profile(dev, host, wall, launched, calls, units)
        print(f"trace {attempt + 1} thrown away: it holds {traced}, the wrappers "
              f"launched {want}", file=sys.stderr)
    raise RuntimeError(f"{attempts} traces in a row lost device operations")


def trace_events(prof):
    """(device operations, host events) of a profile, each a list of
    ``(name, start_ns, end_ns)``; the benchmark's own span annotations
    on the device timeline are left out of the device operations."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    # the raw events: far cheaper than building the profiler's event tree
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        item = (name, start, start + e.duration_ns())
        if e.device_type() != cuda:
            host.append(item)
        elif not name.startswith(SPAN_PREFIX):
            dev.append(item)
    return dev, host


def breakdown(p: Profile) -> dict:
    """The ten device operations that took most time, and the ten kinds
    of idle gap that took most, each named by the host span and the
    innermost host operation running at the gap's middle."""
    import bisect
    by_op: dict = {}
    for n, s, e in p.device_ops:
        by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e9
    spans = [h for h in p.host_events if h[0].startswith(SPAN_PREFIX)]
    ops = [h for h in p.host_events if not h[0].startswith(SPAN_PREFIX)]
    starts = [h[1] for h in ops]
    gaps: dict = {}
    end = None
    for n, s, e in p.device_ops:
        if end is not None and s > end:
            mid = (s + end) // 2
            span = next((h[0] for h in reversed(spans) if h[1] <= mid <= h[2]), "no span")
            i = bisect.bisect_right(starts, mid)
            op = "python"
            for j in range(i - 1, max(i - 256, -1), -1):
                if ops[j][2] >= mid:
                    op = ops[j][0]
                    break
            key = f"{span}/{op}"
            gaps[key] = gaps.get(key, 0.0) + (s - end) / 1e9
        end = e if end is None else max(end, e)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

def p90(values) -> float:
    """90th percentile (``statistics.quantiles``, inclusive method)."""
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def jax_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card() -> dict:
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                "--format=csv,noheader,nounits", "-i", "0"],
                               capture_output=True, text=True, timeout=20).stdout.strip()
        out["power_limit_w"] = float(limit)
    except (OSError, ValueError, subprocess.SubprocessError):
        pass
    return out


def verdict(checks: list) -> bool:
    """Whether every compared number lies within its limit."""
    return all(c["value"] <= c["limit"] for c in checks)


def check_line(checks: list) -> dict:
    return {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}


# ---------------------------------------------------------------------------
# Shared arithmetic of the per-layer readers
# ---------------------------------------------------------------------------

def idle_pct(p: Profile | None):
    """100 x (1 - device busy seconds / wall seconds) of a profiled slice."""
    if p is None or not p.device_ops or p.wall_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s() / p.wall_s)


def device_kernels(p: Profile) -> int:
    """Device kernels of a profiled slice (copies and fills left out)."""
    return sum(1 for n, _, _ in p.device_ops if not n.startswith(("Memcpy", "Memset")))


def roofline_pct(p: Profile | None, wrapper: str, kernel: str, bound_fn):
    """100 x the sampled calls' summed bound over the same calls' summed
    device time.  None when the slice sampled no call of ``wrapper`` or
    its CUDA kernel's launches cannot be told from another wrapper's."""
    if p is None or not p.calls.get(wrapper):
        return None
    times = p.times_of(kernel)
    if len(times) != p.launched.get(wrapper, -1) or \
            any(k >= len(times) for k, _ in p.calls[wrapper]):
        return None
    b = sum(bound_fn(*args)[0] for _, args in p.calls[wrapper]) / 1e3
    t = sum(times[k] for k, _ in p.calls[wrapper])
    return 100.0 * b / t if t > 0 else None
