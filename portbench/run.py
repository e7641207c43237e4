"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero without a result when no CUDA card (or fewer than the
cell asks for) is present, when ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded once the window has closed, or when the port cannot be
imported.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number the correctness check compared, beside its limit.  The same
numbers close standard error.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(run) -> dict:
    """Set up, measure, read and judge one run; returns the result line
    (without the module check, which :func:`main` makes)."""
    from portbench import harness
    gen = harness.load_module(run.root / "traffic" / f"{run.traffic['kind']}.py")
    out = gen.run(run)
    metrics = out["per_layer"] if run.trace else out["end_to_end"]
    line = {"correct": harness.verdict(out["checks"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": out["device"]}
    print(f"portbench: {run.name} seed {run.seed}: {out['attempted']} in the window, "
          f"reference {out['reference_s']:.1f} s", out.get("note", ""), file=sys.stderr)
    if run.trace:
        line["breakdown"] = out["breakdown"]
    line["check"] = harness.check_line(out["checks"])
    return line


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    from portbench import harness
    try:
        spec = harness.load_json(harness.SPEC)
        cells = {w["name"]: w for w in spec["workloads"]}
        if args.workload not in cells:
            raise harness.Refused(f"no workload {args.workload!r} in {harness.SPEC}")
        import torch
        chips = int(cells[args.workload]["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise harness.Refused(f"the cell needs {chips} CUDA card(s); "
                                  f"{torch.cuda.device_count()} found")
        run = harness.make_run(spec, args.workload, args.seed, args.seconds,
                               bool(args.trace), "cuda", T0)
        line = run_cell(run)
    except harness.Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = harness.jax_modules()
    if found:
        print(f"portbench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    for name, c in line["check"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
