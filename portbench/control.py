"""Read a cell's correctness numbers for the program and for its control
on several seeds in one process.

    python3 -m portbench.control --workload <cell> --seconds <s> --seeds 1 2 3 ...

The control is the reference put in the program's place and computed in
bfloat16, the nearest precision below the configurations' float32.  For
each seed this prints one JSON line: the program's numbers (from which
the lower reading of each limit comes) and the control's (the upper
reading).  The limits are read at the cell's own size, so it runs on
the card, and exits non-zero without a line when the cell's cards are
not there.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    from portbench import harness
    spec = harness.load_json(harness.SPEC)
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no workload {args.workload!r} in {harness.SPEC}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = harness.make_run(spec, args.workload, seed, args.seconds, False, "cuda", t0)
        gen = harness.load_module(run.root / "traffic" / f"{run.traffic['kind']}.py")
        out = gen.run(run, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": harness.check_line(out["checks"]),
                          "control": harness.check_line(out["control_checks"]),
                          "control_correct": harness.verdict(out["control_checks"]),
                          **{k: harness.check_line(v) for k, v in out.items()
                             if k.startswith("fault_")},
                          "metrics": out["end_to_end"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
