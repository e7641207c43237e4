"""Every cell runs end to end on the CPU at a cut size and comes out
correct, with the contract's last line; and a configuration, a traffic
mix, a cell and a per-layer metric added as new files only are found and
run."""

from __future__ import annotations

import json

import pytest

from conftest import run_cut, spec

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(cut, cell, trace):
    line, _ = run_cut(cut, cell, trace=trace)
    keys = list(line)
    want = LINE_KEYS[:-1] + (["breakdown"] if trace else []) + ["check"]
    assert keys == want
    assert line["correct"] is True, line["check"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert all(set(c) == {"value", "limit"} for c in line["check"].values())
    s = spec()
    section = s["per_layer"] if trace else s["end_to_end"]
    allowed = {m["name"]: m["unit"] for m in section
               if cell in m.get("workloads", [cell])}
    for name, m in line["metrics"].items():
        assert m["unit"] == allowed[name]
    if not trace:
        assert set(line["metrics"]) == set(allowed)
    json.dumps(line, allow_nan=False)


def test_new_files_are_found_without_an_edit(cut, tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, each
    a new file, run through the harness as it stands."""
    import shutil
    root = tmp_path / "portbench"
    shutil.copytree(cut, root)
    cfg = json.loads((root / "configs" / "museum.json").read_text())
    cfg["name"] = "museum_small"
    cfg["width"] = cfg["height"] = 8
    (root / "configs" / "museum_small.json").write_text(json.dumps(cfg))
    tf = json.loads((root / "traffic" / "frames_regen.json").read_text())
    tf["warm_frames"] = 0
    (root / "traffic" / "frames_cold.json").write_text(json.dumps(tf))
    (root / "cells" / "museum_small.cold.json").write_text(
        (root / "cells" / "museum.session.json").read_text())
    (root / "metrics" / "frames.count.py").write_text(
        "def read(obs):\n    return obs.counters['frames']\n")
    s = spec()
    s["configs"].append({"name": "museum_small", "source": "test", "reduced": ["width"],
                         "file": "portbench/configs/museum_small.json", "why": "test"})
    s["workloads"].append({"name": "museum_small.cold", "config": "museum_small",
                           "traffic": "frames_cold", "chips": 1, "why": "test"})
    s["per_layer"].append({"name": "frames.count", "unit": "frames", "better": "higher",
                           "source": "program_counter", "layer": "session step",
                           "moves": "paths_per_s", "workloads": ["museum_small.cold"]})
    for m in s["end_to_end"]:
        if m["name"] == "paths_per_s":
            m["workloads"].append("museum_small.cold")
    line, _ = run_cut(root, "museum_small.cold", trace=True, spec_=s)
    assert line["correct"] is True, line["check"]
    assert line["metrics"]["frames.count"]["value"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_cell_on_the_card(card, cell):
    """The command as the driver runs it, on the card, for a short window."""
    import subprocess
    import sys
    from conftest import REPO
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", "4000000001", "--seconds", "12", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["check"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
