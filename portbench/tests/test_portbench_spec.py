"""``BENCHMARK.json`` against the benchmark contract's rules on names,
units, sizes and keys, and every file it names present."""

from __future__ import annotations

import json
import re

from conftest import PORTBENCH, REPO, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line_ok(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= s["run_seconds"] <= 51 and isinstance(s["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (s["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_command_and_paths():
    s = spec()
    assert 1 <= len(s["command"]) <= 32 and all(line_ok(w) for w in s["command"])
    assert 1 <= len(s["paths"]) <= 16
    for p in s["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (REPO / p).is_dir()


def test_names_units_and_keys():
    s = spec()
    names = [c["name"] for c in s["configs"]]
    cells = [w["name"] for w in s["workloads"]]
    metrics = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).is_file()
    pairs = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert line_ok(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and line_ok(m["layer"])
        assert m["moves"] in {e["name"] for e in s["end_to_end"]}
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert all(c in cells for c in m.get("workloads", cells))
    assert "setup_s" in {m["name"] for m in s["end_to_end"]}


def test_every_cell_reports_what_it_must():
    s = spec()
    for w in s["workloads"]:
        e2e = [m["name"] for m in s["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        per = [m for m in s["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        assert all(m["moves"] in e2e for m in per)


def test_files_of_every_name():
    s = spec()
    for c in s["configs"]:
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
    for w in s["workloads"]:
        traffic = json.loads((PORTBENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (PORTBENCH / "traffic" / f"{traffic['kind']}.py").is_file()
        assert (PORTBENCH / "cells" / f"{w['name']}.json").is_file()
    for m in s["per_layer"]:
        assert (PORTBENCH / "metrics" / f"{m['name']}.py").is_file()
