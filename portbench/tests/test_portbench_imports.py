"""What a run loads: nothing of JAX or the JAX package, and in the
reference nothing of the port; and no result without a card or without
the port."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from conftest import PORTBENCH, REPO, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "wasm_pathtracer_tpu"}

PROBE = """
import json, pathlib, sys, time
sys.path.insert(0, {tests!r})
from conftest import cut_root, run_cut
import tempfile
with tempfile.TemporaryDirectory() as tmp:
    root = cut_root(pathlib.Path(tmp))
    line, _ = run_cut(root, {cell!r}, seconds=0.5, trace=True)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_a_run_loads_no_jax(cell):
    out = subprocess.run([sys.executable, "-c", PROBE.format(tests=str(PORTBENCH / "tests"),
                                                             cell=cell)],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "wasm_pathtracer_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_yardstick_imports_nothing_of_the_port():
    code = ("import sys, pkgutil, importlib, portbench.reference as r, portbench.workcount\n"
            "for m in pkgutil.iter_modules(r.__path__): importlib.import_module('portbench.reference.' + m.name)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"wasm_pathtracer_tpu_torch"})


@pytest.mark.parametrize("command", [
    ["portbench.run", "--seed", "1", "--trace", "0"],
    ["portbench.control", "--seeds", "1"],
])
def test_no_card_no_result(command):
    """The benchmark's runs and the control's readings need the card."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", *command, "--workload", "museum.session",
                          "--seconds", "1"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_no_port_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails and prints no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, 'portbench/tests')\n"
            "from conftest import cut_root, run_cut\n"
            "import pathlib\n"
            "root = cut_root(pathlib.Path('cut'))\n"
            "line, _ = run_cut(root, 'museum.session', seconds=0.5)\n"
            "print(line)")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "wasm_pathtracer_tpu_torch" in out.stderr
