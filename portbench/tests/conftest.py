"""Fixtures of the benchmark's own tests: a copy of ``portbench/`` whose
configurations are cut to a size the CPU renders in seconds, and a
helper that runs a cell from it on the CPU (the plain versions of the
port's kernels), without the harness's look for a card."""

from __future__ import annotations

import json
import pathlib
import shutil
import time

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
PORTBENCH = REPO / "portbench"


def cut_root(tmp: pathlib.Path) -> pathlib.Path:
    """``portbench/`` copied under ``tmp`` with 16x16 viewports, batches
    of 64 paths, 4 bounces, 1,000 photons and a 1-spp bootstrap.  After
    two warm frames every frame of the window is past the bootstrap, so a
    window that renders one frame, as on a loaded host, still checks an
    adaptive pick and comes out correct."""
    root = tmp / "portbench"
    shutil.copytree(PORTBENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for c in ("museum", "cloud100k"):
        p = root / "configs" / f"{c}.json"
        cfg = json.loads(p.read_text())
        cfg["width"] = cfg["height"] = 16
        cfg["settings"].update(ray_batch_size=64, total_photons=1000, regen_lanes=64,
                               max_bounces=4, adaptive_bootstrap_spp=1)
        p.write_text(json.dumps(cfg))
    for t in ("frames_regen", "frames_per_pixel"):
        p = root / "traffic" / f"{t}.json"
        tf = json.loads(p.read_text())
        tf.update(frame_ticks=128, check_frames=[[0, 1]], warm_frames=2,
                  profile_frames=1)
        p.write_text(json.dumps(tf))
    p = root / "traffic" / "train_sgd.json"
    tf = json.loads(p.read_text())
    tf.update(max_bounces=3, reference_block_pixels=128, target_spp=2, profile_steps=1)
    p.write_text(json.dumps(tf))
    for c in ("museum.session", "cloud100k.session", "cloud100k.per_pixel"):
        p = root / "cells" / f"{c}.json"
        ch = json.loads(p.read_text())
        ch["check_paths"] = 32
        p.write_text(json.dumps(ch))
    return root


@pytest.fixture(scope="session")
def cut(tmp_path_factory):
    return cut_root(tmp_path_factory.mktemp("cut"))


def spec() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def run_cut(root, workload, seconds=3.0, trace=False, seed=123456789012, spec_=None,
            control=False):
    """(result line, out) of one run of ``workload`` on the CPU from the
    cut copy ``root``."""
    from portbench import harness
    from portbench import run as prun
    run = harness.make_run(spec_ or spec(), workload, seed, seconds, trace, "cpu",
                           time.perf_counter(), root=root)
    if control:
        gen = harness.load_module(root / "traffic" / f"{run.traffic['kind']}.py")
        return None, gen.run(run, control=True)
    return prun.run_cell(run), None


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided here, never
    at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
