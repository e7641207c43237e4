"""The sharded cell (``museum.sharded4``) on the CPU: four gloo ranks
started through the port's launch path, at a cut size, judged by its
reference (``reference/sharded_check.py``); the control and each planted
fault caught by the check aimed at it; and a program that cannot shard
a session refused, its ranks ended, within a deadline."""

from __future__ import annotations

import json
import time

import pytest

from conftest import cut_root, run_cut, spec

CELL = "museum.sharded4"


@pytest.fixture(scope="module")
def sharded_cut(tmp_path_factory):
    """The cut copy with the sharded configuration cut as the museum's:
    16x16, 64 paths a rank a half (4 ranks), 4 bounces, 1,000 photons,
    a 1-spp bootstrap."""
    root = cut_root(tmp_path_factory.mktemp("sharded"))
    p = root / "configs" / "museum_sharded4.json"
    cfg = json.loads(p.read_text())
    cfg["width"] = cfg["height"] = 16
    cfg["settings"].update(ray_batch_size=64, total_photons=1000, regen_lanes=64,
                           max_bounces=4, adaptive_bootstrap_spp=1)
    p.write_text(json.dumps(cfg))
    p = root / "traffic" / "frames_regen_ranks4.json"
    tf = json.loads(p.read_text())
    tf.update(frame_ticks=2 * cfg["workers"] * 64, check_frames=[[0, 1]], warm_frames=2,
              profile_frames=1, rank_timeout_s=120)
    p.write_text(json.dumps(tf))
    p = root / "cells" / f"{CELL}.json"
    ch = json.loads(p.read_text())
    ch["check_paths"] = 32
    p.write_text(json.dumps(ch))
    return root


def _fails(checks, name):
    c = next(c for c in checks if c["name"] == name)
    return c["value"] > c["limit"]


@pytest.mark.parametrize("trace", [False, True])
def test_sharded_cell_runs_and_is_correct(sharded_cut, trace):
    line, _ = run_cut(sharded_cut, CELL, seconds=2.0, trace=trace)
    assert line["correct"] is True, line["check"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert {"shard_count_mismatch_px", "rank_buffer_mismatch_bytes"} <= set(line["check"])
    s = spec()
    section = s["per_layer"] if trace else s["end_to_end"]
    allowed = {m["name"]: m["unit"] for m in section if CELL in m.get("workloads", [CELL])}
    assert set(line["metrics"]) <= set(allowed)
    if not trace:
        assert set(line["metrics"]) == {"setup_s", "paths_per_s"}
    else:
        # gloo on the CPU leaves no device trace; the rank balance is counted
        assert 1.0 <= line["metrics"]["shard.rank_skew"]["value"] < 2.0
        assert "queue.iters_per_batch" in line["metrics"]
    json.dumps(line, allow_nan=False)


def test_control_and_planted_faults_are_not_correct(sharded_cut):
    """The bfloat16 control fails, and each fault fails the check aimed
    at it: a rank keeping its own sums the buffers' comparison, a skipped
    shard the shards' counts, local keys the radiance."""
    from portbench import harness
    _, out = run_cut(sharded_cut, CELL, seconds=1.0, control=True)
    assert harness.verdict(out["checks"]), out["checks"]
    assert not harness.verdict(out["control_checks"]), out["control_checks"]
    aimed = {"rank_keeps_own_sums": "rank_buffer_mismatch_bytes",
             "shard_skipped": "shard_count_mismatch_px",
             "local_keys": "radiance_mismatch_pct"}
    for fault, check in aimed.items():
        assert _fails(out[f"fault_{fault}"], check), (fault, out[f"fault_{fault}"])


def test_a_program_that_cannot_shard_a_session_is_refused(sharded_cut, monkeypatch):
    """A port without ``launch`` or whose ``Session`` takes no mesh (an
    older commit) gives no result, and starts no rank."""
    from portbench import harness
    from wasm_pathtracer_tpu_torch.parallel import distributed
    from wasm_pathtracer_tpu_torch.runtime import session

    class OldSession:
        def __init__(self, width, height, scene_id=100, camera=None, left=None, right=None,
                     seed=0, use_bvh=None, device=None):
            pass

    monkeypatch.setattr(session, "Session", OldSession)
    with pytest.raises(harness.Refused, match="takes no mesh"):
        run_cut(sharded_cut, CELL)
    monkeypatch.undo()
    monkeypatch.delattr(distributed, "launch")
    with pytest.raises(harness.Refused, match="no launch path"):
        run_cut(sharded_cut, CELL)


def _old_session_rank(mesh):
    # a rank of a program whose Session takes no mesh
    def old_session(width, height, scene_id=100, camera=None, left=None, right=None,
                    seed=0, use_bvh=None, device=None):
        return None
    old_session(16, 16, 0, device="cpu", mesh=mesh)


def test_ranks_of_a_program_that_cannot_shard_end_within_their_deadline():
    from wasm_pathtracer_tpu_torch.parallel.distributed import launch
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="unexpected keyword argument 'mesh'"):
        launch(_old_session_rank, 4, device="cpu", timeout_s=300.0)
    assert time.monotonic() - t0 < 60.0


def _rank_loads(mesh, module):
    import sys
    import types

    from portbench.traffic import frames_regen_ranks4 as gen
    from wasm_pathtracer_tpu_torch.parallel import distributed
    if mesh.rank == 2:
        sys.modules[module] = types.ModuleType(module)
    return gen.modules_of_ranks(distributed.host_group())


def test_a_rank_that_loads_jax_is_seen():
    """The ranks render, so each rank's modules are gathered: JAX loaded
    on rank 2 alone reaches rank 0's result, which the run refuses."""
    from wasm_pathtracer_tpu_torch.parallel.distributed import launch
    assert launch(_rank_loads, 4, args=("jax",), device="cpu", timeout_s=60.0) == ["jax"]
    assert launch(_rank_loads, 4, args=("json",), device="cpu", timeout_s=60.0) == []
