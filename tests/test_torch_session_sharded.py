"""The port's ``Session`` over a mesh (``runtime/session.py`` with
``mesh=``) on gloo worlds of 2 and 4 ranks, and the launch path that
starts such a session's ranks (``parallel.distributed.launch``, the CLI's
``--ranks``), on the CPU.

A sharded session renders what one rank renders with a batch n times as
large: the picks, the photon grid and every path's stream (keyed by its
global queue index) are the same, so sample counts and photon bins are
equal exactly.  A pixel's paths may sit on several ranks and their sums
are added in another order (each rank's loop, then the all-reduce), so
radiance sums agree within rtol 1e-5, atol 1e-6 (``test_torch_sharding``'s
rule for several samples a pixel).  The all-reduce hands every rank the
same sums, so every rank's buffer, photon grid and sweep position are
equal to rank 0's bit for bit.  On the one-member mesh nothing is summed
across ranks and the lanes are the same, so the session is bit-identical
to the session without a mesh.

Spawned ranks import this module, so it imports only numpy, torch and the
port at the top.  Every world has its own deadline.
"""

import functools
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.test_torch_sharding import init_gloo, spawn_worlds
from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.parallel import make_ray_mesh
from wasm_pathtracer_tpu_torch.parallel.distributed import launch
from wasm_pathtracer_tpu_torch.parallel.shard import RayMesh
from wasm_pathtracer_tpu_torch.runtime import cli
from wasm_pathtracer_tpu_torch.runtime.session import Session

W = H = 32
# each rank's share of a half's batch
RANK_BATCH = 128
WORLDS = (2, 4)
# seconds a world may take, start-up included
DEADLINE = 120
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _settings(batch, **kw):
    return RenderSettings(**dict(dict(max_bounces=3, ray_batch_size=batch, regen_lanes=64,
                                      total_photons=1500, photon_grid_res=8,
                                      adaptive_bootstrap_spp=1), **kw))


def _state(sess):
    h = sess.right
    return dict(acc=sess.buffer.acc.numpy(), count=sess.buffer.count.numpy(),
                bins=h.photon_grid.bins.numpy() if h.photon_grid is not None
                else np.zeros(0, np.float32),
                sweep=np.asarray(-1 if h._sweep is None else int(h._sweep)),
                rays=np.asarray([sess.left._rays_traced, h._rays_traced]),
                density=sess.density, iters=np.asarray(sess.num_queue_iters))


# scene, seed, frames, use_bvh and each half's settings of every case
SPECS = {
    # NEE with uniform picks on the left, PNEE with adaptive picks on the
    # right, four frames (past the 1-spp bootstrap)
    "nee_pnee": dict(scene=100, seed=7, frames=4, use_bvh=None,
                     left=dict(render_type=RenderType.NORMAL_NEE),
                     right=dict(render_type=RenderType.PNEE, adaptive=True)),
    # scene 3, every family clustered: the flat wavefront
    # (``render_queue_flat_sharded``), two frames
    "cluster": dict(scene=3, seed=11, frames=2, use_bvh=True,
                    left=dict(render_type=RenderType.NORMAL_NEE),
                    right=dict(render_type=RenderType.NO_NEE)),
}


def _case(name, world, mesh):
    c = SPECS[name]
    batch = RANK_BATCH * (world if mesh is None else 1)
    sess = Session(W, H, c["scene"], left=_settings(batch, **c["left"]),
                   right=_settings(batch, **c["right"]), seed=c["seed"],
                   use_bvh=c["use_bvh"], device="cpu", mesh=mesh)
    assert (sess.prep.cluster is not None) == bool(c["use_bvh"])
    traced = [sess.compute(2 * RANK_BATCH * world) for _ in range(c["frames"])]
    return dict(_state(sess), traced=np.asarray(traced))


def _jax_whole(name, world):
    """The JAX package's session at the world's whole batch: counts,
    sums and paths traced (JAX is imported here: spawned ranks import
    this module)."""
    from wasm_pathtracer_tpu.config import RenderSettings as JSettings
    from wasm_pathtracer_tpu.config import RenderType as JType
    from wasm_pathtracer_tpu.runtime.session import Session as JSession
    c = SPECS[name]
    base = dict(max_bounces=3, ray_batch_size=RANK_BATCH * world, regen_lanes=64,
                total_photons=1500, photon_grid_res=8, adaptive_bootstrap_spp=1)

    def half(kw):
        kw = dict(kw, render_type=JType(int(kw["render_type"])))
        return JSettings(**dict(base, **kw))
    j = JSession(W, H, c["scene"], left=half(c["left"]), right=half(c["right"]),
                 seed=c["seed"], use_bvh=c["use_bvh"])
    traced = [j.compute(2 * RANK_BATCH * world) for _ in range(c["frames"])]
    return dict(traced=np.asarray(traced), count=np.asarray(j.buffer.count),
                acc=np.asarray(j.buffer.acc))


CASES = {name: functools.partial(_case, name) for name in SPECS}


def _rank_main(rank, world, tmp):
    init_gloo(rank, world, tmp)
    try:
        mesh = make_ray_mesh(device="cpu")
        out = {}
        for name, case in CASES.items():
            out.update({f"{name}/{k}": v for k, v in case(world, mesh).items()})
        out["bytes_all_reduced"] = np.asarray(mesh.bytes_all_reduced)
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: [each rank's {key: array}]}, the worlds run side by side."""
    tmps = {w: tmp_path_factory.mktemp(f"session_world{w}") for w in WORLDS}
    spawn_worlds(_rank_main, tmps, deadline=DEADLINE)
    return {w: [dict(np.load(t / f"rank{r}.npz")) for r in range(w)]
            for w, t in tmps.items()}


@pytest.fixture(scope="module")
def one_rank():
    """{(world, case): state} of the session without a mesh, at the
    world's whole batch."""
    return {(w, name): case(w, None) for w in WORLDS for name, case in CASES.items()}


def _of(got, case):
    return {k.split("/", 1)[1]: v for k, v in got.items() if k.startswith(case + "/")}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_session_matches_one_rank(worlds, one_rank, world, case):
    ref = one_rank[(world, case)]
    got = _of(worlds[world][0], case)
    np.testing.assert_array_equal(got["traced"], ref["traced"])
    np.testing.assert_array_equal(got["count"], ref["count"])
    np.testing.assert_array_equal(got["bins"], ref["bins"])
    np.testing.assert_array_equal(got["rays"], ref["rays"])
    np.testing.assert_array_equal(got["sweep"], ref["sweep"])
    np.testing.assert_allclose(got["acc"], ref["acc"], rtol=1e-5, atol=1e-6)
    assert got["count"][:, :W // 2].sum() > 0 and got["count"][:, W // 2:].sum() > 0
    assert (got["traced"] == 2 * RANK_BATCH * world).all()
    # each rank loops over its own shard only
    assert 0 < got["iters"] < ref["iters"] * world
    # and what the JAX package renders at the whole batch: counts equal,
    # sums by the two packages' per-path rule (``test_torch_session``)
    jref = _jax_whole(case, world)
    np.testing.assert_array_equal(got["traced"], jref["traced"])
    np.testing.assert_array_equal(got["count"], jref["count"])
    assert np.isclose(got["acc"], jref["acc"], rtol=1e-3, atol=2e-3).all(-1).mean() >= 0.99


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_holds_rank0s_state(worlds, world):
    ranks = worlds[world]
    for r, got in enumerate(ranks[1:], start=1):
        for k, v in ranks[0].items():
            if k.endswith("/iters"):
                continue
            np.testing.assert_array_equal(got[k], v, err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("world", WORLDS)
def test_bytes_all_reduced(worlds, world):
    """Each batch all-reduces the frame's sums (H*W*3 float32), counts
    (H*W int32) and cost (one float32): 2 halves a frame, 4 + 2 frames."""
    per_batch = W * H * 3 * 4 + W * H * 4 + 4
    for got in worlds[world]:
        assert int(got["bytes_all_reduced"]) == 2 * (4 + 2) * per_batch


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_member_mesh_is_bit_identical_to_no_mesh(case):
    """The sharded route with one member equals the session without a
    mesh bit for bit, and makes no collective."""
    mesh = RayMesh(None, 0, 1, torch.device("cpu"))
    got, ref = CASES[case](1, mesh), CASES[case](1, None)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert mesh.bytes_all_reduced == 0


def test_mesh_session_refuses_the_per_pixel_route():
    mesh = RayMesh(None, 0, 1, torch.device("cpu"))
    sess = Session(W, H, 100, left=_settings(64, use_regen=False),
                   right=_settings(64, use_regen=False), device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="regenerating queue"):
        sess.compute(128)


def _rank_sum(mesh, scale):
    t = mesh.all_reduce(torch.full((2,), float(mesh.rank + 1)))
    return dict(rank=mesh.rank, size=mesh.size, sum=float(t[0]) * scale,
                threads=torch.get_num_threads(), cpus=len(os.sched_getaffinity(0)))


def _rank_fails(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    # the others wait for rank 1 in a collective
    mesh.all_reduce(torch.ones(1))


def test_launch_returns_rank0s_result_and_stops_every_rank_on_a_failure():
    """``launch`` joins the ranks through ``initialize``, gives each a
    third of the CPUs and returns rank 0's result; a rank that raises
    while the others wait in a collective ends every rank long before the
    group's timeout."""
    out = launch(_rank_sum, 3, args=(2.0,), device="cpu", timeout_s=60.0)
    assert out["rank"] == 0 and out["size"] == 3 and out["sum"] == 12.0
    share = len(os.sched_getaffinity(0)) // 3
    if share:
        assert out["cpus"] == out["threads"] == share
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 3 failed: RuntimeError: rank 1 fails"):
        launch(_rank_fails, 3, device="cpu", timeout_s=600.0)
    assert time.monotonic() - t0 < 60.0


def _rank_hears(mesh):
    from wasm_pathtracer_tpu_torch.parallel.distributed import rank0_decides
    heard = [rank0_decides(mesh.rank == 0), rank0_decides(mesh.rank != 0)]
    # every rank's answers, on rank 0
    return [h.tolist() for h in mesh.all_gather(torch.tensor([heard]))]


def test_every_rank_hears_rank0s_decision():
    """``rank0_decides``, the stop rule of the CLI's and the benchmark's
    loops: every rank gets rank 0's flag, whatever its own."""
    assert launch(_rank_hears, 3, device="cpu", timeout_s=60.0) == [[[True, False]]] * 3


def test_launch_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="4 ranks need 4 CUDA cards, one a rank; 2 found"):
        launch(_rank_sum, 4, args=(1.0,), device="cuda")


def test_cli_renders_a_session_over_two_ranks(tmp_path):
    """``--ranks 2 --seconds 1`` (gloo on the CPU), run as a command:
    rank 0's clock stops both ranks after the same step, and rank 0
    writes the frame and the bench line, which counts both ranks'
    paths."""
    out = tmp_path / "ranks2.png"
    proc = subprocess.run(
        [sys.executable, "-m", "wasm_pathtracer_tpu_torch.runtime.cli", "--scene", "100",
         "--width", "128", "--height", "128", "--ranks", "2", "--device", "cpu",
         "--max-bounces", "2", "--batch", "1024", "--lanes", "256", "--seconds", "1",
         "--bench", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=DEADLINE)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert out.stat().st_size > 0
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 1 and lines[0]["ranks"] == 2
    # whole steps of one batch a half on each of the two ranks
    assert lines[0]["paths"] > 0 and lines[0]["paths"] % (2 * 2 * 1024) == 0
