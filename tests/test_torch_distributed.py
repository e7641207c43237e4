"""The port's process-group set-up and scaling harness
(``wasm_pathtracer_tpu_torch.parallel.distributed``) on the CPU, as
``tests/test_distributed.py`` holds the JAX package's; and the mesh's
refusals.  Multi-rank runs spawn gloo ranks over a ``FileStore``
(``tests/test_torch_sharding.py``'s helpers), each join with a deadline.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.test_torch_sharding import case_image, init_gloo, spawn_worlds
from wasm_pathtracer_tpu_torch.parallel import make_ray_mesh
from wasm_pathtracer_tpu_torch.parallel import shard
from wasm_pathtracer_tpu_torch.parallel.distributed import initialize, measure_scaling


def _render(mesh, seed):
    return case_image(mesh, 1, W=32, H=32, max_bounces=3, seed=seed)


def test_initialize_single_process_noop():
    assert initialize() == 1
    assert not dist.is_initialized()


def test_measure_scaling_one_process():
    """Without a group the world is one rank: one row."""
    res = measure_scaling(_render, [1, 2, 4], iters=1, device="cpu")
    assert [r["devices"] for r in res] == [1]
    assert res[0]["efficiency"] == 1.0 == res[0]["aggregate_efficiency"]
    assert res[0]["seconds_per_frame"] > 0


def _scaling_rank(rank, world, tmp):
    init_gloo(rank, world, tmp)
    try:
        res = measure_scaling(_render, [1, 2, 4], iters=2, device="cpu")
        np.save(os.path.join(tmp, f"rank{rank}.npy"),
                np.array([[r["devices"], r["seconds_per_frame"], r["efficiency"],
                           r["aggregate_efficiency"]] for r in res]))
    finally:
        dist.destroy_process_group()


def test_measure_scaling_two_ranks(tmp_path):
    """On 2 gloo ranks: rows for 1 and 2 ranks (4 is past the world),
    efficiency 1.0 at 1, positive times, the same rows on both ranks."""
    spawn_worlds(_scaling_rank, {2: tmp_path})
    rows = [np.load(tmp_path / f"rank{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(rows[0], rows[1])
    devices, seconds, eff, agg = rows[0].T
    assert devices.tolist() == [1, 2]
    assert eff[0] == 1.0 == agg[0]
    assert (seconds > 0).all() and (eff > 0).all() and (agg > 0).all()


def test_ray_mesh_without_a_group():
    mesh = make_ray_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    t = torch.arange(6.0)
    assert mesh.all_reduce(t) is t and mesh.all_gather(t)[0] is t
    with pytest.raises(ValueError, match="needs torch.distributed initialised"):
        make_ray_mesh(group=object(), device="cpu")
    if torch.cuda.is_available():
        assert make_ray_mesh().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            make_ray_mesh()


@pytest.mark.parametrize("backend", ["nccl", "cuda:nccl", "mpi"])
def test_collective_refuses_a_backend_that_does_not_suit_the_tensor(monkeypatch, backend):
    """CPU tensors need gloo (CUDA tensors NCCL); the check runs before
    any collective is made."""
    monkeypatch.setattr(shard.dist, "get_backend", lambda group: backend)
    mesh = shard.RayMesh(group=object(), rank=0, size=2, device=torch.device("cpu"))
    for collective in (mesh.all_reduce, mesh.all_gather):
        with pytest.raises(ValueError, match="needs a gloo group"):
            collective(torch.zeros(3))
