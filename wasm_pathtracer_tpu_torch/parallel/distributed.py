"""Process-group set-up and scaling measurement
(``wasm_pathtracer_tpu.parallel.distributed``).

The JAX version is one controller over every device of every host.
PyTorch runs one process per device: each process calls
:func:`initialize` with its rank, and the renderers of
``parallel.shard`` run unchanged over the group it joins.

``measure_scaling`` is the harness for the >85% scaling-efficiency
target: per-device throughput at 1 rank against n ranks on the same
workload.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from wasm_pathtracer_tpu_torch.parallel.shard import make_ray_mesh
from wasm_pathtracer_tpu_torch.utils.device import resolve_device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None) -> int:
    """Join the default process group when asked to by the arguments; a
    single process (no arguments) does nothing.

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous (None:
    ``MASTER_ADDR``/``MASTER_PORT`` from the environment, as are a missing
    ``num_processes`` and ``process_id``: ``WORLD_SIZE``, ``RANK``); ``device`` is
    ``"cuda"`` by default (NCCL, and the current CUDA device set to the
    local rank: ``LOCAL_RANK``, else ``process_id`` modulo the card count)
    or ``"cpu"`` (gloo).

    Returns the world size: PyTorch runs one process per device, so this
    is the count of devices the group spans, the counterpart of the JAX
    version's ``len(jax.devices())``.
    """
    if coordinator_address is not None or num_processes is not None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            local = os.environ.get("LOCAL_RANK")
            torch.cuda.set_device(int(local) if local is not None
                                  else (process_id or 0) % torch.cuda.device_count())
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=(f"tcp://{coordinator_address}" if coordinator_address
                         is not None else "env://"),
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id)
    return dist.get_world_size() if dist.is_initialized() else 1


def measure_scaling(render_fn, device_counts, seed=0, iters: int = 5, device=None):
    """Throughput scaling over the first n ranks, for each n of
    ``device_counts`` up to the world size.

    ``render_fn(mesh, seed)`` renders one frame or batch over the given
    mesh (``parallel.shard.RayMesh``) on ``device`` (see
    ``make_ray_mesh``).  Every rank must call this: each n builds a group
    of ranks 0..n-1 (``new_group`` is collective over the world), ranks
    outside it skip the render, and a frame's time is its slowest rank's.
    Returns, on every rank, one dict per n: ``devices``,
    ``seconds_per_frame``, ``efficiency`` (per-device throughput against
    1 rank's) and ``aggregate_efficiency`` (t(1) / t(n) at fixed total
    work: on ranks sharing one host's cores, the ideal is 1.0).
    """
    world = make_ray_mesh(device=device)
    results = []
    base_dt = None
    for n in device_counts:
        if n > world.size:
            break
        group = dist.new_group(list(range(n))) if world.group is not None else None
        dt = torch.zeros(1, dtype=torch.float64, device=world.device)
        if world.rank < n:
            mesh = make_ray_mesh(group, device)
            sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
            render_fn(mesh, seed)
            sync()
            t0 = time.perf_counter()
            for i in range(iters):
                render_fn(mesh, seed + 1 + i)
            sync()
            dt[0] = (time.perf_counter() - t0) / iters
        # the slowest rank's time, on every rank; ranks outside the group
        # wait here
        dt = float(torch.cat(world.all_gather(dt)).max())
        if base_dt is None:
            base_dt = dt
        results.append(dict(
            devices=n,
            seconds_per_frame=dt,
            # strong scaling: per-device throughput at n ranks against 1
            efficiency=base_dt / (dt * n),
            aggregate_efficiency=base_dt / dt,
        ))
    return results
