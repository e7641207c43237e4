"""Process-group set-up and scaling measurement
(``wasm_pathtracer_tpu.parallel.distributed``).

The JAX version is one controller over every device of every host.
PyTorch runs one process per device: each process calls
:func:`initialize` with its rank, and the renderers of
``parallel.shard`` run unchanged over the group it joins.

``measure_scaling`` is the harness for the >85% scaling-efficiency
target: per-device throughput at 1 rank against n ranks on the same
workload.

:func:`launch` starts n ranks of a function on this host, one process a
card, each joined through :func:`initialize`; a rank that fails ends
every rank.
"""

from __future__ import annotations

import ctypes
import os
import signal
import socket
import sys
import time
import traceback
from datetime import timedelta
from typing import Callable, Optional

import torch
import torch.distributed as dist

from wasm_pathtracer_tpu_torch.parallel.shard import make_ray_mesh
from wasm_pathtracer_tpu_torch.utils.device import resolve_device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None, timeout_s: Optional[float] = None) -> int:
    """Join the default process group when asked to by the arguments; a
    single process (no arguments) does nothing.

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous (None:
    ``MASTER_ADDR``/``MASTER_PORT`` from the environment, as are a missing
    ``num_processes`` and ``process_id``: ``WORLD_SIZE``, ``RANK``); ``device`` is
    ``"cuda"`` by default (NCCL, and the current CUDA device set to the
    local rank: ``LOCAL_RANK``, else ``process_id`` modulo the card count)
    or ``"cpu"`` (gloo).  ``timeout_s`` bounds the rendezvous and every
    collective (None: PyTorch's default).

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
            rank=-1 if process_id is None else process_id,
            **({} if timeout_s is None else {"timeout": timedelta(seconds=timeout_s)}))
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


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _pin_cpus(rank: int, ranks: int):
    """Give this rank a disjoint share of the CPUs the process may use,
    and size PyTorch's host threads to it."""
    cpus = sorted(os.sched_getaffinity(0))
    share = len(cpus) // ranks
    if share >= 1:
        os.sched_setaffinity(0, cpus[rank * share:(rank + 1) * share])
        torch.set_num_threads(share)


_host_group = None


def host_group():
    """A gloo group over the whole world for host messages, made on the
    first call (a collective: every rank calls it at the same point)."""
    global _host_group
    if _host_group is None:
        _host_group = dist.new_group(backend="gloo")
    return _host_group


def rank0_decides(flag: bool) -> bool:
    """Rank 0's ``flag``, on every rank: a broadcast over
    :func:`host_group`, no device work.  A loop whose steps must pair up
    across ranks (each ends in a collective) asks this before each step,
    so that rank 0's clock stops every rank after the same step."""
    t = torch.tensor([int(bool(flag))])
    dist.broadcast(t, 0, group=host_group())
    return bool(t.item())


# imported once by the process that forks the ranks, not again by each
PRELOAD = ["torch", "torch.distributed", "wasm_pathtracer_tpu_torch.runtime.session",
           "wasm_pathtracer_tpu_torch.parallel.distributed"]


def _rank_entry(rank, fn, ranks, port, device, timeout_s, args, results):
    # the kernel kills this rank when the process that forked it ends
    # (it ends with the launcher), so no rank outlives the caller
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    os.environ["LOCAL_RANK"] = str(rank)
    _pin_cpus(rank, ranks)
    try:
        initialize(f"localhost:{port}", ranks, rank, device=device, timeout_s=timeout_s)
        mesh = make_ray_mesh(device=device)
        # the communicator is made here, by one small collective, and not
        # inside the caller's first batch
        warm = mesh.all_reduce(torch.ones(1, device=mesh.device))
        if int(warm.item()) != ranks:
            raise RuntimeError(f"a warm all-reduce over {ranks} ranks gave {warm.item()}")
        out = fn(mesh, *args)
        if rank == 0:
            results.put((rank, True, out))
    except BaseException as e:
        traceback.print_exc()
        sys.stderr.flush()
        results.put((rank, False, f"{type(e).__name__}: {e}"))
        # skip the interpreter's clean-up: a peer may be gone mid-collective
        os._exit(1)
    dist.destroy_process_group()


def launch(fn: Callable, ranks: int, args: tuple = (), device="cuda",
           timeout_s: float = 600.0):
    """Run ``fn(mesh, *args)`` on ``ranks`` processes of this host and
    return rank 0's result.

    The ranks are forked by one server process that has imported torch
    and the port once (``PRELOAD``; the ``forkserver`` start method), so
    no rank imports them again.  Each joins a group of ``ranks`` through
    :func:`initialize` (a ``localhost`` rendezvous on a free port; NCCL,
    with rank r on card r, for ``device="cuda"``, else gloo), runs one
    all-reduce so that the communicator exists before ``fn`` starts, and
    calls ``fn`` with its ``parallel.shard.RayMesh``.  ``fn`` and ``args``
    must pickle (a function of an importable module).  ``timeout_s``
    bounds the rendezvous and every collective.  Each rank's host threads
    get a disjoint share of the CPUs this process may use, so that no two
    ranks' launch loops take turns on one core.

    The first rank that raises or exits non-zero ends every rank at once
    (``torch.multiprocessing``'s ``ProcessContext.join``), and the call
    raises ``RuntimeError`` naming it; a rank never outlives the caller.
    Fewer cards than ranks raise ``ValueError`` before any rank starts.
    """
    import torch.multiprocessing as tmp
    from torch.multiprocessing.spawn import ProcessException
    if resolve_device(device).type == "cuda" and torch.cuda.device_count() < ranks:
        raise ValueError(f"{ranks} ranks need {ranks} CUDA cards, one a rank; "
                         f"{torch.cuda.device_count()} found")
    ctx = tmp.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)
    results = ctx.SimpleQueue()
    procs = tmp.start_processes(
        _rank_entry, args=(fn, ranks, _free_port(), device, timeout_s, args, results),
        nprocs=ranks, join=False, start_method="forkserver")
    said = []   # (rank, ok, value) in the order the ranks sent them
    try:
        while True:
            try:
                done = procs.join(0.1)
            except ProcessException as e:
                while not results.empty():
                    said.append(results.get())
                # the first rank to report a failure names the cause; its
                # peers may fail after it, on the collective it left
                rank, why = next(((r, f"failed: {v}") for r, ok, v in said if not ok),
                                 (e.error_index, str(e).strip().splitlines()[0]))
                raise RuntimeError(f"rank {rank} of {ranks} {why}; "
                                   f"every rank was stopped") from None
            # rank 0's result is read while it runs, so a large one never
            # blocks its writer
            while not results.empty():
                said.append(results.get())
            if done:
                break
        got = [v for r, ok, v in said if r == 0 and ok]
        if not got:
            raise RuntimeError(f"rank 0 of {ranks} ended without a result")
        return got[0]
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
