"""Helpers shared by the port's tests (``tests/test_torch_*.py``)."""

import dataclasses

import pytest
import torch


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: the plain cluster trace and the
    checkpointed lockstep loop are thousands of small ops, each of which
    waits on all of torch's threads; when the test workers share the
    cores that wait, not the work, sets the time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tensors_of(x):
    """Every tensor ``x`` holds, through tuples, lists and dataclasses."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tensors_of(v)]
    return []


def eager_queue_loop(step, q, ln, c, light_tab, packed_rows, graph=False):
    """In place of ``integrator._loop``: every queue iteration op by op,
    never a CUDA graph, for tests that look inside iterations (a spy that
    reads the device cannot run inside a capture, and a replay calls no
    Python)."""
    from wasm_pathtracer_tpu_torch.ops import regen_kernels as rgk
    it = 0
    while bool(ln.alive.any()):
        was, fin = step(q, ln, c, light_tab, packed_rows)
        rgk.fused_regen(q, ln, was=was, fin=fin)
        it += 1
    return it
