"""The regen kernel (``ops/regen_kernels.py``, ``csrc/regen_kernels.cu``)
against the eager ``regen.regen``, on the card (marked ``gpu``; skipped
without one).

Inside real queue loops, run op by op (no CUDA graph), the museum
through ``render_queue`` and cloud100k through ``render_queue_flat``, at
1,024, 8,192, 10,000 and 16,384 lanes, every regeneration runs both ways
on the same registers:
the eager code's result carries the loop on, and the kernel's, from
copies, must equal it bit for bit in every register (claims, the claim
cursor, ``k_lane``, pixel and ray ids, bounces, the new rays, and on the
flat route the next traced ray and its flags), with the frame's counts
exact and its sums equal up to the order of the float additions.

Whole ``render_queue`` and ``render_queue_flat`` batches with the kernel
give the eager helper's sample counts exactly and its sums within the
sharded tests' rtol 1e-3 / atol 2e-3 (the atomics add in another order),
and the wrapper counts one launch an iteration.

This file imports no JAX, so that the card's tests run where JAX is not
installed.
"""

import dataclasses
import functools

import pytest
import torch

from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.ops import integrator, wavefront
from wasm_pathtracer_tpu_torch.ops import regen as rg
from wasm_pathtracer_tpu_torch.ops import regen_kernels as rgk

from tests.torch_port_helpers import eager_queue_loop

KERNEL = rgk.fused_regen
NEE = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=8)
SIZE = 256


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@functools.cache
def _session(scene_id):
    from wasm_pathtracer_tpu_torch.runtime.session import Session
    return Session(SIZE, SIZE, scene_id=scene_id, device=torch.device("cuda"))


def _queue_fn(scene_id):
    return wavefront.render_queue_flat if scene_id == 5 else integrator.render_queue


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


class RegenCheck:
    """In place of ``fused_regen``: runs the eager code on the loop's
    registers and the kernel on copies of them, and records every
    register that differs."""

    def __init__(self):
        self.launches = 0   # the wrapper counts on whatever its module name holds
        self.calls = 0
        self.claims = 0
        self.bad = {}

    def __call__(self, q, ln, was=None, fin=None):
        kq = dataclasses.replace(q, acc=q.acc.clone(), cnt=q.cnt.clone())
        kl = rg.Lanes(**{f.name: None if getattr(ln, f.name) is None
                         else getattr(ln, f.name).clone() for f in dataclasses.fields(ln)})
        issued = int(ln.issued)
        rg.regen(q, ln, was, fin)
        KERNEL(kq, kl, was, fin)
        self.calls += 1
        self.claims += int(ln.issued) - issued
        for f in dataclasses.fields(ln):
            want, got = getattr(ln, f.name), getattr(kl, f.name)
            if want is None:
                continue
            if want.dtype != got.dtype or not torch.equal(_bits(want), _bits(got)):
                self.bad[f.name] = self.bad.get(f.name, 0) + 1
        if not torch.equal(q.cnt, kq.cnt):
            self.bad["cnt"] = self.bad.get("cnt", 0) + 1
        if not torch.allclose(q.acc[:-1], kq.acc[:-1], rtol=1e-5, atol=1e-6):
            self.bad["acc"] = self.bad.get("acc", 0) + 1


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1024, 8192, 10000, 16384])
@pytest.mark.parametrize("scene_id", [0, 5], ids=["museum", "cloud100k"])
def test_kernel_matches_eager_register_by_register(monkeypatch, scene_id, lanes):
    dev = _card()
    sess = _session(scene_id)
    check = RegenCheck()
    monkeypatch.setattr(rgk, "fused_regen", check)
    monkeypatch.setattr(integrator, "_loop", eager_queue_loop)
    g = torch.Generator().manual_seed(lanes + scene_id)
    pix = torch.randint(0, SIZE * SIZE, (3 * lanes,), generator=g).to(dev)
    _queue_fn(scene_id)(sess.prep, sess.scene, NEE, sess.camera, pix, SIZE, SIZE,
                        0x5EED + lanes, lanes, rid_base=0xFFFFF000)
    torch.cuda.synchronize()
    assert check.calls > 0 and check.claims == 2 * lanes
    assert not check.bad, f"{check.calls} calls: registers that differ {check.bad}"


@pytest.mark.gpu
@pytest.mark.parametrize("scene_id", [0, 5], ids=["museum", "cloud100k"])
def test_whole_batches_match_eager(monkeypatch, scene_id):
    """A batch of 3 x 8,192 random pixels on 8,192 lanes through the
    kernel, then through the eager helper on the card."""
    dev = _card()
    sess = _session(scene_id)
    g = torch.Generator().manual_seed(scene_id)
    pix = torch.randint(0, SIZE * SIZE, (3 * 8192,), generator=g).to(dev)

    def run():
        return _queue_fn(scene_id)(sess.prep, sess.scene, NEE, sess.camera, pix, SIZE, SIZE,
                                   0xC0FFEE, 8192, return_iters=True)

    before = KERNEL.launches
    acc, cnt, cost, its = run()
    assert KERNEL.launches - before == its > 0
    with monkeypatch.context() as m:
        m.setattr(rgk, "fused_regen", lambda q, ln, was=None, fin=None: rg.regen(q, ln, was,
                                                                                fin))
        r_acc, r_cnt, r_cost, r_its = run()
    torch.cuda.synchronize()
    assert KERNEL.launches - before == its
    assert r_its == its and torch.equal(r_cnt, cnt) and torch.equal(r_cost, cost)
    assert int(cnt.sum()) == pix.numel()
    assert torch.allclose(acc, r_acc, rtol=1e-3, atol=2e-3)
