"""The port's host spans (``utils/spans.py``) on the CPU.

Under ``torch.profiler.profile`` a session batch, the regenerating queue
(dense and flat), the per-pixel route and the train step record their
``wpt/`` spans, nested by interval as the layers nest; the queue loops
record one ``wpt/queue.iter`` per loop iteration, as many as
``return_iters`` and ``Session.num_queue_iters`` count.  With no
profiler the facility makes no profiler record, recording spans changes
no result bit, and on the card a span stays off the device timeline.
"""

import collections
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models import scenes
from wasm_pathtracer_tpu_torch.models.camera import initial_camera
from wasm_pathtracer_tpu_torch.ops import bvh, integrator, trace, wavefront
from wasm_pathtracer_tpu_torch.parallel import make_ray_mesh, make_train_step
from wasm_pathtracer_tpu_torch.runtime.session import Session
from wasm_pathtracer_tpu_torch.utils import spans

from tests.torch_port_helpers import one_thread  # noqa: F401 (a fixture)

W = H = 16
BATCH = 64
SMALL = dict(max_bounces=4, ray_batch_size=BATCH, regen_lanes=32, total_photons=256,
             adaptive_bootstrap_spp=1)


def small_session(use_bvh=None, **kw):
    """A 16x16 museum session (left NEE, right PNEE + adaptive) whose
    photons are done and whose adaptive half is past its bootstrap, so
    that its next ``compute(2 * BATCH)`` traces one batch a half and
    makes every host read of a frame."""
    def st(rt, **more):
        return RenderSettings(render_type=rt, **SMALL, **kw, **more)
    sess = Session(W, H, 0, left=st(RenderType.NORMAL_NEE),
                   right=st(RenderType.PNEE, adaptive=True), use_bvh=use_bvh, device="cpu")
    while sess.right._rays_traced < sess.right.width * sess.right.height:
        sess.compute(2 * BATCH)
    return sess


def recorded(fn):
    """(fn's result, [(name, parent name)]) of the ``wpt/`` spans
    ``fn()`` records, in start order, each span's parent the innermost
    span whose interval holds it (prefix dropped)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ev = sorted(((e.name()[len(spans.PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith(spans.PREFIX)), key=lambda x: (x[1], -x[2]))
    tree, stack = [], []
    for name, s, e in ev:
        while stack and stack[-1][2] < e:
            stack.pop()
        tree.append((name, stack[-1][0] if stack else None))
        stack.append((name, s, e))
    return out, tree


def frame(sess):
    n = sess.compute(2 * BATCH)
    sess.results()
    return n


# the spans of one frame every route records, with their parents
FRAME = {("session.batch", None): 2, ("session.pick", "session.batch"): 2,
         ("queue", "session.batch"): 2, ("sync.photons_done", None): 1,
         ("sync.density", None): 1, ("sync.cost", None): 2, ("session.results", None): 1,
         ("sync.readout", "session.results"): 1}


@pytest.mark.parametrize("route", ["queue", "flat"])
def test_session_spans_of_the_regenerating_queue(route, monkeypatch, one_thread):
    sess = small_session(use_bvh=route == "flat")
    assert (sess.prep.cluster is not None) == (route == "flat")
    # every queue call again with return_iters, after the frame
    fn_name = "render_queue_flat" if route == "flat" else "render_queue"
    module = wavefront if route == "flat" else integrator
    calls, queue_fn = [], getattr(module, fn_name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return queue_fn(*args, **kw)
    monkeypatch.setattr(module, fn_name, spy)
    iters0 = sess.num_queue_iters
    n, tree = recorded(lambda: frame(sess))
    assert n == 2 * BATCH and len(calls) == 2
    count = collections.Counter(tree)
    its = count[("queue.iter", "queue")]
    want = dict(FRAME)
    want.update({("queue.iter", "queue"): its, ("sync.queue_alive", "queue"): its + 2,
                 ("regen", "queue.iter"): its})
    # the dense loop traces a bounce's hit and its shadow ray apart; the
    # flat one advances every lane's trace once an iteration
    per_iter = 1 if route == "flat" else 2
    want.update({("trace", "queue.iter"): per_iter * its, ("shade", "queue.iter"): per_iter * its})
    assert dict(count) == want
    returned = [queue_fn(*a, **dict(k, iters_out=None, return_iters=True))[3] for a, k in calls]
    assert its == sum(returned) == sess.num_queue_iters - iters0 > 0


def test_session_spans_of_the_per_pixel_route(one_thread):
    # clustered, so that the lockstep cluster trace polls its rounds
    sess = small_session(use_bvh=True, use_regen=False)
    _, tree = recorded(lambda: frame(sess))
    count = collections.Counter(tree)
    # a bounce traces its hit and its shadow ray; each batch polls before
    # every bounce and once more when its paths all died early
    bounces = count[("trace", "queue")] // 2
    assert count[("trace", "queue")] == count[("shade", "queue")] == 2 * bounces
    assert bounces <= count[("sync.paths_alive", "queue")] <= bounces + 2
    assert count[("sync.cluster_active", "trace")] >= 2 * bounces >= 4
    assert {k: v for k, v in count.items() if k in FRAME} == FRAME
    assert not {name for name, _ in tree} & {"queue.iter", "regen", "sync.queue_alive"}
    assert sess.num_queue_iters == 0


def test_train_step_spans(one_thread):
    scene = scenes.select_scene(0, device="cpu")
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=2)
    step = make_train_step(make_ray_mesh(device="cpu"), trace.prepare(scene), st, 8, 8,
                           train_camera=False)
    target = torch.zeros((8, 8, 3))
    _, tree = recorded(lambda: step(scene, initial_camera(0, "cpu"), target, 3))
    count = collections.Counter(tree)
    assert count[("train.forward", None)] == count[("train.backward", None)] == 1
    # the checkpointed bounces trace and shade again in the backward
    for phase in ("trace", "shade"):
        assert count[(phase, "train.forward")] == count[(phase, "train.backward")] == 4


def test_no_profiler_makes_no_record(monkeypatch, one_thread):
    def refuse(*args, **kw):
        raise AssertionError("a profiler record made with no profiler running")
    monkeypatch.setattr(spans, "_RecordFunctionFast", refuse)
    sess = small_session()
    sess2 = small_session(use_bvh=True, use_regen=False)
    assert frame(sess) == frame(sess2) == 2 * BATCH
    assert spans.span("queue") is spans.span("trace", {"round": 1})


@pytest.mark.parametrize("route", ["queue", "flat"])
def test_spans_change_no_result_bit(route, one_thread):
    scene = scenes.select_scene(0, device="cpu")
    prep = trace.prepare(scene)
    fn = integrator.render_queue
    if route == "flat":
        prep = bvh.attach_clusters(prep, scene, num_bins=16, min_count=1)
        fn = wavefront.render_queue_flat
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=4)
    pix = torch.randint(0, W * H, (96,), generator=torch.Generator().manual_seed(5))

    def batch():
        return fn(prep, scene, st, initial_camera(0, "cpu"), pix, W, H, 11, 32)
    off = batch()
    on, tree = recorded(batch)
    assert ("queue.iter", None) in tree
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_gate_is_the_profilers_own_flag():
    from torch.autograd import profiler as autograd_profiler
    assert autograd_profiler._is_profiler_enabled is False
    assert isinstance(spans.span("queue"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert isinstance(spans.span("queue"), torch._C._profiler._RecordFunctionFast)
    assert autograd_profiler._is_profiler_enabled is False


@pytest.mark.gpu
def test_spans_stay_off_the_device_timeline():
    """A span is a host event only: the device trace holds the kernels
    launched inside it and no range of its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = torch.ones(1 << 20, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with spans.span("queue.iter"):
            x = x * 2 + 1
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ev = [(e.name(), e.device_type()) for e in prof.profiler.kineto_results.events()]
    assert ("wpt/queue.iter", torch.autograd.DeviceType.CPU) in ev
    device = [n for n, d in ev if d == cuda]
    assert device and not [n for n in device if n.startswith(spans.PREFIX)]
