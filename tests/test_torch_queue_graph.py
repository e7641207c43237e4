"""The queue loop's CUDA graph (``ops/queue_graph.py``, ``integrator._loop``).

On the CPU: the copy-back of rebound registers (values, identities,
swapped registers, a changed register refused); the loop's order with a
stand-in graph that replays op by op and copies back as the graph does,
on both routes, giving the plain loop's result bit for bit, one
``queue.capture`` span outside the iterations and one ``queue.replay``
inside each iteration after the first; a loop of one iteration never
captures; CPU lanes and a trace that polls the host keep the plain loop.

On the card (marked ``gpu``): the graph's loop against the eager loop,
written here over the same route step and ``fused_regen``, on the museum
through ``render_queue`` and a clustered 10k-triangle cloud through
``render_queue_flat``, NEE and PNEE: iteration count, sample counts and
lane cost exact, and the frame's sums bit-equal on a queue that holds
each pixel once (so the regen kernel's atomic adds meet no other add);
each wrapper counts one launch an iteration, the capture none; the
trace of a profiled loop holds each kernel as often as counted.

This file imports no JAX, so that the card's tests run where JAX is not
installed.
"""

import dataclasses
import functools

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models import scenes
from wasm_pathtracer_tpu_torch.models.camera import initial_camera
from wasm_pathtracer_tpu_torch.ops import bvh, integrator, queue_graph, trace, wavefront

from tests.test_torch_spans import recorded
from tests.torch_port_helpers import eager_queue_loop, one_thread  # noqa: F401 (a fixture)


@dataclasses.dataclass
class Regs:
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor | None = None


def test_copy_back_keeps_each_register_on_its_tensor():
    r = Regs(torch.zeros(4), torch.zeros(2, 3, dtype=torch.int64))
    a0, b0 = r.a, r.b
    before = queue_graph.registers_of([r])
    r.a = torch.arange(4.0)
    r.b += 7                                  # in place: nothing to copy
    queue_graph.copy_back(before)
    assert r.a is a0 and r.b is b0 and r.c is None
    assert torch.equal(a0, torch.arange(4.0)) and bool((b0 == 7).all())


def test_copy_back_of_swapped_registers():
    r = Regs(torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0]))
    a0, b0 = r.a, r.b
    before = queue_graph.registers_of([r])
    r.a, r.b = r.b, r.a
    queue_graph.copy_back(before)
    assert r.a is a0 and r.b is b0
    assert a0.tolist() == [3.0, 4.0] and b0.tolist() == [1.0, 2.0]


@pytest.mark.parametrize("change", ["shape", "dtype", "none"])
def test_copy_back_refuses_a_changed_register(change):
    r = Regs(torch.zeros(4), torch.zeros(4))
    before = queue_graph.registers_of([r])
    r.a = {"shape": torch.zeros(5), "dtype": torch.zeros(4, dtype=torch.int32),
           "none": None}[change]
    with pytest.raises(RuntimeError, match="register a"):
        queue_graph.copy_back(before)


W = H = 16
NEE = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=4)


@functools.cache
def _cpu_case(route):
    scene = scenes.select_scene(0, device="cpu")
    prep = trace.prepare(scene)
    fn = integrator.render_queue
    if route == "flat":
        prep = bvh.attach_clusters(prep, scene, num_bins=16, min_count=1)
        fn = wavefront.render_queue_flat
    return scene, prep, fn


def _stand_in(captures):
    """In place of ``queue_graph.capture`` on the CPU: a graph whose replay
    runs the iteration op by op, then copies back as the captured graph
    does; the capture itself runs nothing."""
    def capture(iteration, registers):
        captures.append(1)
        before = queue_graph.registers_of(registers)

        def replay():
            iteration()
            queue_graph.copy_back(before)
        return replay
    return capture


def _forced_graph(monkeypatch, captures):
    """The loop takes the graph path on CPU lanes, through the stand-in."""
    loop = integrator._loop
    monkeypatch.setattr(integrator, "_loop", lambda *a: loop(*a[:-1], True))
    monkeypatch.setattr(queue_graph, "capture", _stand_in(captures))


@pytest.mark.parametrize("route", ["queue", "flat"])
def test_stand_in_graph_loop_matches_the_plain_loop(route, monkeypatch, one_thread):
    scene, prep, fn = _cpu_case(route)
    pix = torch.randint(0, W * H, (96,), generator=torch.Generator().manual_seed(3))

    def batch():
        return fn(prep, scene, NEE, initial_camera(0, "cpu"), pix, W, H, 11, 32,
                  return_iters=True)
    plain = batch()
    captures = []
    with monkeypatch.context() as m:
        _forced_graph(m, captures)
        got, tree = recorded(batch)
    its = got[3]
    assert its == plain[3] > 1 and len(captures) == 1
    for a, b in zip(plain[:3], got[:3]):
        assert torch.equal(a, b)
    # outside a session the loop's spans have no parent; the stand-in
    # capture runs no iteration, so no span of one lies inside it
    count = {k: tree.count(k) for k in set(tree)}
    assert count[("queue.capture", None)] == 1 and count[("queue.iter", None)] == its
    assert count[("queue.replay", "queue.iter")] == its - 1
    assert count[("regen", "queue.iter")] == 1
    assert count[("regen", "queue.replay")] == its - 1
    assert {p for _, p in tree} <= {None, "queue.iter", "queue.replay"}


def test_a_loop_of_one_iteration_never_captures(monkeypatch):
    scene, prep, fn = _cpu_case("queue")
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=1)
    captures = []
    _forced_graph(monkeypatch, captures)
    acc, cnt, _, its = fn(prep, scene, st, initial_camera(0, "cpu"), torch.arange(32), W, H,
                          5, 32, return_iters=True)
    assert its == 1 and not captures and int(cnt.sum()) == 32


@pytest.mark.parametrize("route", ["queue", "flat"])
def test_cpu_lanes_keep_the_plain_loop(route, monkeypatch):
    scene, prep, fn = _cpu_case(route)

    def refuse(*a):
        raise AssertionError("a capture on CPU lanes")
    monkeypatch.setattr(queue_graph, "capture", refuse)
    _, cnt, _, its = fn(prep, scene, NEE, initial_camera(0, "cpu"), torch.arange(64), W, H,
                        5, 16, return_iters=True)
    assert its > 1 and int(cnt.sum()) == 64


def test_which_traces_poll_the_host():
    scene = scenes.select_scene(0, device="cpu")
    prep = trace.prepare(scene)
    assert not trace.polls_host(prep)
    assert trace.polls_host(bvh.attach_clusters(prep, scene, num_bins=16, min_count=1))
    assert not trace.polls_host(trace.prepare(scene, use_pallas=True))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

SIZE = 128
LANES = 2048
ROUTES = {0: (integrator.render_queue,
              ("fused_nearest", "fused_occluded", "fused_shade", "fused_regen")),
          4: (wavefront.render_queue_flat,
              ("select_scan", "probe_pair", "fused_shade", "fused_regen"))}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@functools.cache
def _session(scene_id):
    """A museum or 10k-triangle cloud session whose PNEE half's photons
    are done."""
    from wasm_pathtracer_tpu_torch.runtime.session import Session

    def st(rt):
        return RenderSettings(render_type=rt, ray_batch_size=4096, total_photons=8000,
                              photons_per_tick=32, adaptive_bootstrap_spp=1)
    sess = Session(SIZE, SIZE, scene_id=scene_id, left=st(RenderType.NORMAL_NEE),
                   right=st(RenderType.PNEE), seed=0x5EED0000 + scene_id,
                   device=torch.device("cuda"))
    while not sess.right._photons_done():
        sess.compute(2 * 4096)
    return sess


def _wrappers():
    return {name: getattr(m, name) for m, name in queue_graph._wrappers()}


def _launches():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _run(scene_id, render_type, pix, max_bounces=8):
    sess = _session(scene_id)
    fn, _ = ROUTES[scene_id]
    st = RenderSettings(render_type=render_type, max_bounces=max_bounces)
    grid = sess.right.photon_grid if render_type == RenderType.PNEE else None
    before = _launches()
    out = fn(sess.prep, sess.scene, st, sess.camera, pix, SIZE, SIZE, 0xC0FFEE, LANES,
             photon_grid=grid, return_iters=True)
    torch.cuda.synchronize()
    after = _launches()
    return out, {k: after[k] - before[k] for k in after}


def _counting_captures(monkeypatch):
    captures, real = [], queue_graph.capture

    def counted(*a):
        captures.append(1)
        return real(*a)
    monkeypatch.setattr(queue_graph, "capture", counted)
    return captures


@pytest.mark.gpu
@pytest.mark.parametrize("render_type", [RenderType.NORMAL_NEE, RenderType.PNEE],
                         ids=["nee", "pnee"])
@pytest.mark.parametrize("scene_id", [0, 4], ids=["museum", "cloud10k"])
def test_graph_loop_matches_the_eager_loop(monkeypatch, scene_id, render_type):
    dev = _card()
    g = torch.Generator().manual_seed(scene_id + render_type.value)
    pix = torch.randperm(SIZE * SIZE, generator=g)[:3 * LANES].to(dev)
    _session(scene_id)                     # its photon frames capture too
    captures = _counting_captures(monkeypatch)
    (acc, cnt, cost, its), launched = _run(scene_id, render_type, pix)
    with monkeypatch.context() as m:
        m.setattr(integrator, "_loop", eager_queue_loop)
        (r_acc, r_cnt, r_cost, r_its), r_launched = _run(scene_id, render_type, pix)
    assert its == r_its > 1 and len(captures) == 1
    assert torch.equal(cnt, r_cnt) and int(cnt.sum()) == pix.numel()
    assert torch.equal(cost, r_cost)
    assert torch.equal(acc.view(torch.int32), r_acc.view(torch.int32))
    names = ROUTES[scene_id][1]
    want = {k: its if k in names else 0 for k in launched}
    assert launched == want and r_launched == want


@pytest.mark.gpu
def test_one_iteration_on_the_card_never_captures(monkeypatch):
    dev = _card()
    _session(0)
    captures = _counting_captures(monkeypatch)
    pix = torch.arange(LANES, device=dev)
    (_, cnt, _, its), launched = _run(0, RenderType.NORMAL_NEE, pix, max_bounces=1)
    assert its == 1 and not captures and int(cnt.sum()) == LANES
    assert launched["fused_regen"] == launched["fused_nearest"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("scene_id", [0, 4], ids=["museum", "cloud10k"])
def test_replays_are_traced_under_the_profiler(scene_id):
    """A graph captured inside a profile: the trace holds every kernel
    of every replay, as often as the wrappers counted."""
    dev = _card()
    pix = torch.randperm(SIZE * SIZE, generator=torch.Generator().manual_seed(9))[:3 * LANES]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (_, cnt, _, its), launched = _run(scene_id, RenderType.PNEE, pix.to(dev))
    cuda = torch.autograd.DeviceType.CUDA
    device = [e.name() for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda]
    kernel = {"fused_nearest": "fused_nearest_kernel", "fused_occluded": "fused_occluded_kernel",
              "select_scan": "select_kernel", "probe_pair": "probe_kernel",
              "fused_shade": "wpt_shade_kernel", "fused_regen": "wpt_regen_kernel"}
    for name in ROUTES[scene_id][1]:
        assert launched[name] == its > 1
        assert sum(1 for n in device if kernel[name] in n) == its, name
    assert int(cnt.sum()) == pix.numel()
