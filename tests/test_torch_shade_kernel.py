"""The shade kernel (``ops/shade_kernels.py``, ``csrc/shade_kernels.cu``):
when ``integrator._shade_core`` launches it, and what it computes.

On the CPU: CPU tensors, an operand that needs a gradient and edge-aware
NEE all take the eager code (a stub in place of the kernel
records whether it was called, and gradients through ``trace_paths`` stay
bit-identical); the benchmark's ``queue.shade_launch_share`` reads hand-
built profiles.

On the card (marked ``gpu``): inside real sessions, their queue loops
run op by op (no CUDA graph), every ``_shade_core`` call is run both ways on the same inputs and compared lane by lane (the
museum with uniform NEE and PNEE, scene 100, the textured Whitted scene
101 with its mirror and refractive spheres, cloud100k's flat wavefront,
the per-pixel route and the light-selection debug render); masks, light
ids and every float of the carry and the shadow query must agree bit for
bit.  Whole ``render_queue`` and ``render_queue_flat`` batches give the
eager loop's sample counts exactly and its per-path radiance within the
benchmark's 1e-4 + 1e-3 x max |channel|.

This file imports no JAX, so that the card's tests run where JAX is not
installed.
"""

import pathlib

import pytest
import torch

from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models import scenes
from wasm_pathtracer_tpu_torch.models.camera import Camera, initial_camera
from wasm_pathtracer_tpu_torch.ops import integrator, trace
from wasm_pathtracer_tpu_torch.ops import shade_kernels as shk

from tests.torch_port_helpers import eager_queue_loop

REPO = pathlib.Path(__file__).resolve().parents[1]
NEE = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=3)


def _recording_stub(calls):
    """A stand-in for ``fused_shade`` that records its calls and runs the
    eager code."""
    def stub(*args, **kw):
        calls.append(1)
        return integrator._shade_eager(*args, **kw)
    return stub


def _cpu_scene():
    scene = scenes.sphere_plane(device="cpu")
    return scene, trace.prepare(scene), initial_camera(100, "cpu")


def test_cpu_tensors_take_the_eager_path(monkeypatch):
    calls = []
    monkeypatch.setattr(shk, "fused_shade", _recording_stub(calls))
    scene, prep, cam = _cpu_scene()
    acc, cnt, _ = integrator.render_queue(prep, scene, NEE, cam, torch.arange(64), 8, 8,
                                          7, 16)
    assert calls == [] and int(cnt.sum()) == 64
    assert not shk.takes_kernel(NEE, (torch.zeros((2, 3)),))


def test_kernel_refuses_what_it_cannot_do(monkeypatch):
    """With the tensors on the card, edge-aware NEE and an operand that
    needs a gradient each keep the eager code; nothing else does."""
    monkeypatch.setattr(shk, "_on_card", lambda x: True)
    x = torch.zeros((2, 3))
    assert shk.takes_kernel(NEE, (x, x))
    assert not shk.takes_kernel(NEE.replace(edge_aware_nee=True), (x, x))
    assert not shk.takes_kernel(NEE, (x, x.clone().requires_grad_(True)))
    with torch.no_grad():
        assert shk.takes_kernel(NEE, (x, x.clone().requires_grad_(True)))


def _leaves(scene, cam, leaf):
    """(scene, camera, leaves) with ``leaf`` made a tensor that needs a
    gradient."""
    if leaf == "albedo":
        x = scene.albedo.clone().requires_grad_(True)
        return scene.with_materials(albedo=x), cam, [x]
    if leaf == "emission":
        x = scene.emission.clone().requires_grad_(True)
        return scene.with_materials(emission=x), cam, [x]
    if leaf == "light_rows":
        x = scene.params[scene.light_shape.long()].clone().requires_grad_(True)
        return scene.with_light_rows(x), cam, [x]
    x = cam.location.clone().requires_grad_(True)
    return scene, Camera(x, cam.rot_x, cam.rot_y), [x]


def _render_grads(scene, prep, cam, leaf):
    sc, c, xs = _leaves(scene, cam, leaf)
    px, py = torch.meshgrid(torch.arange(8), torch.arange(8), indexing="xy")
    col, _ = integrator.render_pixels(prep, sc, NEE, c, px.reshape(-1), py.reshape(-1),
                                      8, 8, 11)
    return torch.autograd.grad(col.sum(), xs)


@pytest.mark.parametrize("leaf", ["albedo", "emission", "light_rows", "camera"])
def test_gradients_take_the_eager_path(monkeypatch, leaf):
    """Seen as on the card, a render whose leaves need gradients never
    calls the kernel, and its gradients equal those of a plain CPU run
    bit for bit; the same render without gradients calls it once a
    bounce."""
    scene, prep, cam = _cpu_scene()
    want = _render_grads(scene, prep, cam, leaf)
    calls = []
    monkeypatch.setattr(shk, "_on_card", lambda x: True)
    monkeypatch.setattr(shk, "fused_shade", _recording_stub(calls))
    got = _render_grads(scene, prep, cam, leaf)
    assert calls == []
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with torch.no_grad():
        integrator.render_pixels(prep, scene, NEE.replace(early_exit=False), cam,
                                 torch.arange(8), torch.zeros(8, dtype=torch.int64), 8, 8,
                                 11)
    assert len(calls) == NEE.max_bounces


def _share(profile, config=None):
    from portbench import harness
    reader = harness.load_module(REPO / "portbench" / "metrics" / "queue.shade_launch_share.py")
    return reader.read(harness.Observed(config=config or {"iteration_kernel": "fused_nearest"},
                                        counters={}, host={}, profile=profile))


def _profile(names, launched):
    from portbench import harness
    ops = [(n, 10 * i, 10 * i + 5) for i, n in enumerate(names)]
    return harness.Profile(device_ops=ops, host_events=[], wall_s=1.0, launched=launched,
                           calls={}, units=1)


K1 = "void wpt::fused_nearest_kernel<8, 128>(float const*, wpt::Counts)"
SHADE = "wpt::wpt_shade_kernel(wpt::ShadeArgs)"


@pytest.mark.parametrize("names, launched, want", [
    ([K1, SHADE, "elementwise"] * 3, {"fused_nearest": 3}, 1.0),
    ([K1, "elementwise", "elementwise"] * 3, {"fused_nearest": 3}, 0.0),
    ([K1, SHADE, K1], {"fused_nearest": 2}, 0.5),
    ([SHADE], {"fused_nearest": 0}, None),
    (None, None, None),
])
def test_shade_launch_share_reader(names, launched, want):
    profile = None if names is None else _profile(names, launched)
    assert _share(profile) == want


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _ordered(x):
    """float32 bits as integers ordered like the floats."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i >= 0, i, -(i & 0x7FFFFFFF))


def lane_gaps(ref, got) -> dict:
    """{output: (lanes that differ, largest gap in ulps)} of two
    ``_shade_core`` results; NaN equals NaN."""
    (rc, rq), (gc, gq) = ref, got
    names = ("o", "d", "throughput", "color", "alive", "hdb", "absorb")
    pairs = list(zip(names, rc, gc))
    assert (rq is None) == (gq is None)
    if rq is not None:
        pairs += [(k, rq[k], gq[k]) for k in ("need", "p_from", "p_to", "light_sid", "contrib")]
    out = {}
    for name, r, g in pairs:
        assert r.shape == g.shape and r.dtype == g.dtype, name
        if not r.is_floating_point():
            bad = r != g
            out[name] = (int(bad.sum()), 0)
            continue
        same = (r == g) | (torch.isnan(r) & torch.isnan(g))
        same &= torch.signbit(r) == torch.signbit(g)
        ulps = (_ordered(r) - _ordered(g)).abs()
        ulps = torch.where(same, 0, ulps)
        lanes = (~same).reshape(r.shape[0], -1).any(-1)
        out[name] = (int(lanes.sum()), int(ulps.max()) if ulps.numel() else 0)
    return out


class ShadeCheck:
    """In place of ``integrator._shade_core``: runs the eager code and the
    kernel on the same inputs, keeps the eager result (the loop runs on
    eagerly) and sums each output's disagreements."""

    def __init__(self):
        self.calls = 0
        self.lanes = 0
        self.gaps = {}

    def __call__(self, scene, settings, light_tab, *args, packed_rows=None,
                 photon_grid=None, prep=None):
        ref = integrator._shade_eager(scene, settings, light_tab, *args,
                                      packed_rows=packed_rows, photon_grid=photon_grid)
        got = shk.fused_shade(scene, settings, light_tab, *args, packed_rows=packed_rows,
                              photon_grid=photon_grid)
        for k, (n, u) in lane_gaps(ref, got).items():
            n0, u0 = self.gaps.get(k, (0, 0))
            self.gaps[k] = (n0 + n, max(u0, u))
        self.calls += 1
        self.lanes += args[0].shape[0]
        return ref


def _settings(render_type, **kw):
    return RenderSettings(render_type=render_type, ray_batch_size=4096, total_photons=8000,
                          photons_per_tick=32, adaptive_bootstrap_spp=1, **kw)


SESSIONS = {
    # scene id, left half, right half
    "museum_uniform_pnee": (0, _settings(RenderType.NORMAL_NEE),
                            _settings(RenderType.PNEE, adaptive=True)),
    "museum_per_pixel": (0, _settings(RenderType.NORMAL_NEE, use_regen=False),
                         _settings(RenderType.PNEE, use_regen=False)),
    "museum_debug_photons": (0, _settings(RenderType.NORMAL_NEE, is_debug_photons=True),
                             _settings(RenderType.PNEE, is_debug_photons=True)),
    "sphere_plane": (100, _settings(RenderType.NORMAL_NEE), _settings(RenderType.NO_NEE)),
    "whitted_textured": (101, _settings(RenderType.NORMAL_NEE), _settings(RenderType.PNEE)),
    "cloud100k_flat": (5, _settings(RenderType.NORMAL_NEE), _settings(RenderType.PNEE)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SESSIONS))
def test_kernel_matches_eager_lane_by_lane(monkeypatch, case):
    from wasm_pathtracer_tpu_torch.runtime.session import Session
    dev = _card()
    scene_id, left, right = SESSIONS[case]
    sess = Session(64, 64, scene_id=scene_id, left=left, right=right, seed=0x5EED0000 + scene_id,
                   device=dev)
    check = ShadeCheck()
    monkeypatch.setattr(integrator, "_shade_core", check)
    monkeypatch.setattr(integrator, "_loop", eager_queue_loop)
    for _ in range(3):
        sess.compute(2 * 4096)
    torch.cuda.synchronize()
    assert check.calls > 0 and check.lanes > 0
    bad = {k: v for k, v in check.gaps.items() if v != (0, 0)}
    assert not bad, f"{case}: {check.calls} calls, {check.lanes} lanes, (lanes, ulps) {bad}"


def _eager_and_kernel(monkeypatch, fn):
    """``fn()`` through the eager code, its queue loop op by op (a host
    copy of the eager shading cannot be captured), then through the
    kernel."""
    with monkeypatch.context() as m:
        m.setattr(shk, "takes_kernel", lambda *a: False)
        m.setattr(integrator, "_loop", eager_queue_loop)
        before = shk.fused_shade.launches
        ref = fn()
        assert shk.fused_shade.launches == before
    got = fn()
    return ref, got


def _assert_batch(ref, got, n_paths):
    (ra, rc, _, r_its), (ga, gc, _, g_its) = ref, got
    assert torch.equal(rc, gc) and int(gc.sum()) == n_paths
    assert r_its == g_its
    gap = (ga - ra).abs().amax(-1)
    assert bool((gap <= 1e-4 + 1e-3 * ra.abs().amax(-1)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("scene_id", [0, 5])
def test_whole_batches_match_eager(monkeypatch, scene_id):
    """A batch of distinct pixels (one path a pixel) through
    ``render_queue`` (the museum) or ``render_queue_flat`` (cloud100k)."""
    from wasm_pathtracer_tpu_torch.ops import wavefront
    from wasm_pathtracer_tpu_torch.runtime.session import Session
    dev = _card()
    sess = Session(128, 128, scene_id=scene_id, device=dev)
    queue_fn = wavefront.render_queue_flat if scene_id == 5 else integrator.render_queue
    settings = RenderSettings(render_type=RenderType.NORMAL_NEE)
    g = torch.Generator().manual_seed(scene_id)
    pix = torch.randperm(128 * 128, generator=g)[:8192].to(dev)
    before = shk.fused_shade.launches

    def run():
        return queue_fn(sess.prep, sess.scene, settings, sess.camera, pix, 128, 128,
                        0xC0FFEE, 2048, return_iters=True)

    ref, got = _eager_and_kernel(monkeypatch, run)
    torch.cuda.synchronize()
    _assert_batch(ref, got, 8192)
    assert shk.fused_shade.launches - before == got[3]
