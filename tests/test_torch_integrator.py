"""The port's regenerating wavefront against the JAX package's, on the CPU
(JAX through its dense XLA trace, the port through its kernels' plain
versions).

Both key path ``i``'s random stream by its queue index, so with
``pix = arange`` and 1 sample per pixel each pixel's sum is one path's
radiance.  Sample counts and primitive-test totals must match exactly.
Per-path radiance must agree (rtol 1e-3, atol 2e-3) on >= 99% of paths:
float32 rounding of the shading math differs in the last bits between
XLA and PyTorch, and where it flips a discrete decision (a Russian
roulette draw at its threshold, a shadow ray grazing an edge) the path
goes another way, as ``tests/test_integrator.py`` allows against its
NumPy oracle.  The mean radiance agrees to 1e-3.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wasm_pathtracer_tpu.config import RenderSettings as JSettings
from wasm_pathtracer_tpu.config import RenderType as JType
from wasm_pathtracer_tpu.models import scenes as jscenes
from wasm_pathtracer_tpu.models.camera import Camera as JCamera
from wasm_pathtracer_tpu.ops import integrator as jint
from wasm_pathtracer_tpu.ops import trace as jtrace
from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models import scenes as tscenes
from wasm_pathtracer_tpu_torch.models.camera import Camera
from wasm_pathtracer_tpu_torch.ops import integrator as tint
from wasm_pathtracer_tpu_torch.ops import trace as ttrace

from tests.torch_port_helpers import one_thread  # noqa: F401 (a fixture)

CAMERAS = {
    "sphere_plane": ((0.0, 1.5, -2.0), 0.25, 0.0),
    "museum": ((0.0, 16.34, -23.76), 0.54, 0.0),
}


def _jax_queue(name, rt, pix, W, H, seed, lanes, max_bounces):
    scene = getattr(jscenes, name)()
    st = JSettings(render_type=JType(rt), max_bounces=max_bounces)
    cam = JCamera.create(*CAMERAS[name])
    prep = jtrace.prepare(scene)
    out = jax.jit(lambda s: jint.render_queue(
        prep, scene, st, cam, jnp.asarray(pix), W, H, s, lanes,
        return_iters=True))(jnp.uint32(seed))
    acc, cnt, cost, its = (np.asarray(x) for x in out)
    return acc, cnt, int(cost.astype(np.int64).sum()), int(its)


def _torch_queue(name, rt, pix, W, H, seed, lanes, max_bounces):
    scene = getattr(tscenes, name)(device="cpu")
    st = RenderSettings(render_type=RenderType(rt), max_bounces=max_bounces)
    cam = Camera.create(*CAMERAS[name], device="cpu")
    acc, cnt, cost, its = tint.render_queue(
        ttrace.prepare(scene), scene, st, cam, torch.from_numpy(pix), W, H, seed,
        lanes, return_iters=True)
    return acc.numpy(), cnt.numpy(), int(cost.sum()), its


@pytest.mark.parametrize("name,rt,max_bounces", [
    ("sphere_plane", 1, 8), ("sphere_plane", 0, 8),
    ("museum", 1, 8), ("museum", 0, 4)])
def test_render_queue_matches_jax_per_path(name, rt, max_bounces):
    W = H = 16
    pix = np.arange(W * H, dtype=np.int32)
    ref = _jax_queue(name, rt, pix, W, H, 7, 64, max_bounces)
    out = _torch_queue(name, rt, pix, W, H, 7, 64, max_bounces)
    (a0, c0, k0, i0), (a1, c1, k1, i1) = ref, out
    np.testing.assert_array_equal(c0, c1)
    assert (c1 == 1).all()
    close = np.isclose(a1, a0, rtol=1e-3, atol=2e-3).all(-1)
    assert close.mean() >= 0.99, f"only {close.mean():.3f} of paths agree"
    np.testing.assert_allclose(a1.mean(0), a0.mean(0), atol=1e-3)
    assert k0 == k1
    assert i0 == i1


def test_render_queue_multi_spp_queue_matches_jax():
    """A random queue with repeated pixels and S not a multiple of the
    lane count: claims, counts and per-pixel sums follow the JAX loop."""
    W = H = 12
    pix = np.random.default_rng(3).integers(0, W * H, 1000).astype(np.int32)
    (a0, c0, k0, i0) = _jax_queue("sphere_plane", 1, pix, W, H, 5, 96, 6)
    (a1, c1, k1, i1) = _torch_queue("sphere_plane", 1, pix, W, H, 5, 96, 6)
    np.testing.assert_array_equal(c0, c1)
    assert c1.sum() == 1000
    assert np.isclose(a1, a0, rtol=1e-3, atol=2e-3).all(-1).mean() >= 0.99
    assert (k0, i0) == (k1, i1)


def test_render_queue_invariant_to_lane_count():
    """Each path's RNG is keyed by its queue index, so the lane count
    cannot change any path (sums may round differently)."""
    W = H = 16
    pix = np.tile(np.arange(W * H, dtype=np.int32), 3)
    a, ca, ka, _ = _torch_queue("sphere_plane", 1, pix, W, H, 9, 64, 6)
    b, cb, kb, _ = _torch_queue("sphere_plane", 1, pix, W, H, 9, 1024, 6)
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_allclose(a, b, atol=1e-5)
    assert ka == kb


def test_render_queue_bounce_cap_equals_lockstep():
    """max_bounces=1, pix = arange: path i is keyed like render_pixels'
    pixel i, so the queue equals the lockstep render per pixel."""
    scene = tscenes.sphere_plane(device="cpu")
    prep = ttrace.prepare(scene)
    st = RenderSettings(render_type=RenderType.NO_NEE, max_bounces=1)
    cam = Camera.create(*CAMERAS["sphere_plane"], device="cpu")
    W = H = 8
    pix = torch.arange(W * H)
    acc, cnt, _ = tint.render_queue(prep, scene, st, cam, pix, W, H, 3, 32)
    assert (cnt == 1).all()
    col, _ = tint.render_pixels(prep, scene, st, cam, pix % W, pix // W, W, H, 3)
    torch.testing.assert_close(acc, col, atol=1e-6, rtol=0)


def test_render_pixels_matches_jax():
    """The lockstep driver (trace_paths) against the JAX one."""
    W = H = 12
    yy, xx = np.mgrid[0:H, 0:W]
    px, py = xx.ravel().astype(np.int32), yy.ravel().astype(np.int32)
    j = jscenes.sphere_plane()
    ref, _ = jint.render_pixels(jtrace.prepare(j), j, JSettings(max_bounces=6),
                                JCamera.create(*CAMERAS["sphere_plane"]),
                                jnp.asarray(px), jnp.asarray(py), W, H,
                                jnp.uint32(11))
    t = tscenes.sphere_plane(device="cpu")
    out, _ = tint.render_pixels(ttrace.prepare(t), t, RenderSettings(max_bounces=6),
                                Camera.create(*CAMERAS["sphere_plane"], device="cpu"),
                                torch.from_numpy(px), torch.from_numpy(py), W, H, 11)
    close = np.isclose(out.numpy(), np.asarray(ref), rtol=1e-3, atol=2e-3).all(-1)
    assert close.mean() >= 0.99


@pytest.mark.parametrize("kw", [dict(render_type=RenderType.PNEE),
                                dict(edge_aware_nee=True)])
def test_unported_estimators_raise(kw):
    """Edge-aware NEE is a gradient switch: the forward queue refuses it
    (``render_pixels`` takes it, ``tests/test_torch_edges.py``).  PNEE
    without a photon grid renders as plain NEE, in the port as in the
    JAX package."""
    scene = tscenes.sphere_plane(device="cpu")
    cam = Camera.create(*CAMERAS["sphere_plane"], device="cpu")
    if "edge_aware_nee" in kw:
        with pytest.raises(NotImplementedError):
            tint.render_queue(ttrace.prepare(scene), scene, RenderSettings(**kw), cam,
                              torch.arange(4), 2, 2, 0, 4)
        return
    W = H = 12
    pix = np.arange(W * H, dtype=np.int32)
    a0, c0, k0, i0 = _jax_queue("sphere_plane", int(RenderType.PNEE), pix, W, H, 7, 64, 6)
    a1, c1, k1, i1 = _torch_queue("sphere_plane", int(RenderType.PNEE), pix, W, H, 7, 64, 6)
    np.testing.assert_array_equal(c0, c1)
    assert np.isclose(a1, a0, rtol=1e-3, atol=2e-3).all(-1).mean() >= 0.99
    assert (k0, i0) == (k1, i1)
    nee = _torch_queue("sphere_plane", int(RenderType.NORMAL_NEE), pix, W, H, 7, 64, 6)
    np.testing.assert_array_equal(nee[0], a1)


@pytest.mark.parametrize("name", ["sphere_plane", "museum"])
def test_early_exit_leaves_render_pixels_bit_equal(name, monkeypatch, one_thread):
    """``early_exit`` True stops the lockstep loop once no path is alive;
    False runs every bounce to ``max_bounces``.  The bounces past the
    last live path change nothing: radiance, cost and the albedo
    gradient are bit-equal."""
    scene = getattr(tscenes, name)(device="cpu")
    prep = ttrace.prepare(scene)
    cam = Camera.create(*CAMERAS[name], device="cpu")
    W = H = 16
    pix = torch.arange(W * H)
    calls = []
    step = tint._bounce_step
    monkeypatch.setattr(tint, "_bounce_step", lambda *a, **k: calls.append(1) or step(*a, **k))
    out = {}
    for early_exit in (True, False):
        calls.clear()
        st = RenderSettings(max_bounces=16, early_exit=early_exit)
        albedo = scene.albedo.clone().requires_grad_(True)
        col, cost = tint.render_pixels(prep, scene.with_materials(albedo=albedo), st, cam,
                                       pix % W, pix // W, W, H, 5)
        bounces = len(calls)   # the checkpointed backward runs each bounce again
        grad, = torch.autograd.grad(col.sum(), albedo)
        out[early_exit] = (col.detach(), cost, grad, bounces)
    (c0, k0, g0, n0), (c1, k1, g1, n1) = out[True], out[False]
    assert n0 < n1 == 16
    assert torch.equal(c0, c1) and torch.equal(k0, k1) and torch.equal(g0, g1)
    assert float(g0.abs().sum()) > 0
