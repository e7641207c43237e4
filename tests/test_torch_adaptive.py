"""The port's filters, adaptive sampler, debug views and default session
against the JAX package's, on the CPU.

- ``gaussian3`` / ``gaussian5``: allclose at rtol 1e-6 / atol 1e-7 (the
  port sums the taps as shifted slices, XLA as a convolution: the same
  products in another order of addition).
- ``error_field``: allclose at atol 1e-5 (it divides small differences);
  ``target_spp`` equal off the pixels whose ``1 + 32 e`` lies within that
  rounding of a whole number.
- ``pick_pixels``: the pixel lists are equal, in bootstrap and in steady
  state with the sweep position carried from call to call.  The image is
  built so that no weight sits on a rounding edge.
- a session with PNEE + adaptive halves for two ``compute`` calls:
  sample counts equal, radiance by the per-path rule of
  ``test_torch_integrator.py`` on >= 99% of pixels.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from wasm_pathtracer_tpu.config import RenderSettings as JSettings
from wasm_pathtracer_tpu.config import RenderType as JType
from wasm_pathtracer_tpu.models import scenes as jscenes
from wasm_pathtracer_tpu.models.camera import primary_rays as jprimary_rays
from wasm_pathtracer_tpu.ops import accum as jaccum
from wasm_pathtracer_tpu.ops import adaptive as jadaptive
from wasm_pathtracer_tpu.ops import filters as jfilters
from wasm_pathtracer_tpu.ops import integrator as jint
from wasm_pathtracer_tpu.ops import trace as jtrace
from wasm_pathtracer_tpu.runtime.session import Session as JSession
from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models import scenes as tscenes
from wasm_pathtracer_tpu_torch.models.camera import primary_rays
from wasm_pathtracer_tpu_torch.ops import accum, adaptive, filters
from wasm_pathtracer_tpu_torch.ops import integrator as tint
from wasm_pathtracer_tpu_torch.ops import trace as ttrace
from wasm_pathtracer_tpu_torch.runtime import cli
from wasm_pathtracer_tpu_torch.runtime.session import Session


def _image(H=40, W=56, seed=0):
    """A smooth image with a few sharp features: clear error contrast."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = 0.5 + 0.3 * np.sin(xx / 7.0)[..., None] * np.cos(yy / 5.0)[..., None] \
        * np.array([1.0, 0.6, 0.3], np.float32)
    img[10:14, 20:30] = 1.0
    img[25:27, 5:50] = 0.0
    img += r.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.5).astype(np.float32)


def _buffers(img, spp=3.0):
    """JAX and port buffers whose mean image is ``img``."""
    cnt = np.full(img.shape[:2], spp, np.float32)
    return (jaccum.AccumBuffer(acc=jnp.asarray(img * spp), count=jnp.asarray(cnt)),
            accum.AccumBuffer(acc=torch.from_numpy(img * spp), count=torch.from_numpy(cnt)))


@pytest.mark.parametrize("which", ["gaussian3", "gaussian5"])
def test_gaussian_filters_match_jax(which):
    img = _image()
    ref = np.asarray(getattr(jfilters, which)(jnp.asarray(img)))
    out = getattr(filters, which)(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    # a constant image stays constant up to the edge: the renormalisation
    flat = getattr(filters, which)(torch.full((9, 11, 3), 0.7)).numpy()
    np.testing.assert_allclose(flat, 0.7, rtol=1e-6)


def test_error_field_and_target_spp_match_jax():
    jb, tb = _buffers(_image(seed=2))
    e0 = np.asarray(jadaptive.error_field(jb))
    e1 = adaptive.error_field(tb).numpy()
    np.testing.assert_allclose(e1, e0, atol=1e-5)
    assert e1.min() == 0.0 and e1.max() == 1.0 and 0.05 < e1.mean() < 0.5
    s0 = np.asarray(jadaptive.target_spp(jb))
    s1 = adaptive.target_spp(tb).numpy()
    x = 1.0 + 32.0 * e0
    off_edge = np.abs(x - np.round(x)) > 1e-3
    np.testing.assert_array_equal(s1[off_edge], s0[off_edge])
    assert off_edge.mean() > 0.99 and s1.max() == 33.0 and s1.min() == 1.0
    # a degenerate (black) image has no error
    _, flat = _buffers(np.zeros((8, 8, 3), np.float32))
    assert float(adaptive.error_field(flat).abs().max()) == 0.0


def test_mix_color_and_depth_image_match_jax():
    v = np.linspace(-0.2, 1.2, 57).astype(np.float32).reshape(3, 19)
    np.testing.assert_allclose(accum.mix_color(torch.from_numpy(v)).numpy(),
                               np.asarray(jaccum.mix_color(jnp.asarray(v))), atol=1e-7)
    t = np.random.default_rng(1).uniform(0.5, 30, (6, 7)).astype(np.float32)
    t[2, 3] = t[0, 0] = np.inf
    np.testing.assert_allclose(accum.depth_image(torch.from_numpy(t)).numpy(),
                               np.asarray(jaccum.depth_image(jnp.asarray(t))), atol=1e-7)
    np.testing.assert_allclose(accum.depth_image(torch.from_numpy(t), 20.0).numpy(),
                               np.asarray(jaccum.depth_image(jnp.asarray(t), 20.0)),
                               atol=1e-7)


@pytest.mark.parametrize("region", [dict(x0=0, y0=0, width=None, height=None),
                                    dict(x0=28, y0=0, width=28, height=40),
                                    dict(x0=5, y0=3, width=17, height=11)])
def test_pick_pixels_matches_jax(region):
    """Bootstrap, then three steady-state calls that carry the sweep."""
    jb, tb = _buffers(_image(seed=5))
    batch = 700
    sweep_j, sweep_t = None, None
    for k, bootstrap in enumerate([True, True, False, False, False]):
        px0, py0, den0, sweep_j = jadaptive.pick_pixels(
            jb, batch, jnp.uint32(40 + k), bootstrap, 32.0, sweep_pos=sweep_j, **region)
        px1, py1, den1, sweep_t = adaptive.pick_pixels(
            tb, batch, 40 + k, bootstrap, 32.0, sweep_pos=sweep_t, **region)
        np.testing.assert_array_equal(px1.numpy(), np.asarray(px0), err_msg=f"call {k}")
        np.testing.assert_array_equal(py1.numpy(), np.asarray(py0), err_msg=f"call {k}")
        np.testing.assert_allclose(den1.numpy(), np.asarray(den0), atol=1e-5)
        assert int(sweep_t) == int(sweep_j)
        assert isinstance(sweep_t, torch.Tensor) and sweep_t.dtype == torch.int64
        w = region["width"] or 56 - region["x0"]
        h = region["height"] or 40 - region["y0"]
        assert px1.min() >= region["x0"] and px1.max() < region["x0"] + w
        assert py1.min() >= region["y0"] and py1.max() < region["y0"] + h
    assert int(sweep_t) > 0


def test_pick_pixels_floor_covers_region_and_excess_follows_error():
    """Over a run of steady-state batches the sweep visits every pixel,
    and the excess share lands on the high-error pixels."""
    _, tb = _buffers(_image(seed=7))
    hw = 40 * 56
    seen = torch.zeros(hw, dtype=torch.int64)
    sweep = None
    for k in range(12):
        px, py, density, sweep = adaptive.pick_pixels(tb, 2048, k, False, sweep_pos=sweep)
        seen += torch.bincount(py * 56 + px, minlength=hw)
    assert int(seen.min()) >= 1
    hot = density.reshape(-1) > 0.5
    assert seen[hot].float().mean() > 3 * seen[~hot].float().mean()
    # a black image has no excess mass: the whole batch sweeps
    _, flat = _buffers(np.zeros((40, 56, 3), np.float32))
    px, py, _, pos = adaptive.pick_pixels(flat, 300, 1, False)
    np.testing.assert_array_equal((py * 56 + px).numpy(), np.arange(300))
    assert int(pos) == 300                     # round(batch * hw / total) = batch


def test_debug_traces_match_jax():
    """``trace_depth`` and ``trace_bvh_cost`` on the museum's primary rays."""
    j, t = jscenes.museum(), tscenes.museum(device="cpu")
    W = H = 24
    pix = np.arange(W * H)
    half = np.full(W * H, 0.5, np.float32)
    from wasm_pathtracer_tpu.models.camera import initial_camera as jcam
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera as tcam
    o0, d0 = jprimary_rays(jcam(0), jnp.asarray(pix % W), jnp.asarray(pix // W),
                           jnp.asarray(half), jnp.asarray(half), W, H)
    o1, d1 = primary_rays(tcam(0, "cpu"), torch.from_numpy(pix % W), torch.from_numpy(pix // W),
                          torch.from_numpy(half), torch.from_numpy(half), W, H)
    t0, c0 = jint.trace_depth(jtrace.prepare(j), j, o0, d0)
    t1, c1 = tint.trace_depth(ttrace.prepare(t), t, o1, d1)
    np.testing.assert_allclose(t1.numpy(), np.asarray(t0), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(c1.numpy(), np.asarray(c0))
    np.testing.assert_array_equal(
        tint.trace_bvh_cost(ttrace.prepare(t), t, o1, d1).numpy(),
        np.asarray(jint.trace_bvh_cost(jtrace.prepare(j), j, o0, d0)))


def test_session_defaults_are_the_jax_defaults():
    """``Session(w, h, scene)`` with no settings: left NEE with uniform
    sampling, right PNEE with adaptive sampling, each field at the JAX
    package's default."""
    j = JSession(32, 32, scene_id=100)
    t = Session(32, 32, scene_id=100, device="cpu")
    for jh, th in ((j.left, t.left), (j.right, t.right)):
        for f in ("render_type", "adaptive", "max_bounces", "ray_batch_size",
                  "regen_lanes", "total_photons", "photons_per_tick", "photon_grid_res",
                  "photon_world_size", "photon_grid_fit_scene", "adaptive_bootstrap_spp",
                  "adaptive_spp_scale", "is_debug_photons", "epsilon"):
            assert getattr(th.settings, f) == getattr(jh.settings, f), f
    assert t.right.settings.render_type == RenderType.PNEE and t.right.settings.adaptive
    assert t.right.photon_grid is not None and t.left.photon_grid is None
    np.testing.assert_array_equal(t.right.photon_grid.lo.numpy(),
                                  np.asarray(j.right.photon_grid.lo))
    assert t.results(show_sampling=True).shape == (32, 32, 3)
    assert (t.results(show_sampling=True)[..., 2] == 255).all()       # blue baseline


def test_adaptive_pnee_session_matches_jax():
    """Both halves adaptive, the right one PNEE, for two ``compute``
    calls: the first bootstraps, the second allocates by error."""
    kw = dict(max_bounces=4, ray_batch_size=2048, regen_lanes=512, total_photons=4000,
              photon_grid_res=8, adaptive=True, adaptive_bootstrap_spp=2)
    j = JSession(48, 32, scene_id=100, left=JSettings(render_type=JType.NORMAL_NEE, **kw),
                 right=JSettings(render_type=JType.PNEE, **kw))
    t = Session(48, 32, scene_id=100,
                left=RenderSettings(render_type=RenderType.NORMAL_NEE, **kw),
                right=RenderSettings(render_type=RenderType.PNEE, **kw), device="cpu")
    for ticks in (8192, 8192):
        assert j.compute(ticks) == t.compute(ticks) > 0
    assert t.left._rays_traced / (24 * 32) >= 2           # past the bootstrap
    np.testing.assert_array_equal(t.buffer.count.numpy(), np.asarray(j.buffer.count))
    a0, a1 = np.asarray(j.buffer.acc), t.buffer.acc.numpy()
    assert np.isclose(a1, a0, rtol=1e-3, atol=2e-3).all(-1).mean() >= 0.99
    assert int(t.left._sweep) == int(j.left._sweep)
    assert int(t.right._sweep) == int(j.right._sweep)
    assert j.num_bvh_hits == t.num_bvh_hits
    # every pixel sampled, and the density view left its blue baseline
    assert float(t.buffer.count.min()) >= 1
    np.testing.assert_allclose(t.density, j.density, atol=1e-4)
    view = t.results(show_sampling=True)
    assert view.shape == (32, 48, 3) and len(np.unique(view.reshape(-1, 3), axis=0)) > 8


def test_cli_pnee_adaptive_and_debug_views(tmp_path):
    """The CLI's PNEE + adaptive flags, the sampling view and both debug
    views write PNGs that are not black."""
    import struct
    import zlib

    def pixels(path):
        data = path.read_bytes()
        pos, idat = 8, b""
        while pos < len(data):
            n, tag = struct.unpack(">I4s", data[pos:pos + 8])
            if tag == b"IDAT":
                idat += data[pos + 8:pos + 8 + n]
            pos += 12 + n
        return np.frombuffer(zlib.decompress(idat), np.uint8)

    base = ["--scene", "100", "--width", "128", "--height", "128", "--device", "cpu"]
    out = tmp_path / "density.png"
    cli.main(base + ["--ticks", "40000", "--batch", "4096", "--max-bounces", "3",
                     "--right-type", "2", "--right-adaptive", "--show-sampling",
                     "--out", str(out)])
    assert pixels(out).max() > 0
    for view in ("depth", "bvh"):
        out = tmp_path / f"{view}.png"
        cli.main(base + ["--debug-view", view, "--out", str(out)])
        assert pixels(out).max() > 0
    out = tmp_path / "lights.png"
    cli.main(base + ["--ticks", "4096", "--batch", "2048", "--max-bounces", "3",
                     "--light-debug", "--out", str(out)])
    assert pixels(out).max() > 0
