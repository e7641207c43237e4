"""The port's flattened wavefront (``ops.wavefront.render_queue_flat``)
against the JAX package's, on the CPU: JAX through its XLA select,
probe and dense trace, the port through its kernels' plain versions.

Both key path ``i``'s random stream by its queue index, so with
``pix = arange`` and one path per pixel each pixel's sum is one path's
radiance.  Sample counts, each lane's primitive-test cost and the loop's
iteration count must match exactly, and per-path radiance is allclose
(rtol 2e-5, atol 2e-5), the tolerance of ``tests/test_wavefront.py``.

Triangle scenes hold the port to JAX's jitted loop.  Where spheres or
tori are traced, XLA's fusion inside ``jit`` rounds their quadratics and
the torus march differently from the same operations run one by one (it
contracts to FMA): a bounce leaves in a direction a few ulp away, paths
drift past 2e-5 and a probe decision at a rounding tie can flip, so
JAX's jitted loop differs from its own op-by-op run.  Those cases hold
the port to the op-by-op run (``jax.disable_jit()``), which it follows
to the last few ulp.
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
from wasm_pathtracer_tpu.models.scene import Material as JMaterial
from wasm_pathtracer_tpu.models.scene import SceneBuilder as JBuilder
from wasm_pathtracer_tpu.ops import bvh as jbvh
from wasm_pathtracer_tpu.ops import trace as jtrace
from wasm_pathtracer_tpu.ops import wavefront as jwave
from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models import scenes as tscenes
from wasm_pathtracer_tpu_torch.models.camera import Camera
from wasm_pathtracer_tpu_torch.models.scene import TENSOR_FIELDS, scene_from_numpy
from wasm_pathtracer_tpu_torch.ops import bvh as tbvh
from wasm_pathtracer_tpu_torch.ops import integrator as tint
from wasm_pathtracer_tpu_torch.ops import trace as ttrace
from wasm_pathtracer_tpu_torch.ops import wavefront as twave

CLOUD_CAMERA = ((0.0, 0.5, -2.0), 0.15, 0.0)
MUSEUM_CAMERA = ((0.0, 16.34, -23.76), 0.54, 0.0)


def _cloud_scene(n_tri=300, n_sphere=0, seed=3):
    """``tests/test_wavefront.py``'s procedural scene."""
    r = np.random.default_rng(seed)
    b = JBuilder(background=(0.05, 0.05, 0.1))
    b.add_plane((0.0, -3.0, 0.0), (0.0, 1.0, 0.0), JMaterial.diffuse(0.8, 0.8, 0.8))
    if n_tri:
        centers = r.uniform(-2.0, 2.0, size=(n_tri, 1, 3))
        offs = r.uniform(-0.35, 0.35, size=(n_tri, 3, 3))
        tris = (centers + offs + np.array([0.0, 0.0, 6.0])).astype(np.float32)
        b.add_triangles(tris, JMaterial.diffuse(0.7, 0.4, 0.3))
    for _ in range(n_sphere):
        c = r.uniform(-2.0, 2.0, size=3) + np.array([0.0, 0.0, 6.0])
        b.add_sphere(tuple(c), float(r.uniform(0.05, 0.25)),
                     JMaterial.diffuse(0.3, 0.5, 0.7))
    light = JMaterial.emissive(10.0, 10.0, 10.0)
    b.add_triangle((1.5, 6.0, 7.5), (1.5, 6.0, 4.5), (-1.5, 6.0, 4.5), light)
    b.add_triangle((-1.5, 6.0, 7.5), (1.5, 6.0, 7.5), (-1.5, 6.0, 4.5), light)
    return b.build()


def _to_torch(scene):
    return scene_from_numpy({k: np.asarray(getattr(scene, k)) for k in TENSOR_FIELDS},
                            scene.num_inf, scene.num_shapes, scene.num_lights,
                            scene.num_plights, device="cpu")


CLOUD = dict(group=64, min_count=64)


def _render_both(j, kw, rt, max_bounces, pix, W, H, lanes, camera=CLOUD_CAMERA,
                 seed=5, eager=False):
    """JAX's flat loop (op by op with ``eager``) and the port's on the
    same scene, clustered with the same ``attach_clusters`` keywords.
    Returns ((acc, cnt, cost, iters) JAX, the same for the port)."""
    t = _to_torch(j)
    pj = jbvh.attach_clusters(jtrace.prepare(j), j, **kw)
    pt = tbvh.attach_clusters(ttrace.prepare(t), t, **kw)
    assert pj.cluster is not None and pt.cluster is not None
    with jax.disable_jit(eager):
        ref = jwave.render_queue_flat(
            pj, j, JSettings(render_type=JType(rt), max_bounces=max_bounces),
            JCamera.create(*camera), jnp.asarray(pix), W, H, jnp.uint32(seed), lanes,
            return_iters=True)
    out = twave.render_queue_flat(
        pt, t, RenderSettings(render_type=RenderType(rt), max_bounces=max_bounces),
        Camera.create(*camera, device="cpu"), torch.from_numpy(pix), W, H, seed, lanes,
        return_iters=True)
    return (tuple(np.asarray(x) for x in ref[:3]) + (int(ref[3]),),
            tuple(x.numpy() for x in out[:3]) + (out[3],))


def _assert_exact_counts(ref, out):
    (a0, c0, k0, i0), (a1, c1, k1, i1) = ref, out
    np.testing.assert_array_equal(c1, c0)
    np.testing.assert_array_equal(k1, k0.astype(np.int64))
    assert i1 == i0
    assert a1.sum() > 0


def _assert_paths_close(ref, out):
    np.testing.assert_allclose(out[0], ref[0], rtol=2e-5, atol=2e-5)


# the op-by-op JAX loop costs per iteration: its cases take one wave of
# lanes
@pytest.mark.parametrize("name,n_tri,n_sphere,rt,W,lanes", [
    ("triangle_cloud", 300, 0, 1, 32, 128),
    ("multi_family", 150, 150, 1, 16, 256),
    ("no_nee", 200, 0, 0, 32, 128)])
def test_flat_matches_jax(name, n_tri, n_sphere, rt, W, lanes):
    pix = np.arange(W * W, dtype=np.int32)
    ref, out = _render_both(_cloud_scene(n_tri, n_sphere), CLOUD, rt, 4, pix, W, W, lanes,
                            eager=n_sphere > 0)
    _assert_exact_counts(ref, out)
    assert (out[1] == 1).all()
    _assert_paths_close(ref, out)


def test_flat_matches_jax_museum_lights_dense():
    """The museum with tori and aarects in one mixed cluster and its 108
    light triangles and the plane dense: the remainder is larger than
    the select kernel's scan takes, so the port runs the select beside
    the scene kernel (K6 + K1)."""
    W = H = 16
    pix = np.arange(W * H, dtype=np.int32)
    ref, out = _render_both(jscenes.museum(), dict(min_count=1, exclude_lights=True), 1, 4,
                            pix, W, H, 256, camera=MUSEUM_CAMERA, eager=True)
    _assert_exact_counts(ref, out)
    _assert_paths_close(ref, out)


def test_flat_queue_shorter_than_lanes():
    """S < B: the idle lanes never claim; counts and cost still exact."""
    W = H = 16
    pix = np.random.default_rng(2).permutation(W * H)[:100].astype(np.int32)
    ref, out = _render_both(_cloud_scene(120), CLOUD, 1, 4, pix, W, H, 256)
    _assert_exact_counts(ref, out)
    assert out[1].sum() == 100
    _assert_paths_close(ref, out)


@pytest.mark.parametrize("route", ["queue", "flat"])
def test_queue_empty_and_zero_bounce(route):
    """The edge cases of the one queue loop, on either route: an empty
    queue renders nothing in no iteration; a zero bounce cap advances the
    counts, leaves the radiance black and does no work.  The flat route
    refuses a prep without clusters."""
    if route == "flat":
        t = _to_torch(_cloud_scene(n_tri=100))
        prep = tbvh.attach_clusters(ttrace.prepare(t), t, **CLOUD)
        cam = Camera.create(*CLOUD_CAMERA, device="cpu")
        st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=4)
        fn, W, seed, lanes = twave.render_queue_flat, 16, 1, 64
    else:
        t = tscenes.sphere_plane(device="cpu")
        prep = ttrace.prepare(t)
        cam = Camera.create((0.0, 1.5, -2.0), 0.25, 0.0, device="cpu")
        st = RenderSettings(render_type=RenderType.NO_NEE, max_bounces=4)
        fn, W, seed, lanes = tint.render_queue, 8, 3, 32
    H = W
    a, c, k, its = fn(prep, t, st, cam, torch.zeros(0, dtype=torch.int64), W, H, seed, lanes,
                      return_iters=True)
    assert float(a.abs().sum()) == 0.0 and int(c.sum()) == 0 and its == 0
    assert a.shape == (W * H, 3) and k.shape == (lanes,)
    a, c, k = fn(prep, t, st.replace(max_bounces=0), cam, torch.arange(W * H), W, H, seed,
                 lanes)
    assert float(a.abs().sum()) == 0.0 and (c == 1).all() and int(k.sum()) == 0
    if route == "flat":
        with pytest.raises(ValueError):
            fn(ttrace.prepare(t), t, st, cam, torch.arange(4), W, H, 1, 4)


def test_flat_lane_count_independent():
    """Per-path radiance depends on the queue slot only, not on the
    wavefront width (``tests/test_wavefront.py``'s tolerance)."""
    j = _cloud_scene(n_tri=300)
    t = _to_torch(j)
    prep = tbvh.attach_clusters(ttrace.prepare(t), t, **CLOUD)
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=3)
    W = H = 32
    outs = [twave.render_queue_flat(prep, t, st, Camera.create(*CLOUD_CAMERA, device="cpu"),
                                    torch.arange(W * H), W, H, 9, lanes)
            for lanes in (64, 256)]
    (a64, c64, _), (a256, c256, _) = outs
    assert torch.equal(c64, c256)
    np.testing.assert_allclose(a256.numpy(), a64.numpy(), rtol=3e-7, atol=3e-7)


def test_flat_equals_port_render_queue():
    """The flat loop visits clusters in the lockstep trace's order with
    the same bounds, so on the port's own kernels it reproduces
    ``render_queue`` over the same cluster prep path for path, with a
    repeated-pixel queue."""
    j = _cloud_scene(n_tri=150, n_sphere=60)
    t = _to_torch(j)
    prep = tbvh.attach_clusters(ttrace.prepare(t), t, **CLOUD)
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=4)
    W = H = 16
    pix = torch.from_numpy(np.random.default_rng(4).integers(0, W * H, 700))
    cam = Camera.create(*CLOUD_CAMERA, device="cpu")
    a0, c0, _ = tint.render_queue(prep, t, st, cam, pix, W, H, 3, 96)
    a1, c1, _ = twave.render_queue_flat(prep, t, st, cam, pix, W, H, 3, 96)
    assert torch.equal(c0, c1) and int(c1.sum()) == 700
    np.testing.assert_allclose(a1.numpy(), a0.numpy(), rtol=1e-6, atol=1e-6)
