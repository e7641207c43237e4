"""The port's triangle routes against the JAX package's, on the CPU: the
dense sweep (K8, its plain version against the Pallas kernel in interpret
mode), the 4-wide BVH tables and walk, and ``trace_scene``,
``shadow_ray`` and ``render_queue`` with a ``use_pallas`` prep and with a
BVH prep.

Tolerances: distances rtol/atol 1e-5 (``tests/test_pallas_dense.py``);
slots and shape ids equal except where two candidates tie within that
tolerance; BVH tables, visit counts, sample counts and primitive-test
totals exactly; per-path radiance rtol/atol 2e-5 (``tests/test_wavefront.py``).

The CUDA kernel runs only on a GPU; ``test_cuda_sweep_matches_plain_on_gpu``
holds it against its plain version there (t within 1e-5 on > 99.9% of the
hits, within 1e-4 on all) and skips here.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from wasm_pathtracer_tpu.config import RenderSettings as JSettings
from wasm_pathtracer_tpu.config import RenderType as JType
from wasm_pathtracer_tpu.models import scenes as jscenes
from wasm_pathtracer_tpu.models.camera import Camera as JCamera
from wasm_pathtracer_tpu.ops import bvh as jbvh
from wasm_pathtracer_tpu.ops import bvh_native as jnative
from wasm_pathtracer_tpu.ops import integrator as jint
from wasm_pathtracer_tpu.ops import trace as jtrace
from wasm_pathtracer_tpu.ops import traverse as jtraverse
from wasm_pathtracer_tpu.ops import traverse_pallas as jtp
from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models.camera import Camera
from wasm_pathtracer_tpu_torch.models.scene import TENSOR_FIELDS, scene_from_numpy
from wasm_pathtracer_tpu_torch.ops import bvh as tbvh
from wasm_pathtracer_tpu_torch.ops import bvh_native as tnative
from wasm_pathtracer_tpu_torch.ops import integrator as tint
from wasm_pathtracer_tpu_torch.ops import trace as ttrace
from wasm_pathtracer_tpu_torch.ops import traverse as ttraverse
from wasm_pathtracer_tpu_torch.ops import traverse_kernels as tk

TOL = 1e-5
CAMERA = ((0.0, 1.0, -6.0), 0.1, 0.0)
BVH_FIELDS = ("bvh_bounds", "bvh_children", "bvh_prim_index", "bvh_tri_rows")


def _rays(n, seed=0, spread=3.0):
    r = np.random.default_rng(seed)
    o = r.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _to_torch(scene):
    return scene_from_numpy({k: np.asarray(getattr(scene, k)) for k in TENSOR_FIELDS},
                            scene.num_inf, scene.num_shapes, scene.num_lights,
                            scene.num_plights)


def _mesh_scene(n=10):
    """Ground plane, a deformed-sphere mesh of 2 n (n - 1) triangles and a
    two-triangle light."""
    return jscenes.mesh_scene(jscenes.surface_mesh(n))


def _preps(j, kind):
    """(JAX prep, port prep) of ``kind``: "sweep" (use_pallas) or "bvh"."""
    t = _to_torch(j)
    if kind == "sweep":
        return t, jtrace.prepare(j, use_pallas=True), ttrace.prepare(t, use_pallas=True)
    return (t, jbvh.attach_bvh(jtrace.prepare(j), j),
            tbvh.attach_bvh(ttrace.prepare(t), t))


# ---------------------------------------------------------------------------
# K8: the dense sweep
# ---------------------------------------------------------------------------

def test_dense_sweep_plain_matches_pallas_interpret():
    rows = jscenes.triangle_cloud(700, seed=5).reshape(-1, 9).astype(np.float32)
    o, d = _rays(jtp.RAY_BLOCK)
    with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
        t0, s0 = jtp.dense_tri_nearest(jtp.pad_tris(jnp.asarray(rows)),
                                       *jtp.pad_rays(jnp.asarray(o), jnp.asarray(d)))
    t0, s0 = np.asarray(t0)[: o.shape[0]], np.asarray(s0)[: o.shape[0]]
    t1, s1 = (x.numpy() for x in tk.dense_tri_nearest(
        torch.from_numpy(rows), torch.from_numpy(o), torch.from_numpy(d)))
    hit = np.isfinite(t0)
    np.testing.assert_array_equal(np.isfinite(t1), hit)
    np.testing.assert_allclose(t1[hit], t0[hit], rtol=TOL, atol=TOL)
    assert (s1[~hit] == -1).all() and s1.dtype == np.int32
    assert (s1[hit] == s0[hit]).mean() > 0.99
    assert hit.sum() > 20


@pytest.mark.parametrize("chunk", [1, 7, 64, 4096])
def test_dense_sweep_plain_chunking_keeps_first_minimum(chunk):
    """Any chunking gives the lexicographic (t, slot) minimum: duplicated
    triangles tie exactly, and the lower slot must win."""
    rows = jscenes.triangle_cloud(90, seed=2).reshape(-1, 9).astype(np.float32)
    rows = torch.from_numpy(np.concatenate([rows, rows[:40]]))      # slots 90.. repeat 0..
    o, d = _rays(600, seed=4)
    d = np.random.default_rng(0).uniform([-2.5, -2.5, 0], [2.5, 2.5, 5], (600, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t_ref, s_ref = tk.dense_tri_nearest_reference(rows, o, d, chunk=130)
    t, s = tk.dense_tri_nearest_reference(rows, o, d, chunk=chunk)
    assert torch.equal(t, t_ref) and torch.equal(s, s_ref)
    assert int(s.max()) < 90 and int((s >= 0).sum()) > 30


def test_dense_sweep_edge_cases():
    """No triangles, no rays, and a degenerate (all-zero) triangle miss."""
    o, d = (torch.from_numpy(x) for x in _rays(5))
    t, s = tk.dense_tri_nearest(torch.zeros((0, 9)), o, d)
    assert torch.isinf(t).all() and (s == -1).all()
    t, s = tk.dense_tri_nearest(torch.zeros((3, 9)), o, d)
    assert torch.isinf(t).all() and (s == -1).all()
    t, s = tk.dense_tri_nearest(torch.zeros((3, 9)), o[:0], d[:0])
    assert t.shape == (0,) and s.shape == (0,)


def test_dense_sweep_rejects_non_cuda_device():
    """The wrapper never falls back to its plain version off the CPU."""
    o, d = (torch.from_numpy(x).to("meta") for x in _rays(8))
    with pytest.raises(ValueError):
        tk.dense_tri_nearest(torch.zeros((4, 9), device="meta"), o, d)


# ---------------------------------------------------------------------------
# The 4-wide BVH: tables and walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("build", ["native", "numpy"])
def test_attach_bvh_tables_match_jax(build, monkeypatch):
    if build == "numpy":
        def fail(*a, **k):
            raise RuntimeError("native build disabled")
        monkeypatch.setattr(jnative, "build", fail)
        monkeypatch.setattr(tnative, "build", fail)
    j = _mesh_scene(9)
    _, pj, pt = _preps(j, "bvh")
    assert pt.has_bvh and not pt.use_pallas
    for k in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(pt, k).numpy(), np.asarray(getattr(pj, k)),
                                      err_msg=k)
    # the triangles left the scene kernels' tables, and only they
    assert pt.tables.counts[2] == 0 and pt.idx_triangle.shape[0] == pj.idx_triangle.shape[0]


def test_bvh4_collapse_matches_jax_and_verifies():
    """DP and greedy collapses equal the JAX package's; the port's build
    passes its own structural verifier."""
    tris = jscenes.triangle_cloud(300, seed=9)
    lo, hi = tris.min(1) - 2e-5, tris.max(1) + 2e-5
    nj, oj = jbvh.build_bvh2(lo, hi)
    nt, ot = tbvh.build_bvh2(lo, hi)
    np.testing.assert_array_equal(ot, oj)
    for fj, ft in ((jbvh.collapse_bvh4, tbvh.collapse_bvh4),
                   (jbvh.collapse_bvh4_greedy, tbvh.collapse_bvh4_greedy)):
        (b0, c0), (b1, c1) = fj(nj), ft(nt)
        np.testing.assert_array_equal(b1, b0)
        np.testing.assert_array_equal(c1, c0)
    b, c, order = tbvh.build(lo, hi)
    assert tbvh.verify(b, c, order, lo, hi)
    assert tbvh.node_count(c) == c.shape[0] > 10
    assert tbvh.depth(b, c) == jbvh.depth(b, c) > 2
    assert tbvh.decode_leaf(tbvh.encode_leaf(37, 3)) == (37, 3)
    bad = c.copy()
    bad[bad < -1] = tbvh.encode_leaf(0, 1)          # every leaf -> triangle 0
    assert not tbvh.verify(b, bad, order, lo, hi)


def test_trace_bvh4_matches_jax():
    tris = jscenes.triangle_cloud(800, seed=3).astype(np.float32)
    lo, hi = tris.min(1) - np.float32(2e-5), tris.max(1) + np.float32(2e-5)
    bounds, child, order = jbvh.build(lo, hi)
    rows = tris.reshape(-1, 9)[order]
    prim = (order + 100).astype(np.int32)
    o, d = _rays(384, seed=6)
    t_init = np.full(384, np.inf, np.float32)
    t_init[::3] = 4.0                                  # a third start pruned
    t0, s0, v0 = (np.asarray(x) for x in jtraverse.trace_bvh4(
        jnp.asarray(bounds), jnp.asarray(child), jnp.asarray(prim), jnp.asarray(rows),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_init)))
    t1, s1, v1 = (x.numpy() for x in ttraverse.trace_bvh4(
        torch.from_numpy(bounds), torch.from_numpy(child.astype(np.int64)),
        torch.from_numpy(prim.astype(np.int64)), torch.from_numpy(rows),
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_init)))
    np.testing.assert_allclose(t1, t0, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(v1, v0)
    assert (s1 == s0).all()
    assert (s1 >= 0).sum() > 30 and v1.max() > 5 and v1.mean() < 200


# ---------------------------------------------------------------------------
# trace_scene, shadow_ray and render_queue with each prep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["sweep", "bvh"])
def test_trace_scene_and_shadow_ray_match_jax(kind):
    j = _mesh_scene(10)
    t, pj, pt = _preps(j, kind)
    o, d = _rays(256, seed=8, spread=4.0)
    d[:128] = -o[:128] / np.linalg.norm(o[:128], axis=-1, keepdims=True)   # at the mesh
    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(x) for x in jtrace.trace_scene(pj, j, jnp.asarray(o),
                                                         jnp.asarray(d))]
    out = [x.numpy() for x in ttrace.trace_scene(pt, t, torch.from_numpy(o),
                                                 torch.from_numpy(d))]
    np.testing.assert_array_equal(out[2], ref[2])
    hit = ref[2]
    np.testing.assert_allclose(out[0][hit], ref[0][hit], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_array_equal(out[3], ref[3])
    tri_hits = (np.asarray(j.ptype)[out[1][hit]] == 2).sum()
    assert tri_hits > 30 and (~hit).sum() > 5

    # shadow rays from the hit points to points on the light
    r = np.random.default_rng(1)
    p = (o + d * np.where(hit, out[0], 1.0)[:, None] * 0.999)[hit].astype(np.float32)
    lights = np.asarray(j.light_shape)
    lsid = lights[r.integers(0, lights.size, p.shape[0])].astype(np.int32)
    lv = np.asarray(j.params)[lsid].reshape(-1, 3, 3)
    w = r.dirichlet(np.ones(3), p.shape[0]).astype(np.float32)
    pl = (lv * w[:, :, None]).sum(1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        occ0, c0 = (np.asarray(x) for x in jtrace.shadow_ray(
            pj, j, jnp.asarray(p), jnp.asarray(pl), jnp.asarray(lsid)))
    occ1, c1 = (x.numpy() for x in ttrace.shadow_ray(
        pt, t, torch.from_numpy(p), torch.from_numpy(pl), torch.from_numpy(lsid).long()))
    np.testing.assert_array_equal(occ1, occ0)
    np.testing.assert_array_equal(c1, c0)
    assert 0 < occ1.sum() < occ1.size


@pytest.mark.parametrize("kind", ["sweep", "bvh"])
def test_render_queue_matches_jax_per_path(kind):
    j = _mesh_scene(8)
    t, pj, pt = _preps(j, kind)
    W = H = 12
    pix = np.arange(W * H, dtype=np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = jint.render_queue(
            pj, j, JSettings(render_type=JType.NORMAL_NEE, max_bounces=4),
            JCamera.create(*CAMERA), jnp.asarray(pix), W, H, jnp.uint32(5), 64,
            return_iters=True)
    a0, c0, k0 = (np.asarray(x) for x in ref[:3])
    a1, c1, k1, i1 = tint.render_queue(
        pt, t, RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=4),
        Camera.create(*CAMERA), torch.from_numpy(pix), W, H, 5, 64, return_iters=True)
    np.testing.assert_array_equal(c1.numpy(), c0)
    assert (c0 == 1).all() and i1 == int(ref[3])
    np.testing.assert_array_equal(k1.numpy(), k0.astype(np.int64))
    np.testing.assert_allclose(a1.numpy(), a0, rtol=2e-5, atol=2e-5)
    assert a1.sum() > 0


def test_bvh_from_numpy_carries_the_jax_tables():
    """A port prep built from the JAX prep's arrays walks the same nodes."""
    j = _mesh_scene(7)
    pj = jbvh.attach_bvh(jtrace.prepare(j), j)
    t = _to_torch(j)
    pt = ttrace.bvh_from_numpy(ttrace.prepare(t), t,
                               {k: np.asarray(getattr(pj, k)) for k in BVH_FIELDS})
    ref = tbvh.attach_bvh(ttrace.prepare(t), t)
    for k in BVH_FIELDS:
        assert torch.equal(getattr(pt, k), getattr(ref, k)), k
    assert pt.bvh_children.dtype == torch.int64 and pt.has_bvh


def test_use_pallas_wins_over_bvh_and_shadow_takes_trace():
    """``attach_bvh(..., use_pallas=True)`` sweeps: the cost is the
    triangle count, not the visits."""
    j = _mesh_scene(7)
    t = _to_torch(j)
    prep = tbvh.attach_bvh(ttrace.prepare(t), t, use_pallas=True)
    assert prep.use_pallas and prep.has_bvh
    o, d = (torch.from_numpy(x) for x in _rays(16, seed=2))
    _, _, _, cost = ttrace.trace_scene(prep, t, o, d)
    n_other = sum(prep.tables.counts)
    assert (cost == n_other + prep.idx_triangle.shape[0]).all()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n_tri,n_rays", [(700, 256), (5000, 4096 + 37)])
def test_cuda_sweep_matches_plain_on_gpu(cuda_device, n_tri, n_rays):
    rows = torch.from_numpy(jscenes.triangle_cloud(n_tri, seed=5).reshape(-1, 9)
                            .astype(np.float32)).to(cuda_device)
    o, d = (torch.from_numpy(x).to(cuda_device) for x in _rays(n_rays, seed=1))
    t_k, s_k = tk.dense_tri_nearest(rows, o, d)
    t_p, s_p = tk.dense_tri_nearest_reference(rows, o, d)
    hit = torch.isfinite(t_p)
    assert (torch.isfinite(t_k) == hit).float().mean() > 0.999
    both = hit & torch.isfinite(t_k)
    # random rays graze some triangles: t divides by a small n.d, which
    # amplifies the FMA rounding of the kernel against the plain version
    assert torch.isclose(t_k[both], t_p[both], rtol=TOL, atol=TOL).float().mean() > 0.999
    torch.testing.assert_close(t_k[both], t_p[both], rtol=1e-4, atol=1e-4)
    assert (s_k == s_p)[both].float().mean() > 0.99
    assert (s_k[~torch.isfinite(t_k)] == -1).all()
