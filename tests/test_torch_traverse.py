"""The port's triangle routes against the JAX package's, on the CPU: the
dense sweep (K8, its plain version against the Pallas kernel in interpret
mode), the 4-wide BVH tables and walk, and ``trace_scene``,
``shadow_ray`` and ``render_queue`` with a ``use_pallas`` prep and with a
BVH prep.

Tolerances: distances rtol/atol 1e-5 (``tests/test_pallas_dense.py``);
slots and shape ids equal except where two candidates tie within that
tolerance; BVH tables, visit counts, sample counts and primitive-test
totals exactly; per-path radiance rtol/atol 2e-5 (``tests/test_wavefront.py``).

The CUDA kernel evaluates the inside test from rows it stages once per
triangle; ``dense_tri_nearest_staged`` is that arithmetic in plain
PyTorch, held here against the plain version and the Pallas kernel under
the rule of ``chip_smoke.py``'s phase ``k8`` (hits agree on > 99.9% of
rays, t within rtol/atol 1e-5, slots on > 99%), with the two exceptions
``STAGED_CASES`` states.

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
                            scene.num_plights, device="cpu")


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
# K8: the arithmetic of the CUDA kernel (rows staged per triangle)
# ---------------------------------------------------------------------------

def _aimed_rays(n, seed, shift=0.0):
    """Rays from in front of the triangle cloud into its volume (a third
    of them hit), everything moved by ``shift`` along each axis."""
    r = np.random.default_rng(seed)
    o = r.uniform(-3, 3, (n, 3))
    o[:, 2] -= 4.0
    d = r.uniform([-2.5, -2.5, 0], [3, 3, 5.5], (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (o + shift).astype(np.float32), d.astype(np.float32)


def _edge_rays(tris, n, seed):
    """Rays from outside a (T, 3, 3) mesh at points of its edges, every
    third one at a vertex: each target lies on two or more triangles."""
    r = np.random.default_rng(seed)
    i, k = r.integers(0, tris.shape[0], n), r.integers(0, 3, n)
    a, b = tris[i, k], tris[i, (k + 1) % 3]
    w = r.random((n, 1))
    w[::3] = 0.0
    target = a * (1 - w) + b * w
    o = target * r.uniform(2.0, 3.0, (n, 1)) + 0.3 * r.normal(size=(n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _cloud_rows():
    return jscenes.triangle_cloud(700, seed=5).reshape(-1, 9).astype(np.float32)


# name -> (rows, rays(n), hit agreement, t tolerance, exact slots):
# - cloud700: phase k8's rule as it stands.
# - mesh_edges: every ray is aimed at a shared edge or vertex of a closed
#   mesh, so two or more triangles hold the hit point at the same t and
#   rounding picks among them (the plain version and the Pallas kernel
#   agree on only ~60% of these slots themselves).  A differing slot must
#   be such a tie: the plain version's own distance to it equals its t.
# - translated_1e3: the same cloud and rays moved by 1e3, where the
#   staged offsets k_i = slack - a_i . m_i cancel.  A coordinate's ulp is
#   6.1e-5 there, three times the 2e-5 edge slack, so a hit point within
#   ~1e-4 of an edge may fall on either side: up to 0.5% of rays may flip
#   (1 of 4,096 does).  t = (n.v0 - n.o) / n.d cancels two terms of size
#   1e3 |n| in every version (the plain version and the Pallas kernel
#   differ by 3e-4 from each other), so t is held to 2e-3, 32 ulp of a
#   coordinate.
STAGED_CASES = {
    "cloud700": (_cloud_rows, lambda n: _aimed_rays(n, 1), 0.999, TOL, True),
    "mesh_edges": (lambda: jscenes.surface_mesh(14).reshape(-1, 9).astype(np.float32),
                   lambda n: _edge_rays(jscenes.surface_mesh(14), n, 3), 0.999, TOL, False),
    "translated_1e3": (lambda: _cloud_rows() + np.float32(1e3),
                       lambda n: _aimed_rays(n, 1, 1e3), 0.995, 2e-3, True),
}


def _assert_sweeps_agree(rows, o, d, got, ref, hit_rate, tol, exact_slots):
    (t1, s1), (t0, s0) = got, ref
    h1, h0 = np.isfinite(t1), np.isfinite(t0)
    both = h1 & h0
    assert (h1 == h0).mean() > hit_rate
    np.testing.assert_allclose(t1[both], t0[both], rtol=tol if tol == TOL else 0, atol=tol)
    assert (s1[~h1] == -1).all()
    assert both.sum() > 60
    differ = np.nonzero(both & (s1 != s0))[0]
    if exact_slots:
        assert differ.size < 0.01 * both.sum()
        return
    # a differing slot is a tie: the plain version's distance to it is t
    rows, o, d = (torch.from_numpy(x) for x in (rows, o, d))
    own = tk._chunk_distances(rows[s1[differ]], o[differ], d[differ]).numpy()
    np.testing.assert_allclose(np.diagonal(own), t0[differ], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", list(STAGED_CASES))
def test_dense_sweep_staged_matches_plain(case):
    make_rows, make_rays, hit_rate, tol, exact = STAGED_CASES[case]
    rows = make_rows()
    o, d = make_rays(4096)
    args = [torch.from_numpy(x) for x in (rows, o, d)]
    got = [x.numpy() for x in tk.dense_tri_nearest_staged(*args)]
    ref = [x.numpy() for x in tk.dense_tri_nearest_reference(*args)]
    assert got[1].dtype == np.int32
    _assert_sweeps_agree(rows, o, d, got, ref, hit_rate, tol, exact)


@pytest.mark.parametrize("case", list(STAGED_CASES))
def test_dense_sweep_staged_matches_pallas_interpret(case):
    make_rows, make_rays, hit_rate, tol, exact = STAGED_CASES[case]
    rows = make_rows()
    o, d = make_rays(jtp.RAY_BLOCK)
    with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
        ref = jtp.dense_tri_nearest(jtp.pad_tris(jnp.asarray(rows)),
                                    *jtp.pad_rays(jnp.asarray(o), jnp.asarray(d)))
    ref = [np.asarray(x)[: o.shape[0]] for x in ref]
    got = [x.numpy() for x in tk.dense_tri_nearest_staged(
        *(torch.from_numpy(x) for x in (rows, o, d)))]
    _assert_sweeps_agree(rows, o, d, got, ref, hit_rate, tol, exact)


def test_staged_rows_are_the_triple_product_form():
    """(e_i x (p - a_i)) . n / |n| + slack == p . m_i + k_i, held in
    float64 against the float32 rows, and the plane columns."""
    rows = torch.from_numpy(_cloud_rows())
    staged = tk.staged_rows(rows)
    assert staged.shape == (700, 16) and staged.dtype == torch.float32
    v = rows.double().view(-1, 3, 3)
    n = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    np.testing.assert_allclose(staged[:, 0:3].numpy(), n.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(staged[:, 3].numpy(), (n * v[:, 0]).sum(-1).numpy(),
                               rtol=1e-5, atol=1e-5)
    p = torch.from_numpy(np.random.default_rng(0).uniform(-3, 5, (700, 3)))
    for i in range(3):
        a, e = v[:, i], v[:, (i + 1) % 3] - v[:, i]
        want = (torch.linalg.cross(e, p - a) * n).sum(-1) / n.norm(dim=-1) + 2e-5
        m, k = staged[:, 4 + 4 * i:7 + 4 * i].double(), staged[:, 7 + 4 * i].double()
        np.testing.assert_allclose(((p * m).sum(-1) + k).numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_dense_sweep_staged_edge_cases():
    """No triangles and a degenerate (all-zero) triangle miss; any
    chunking keeps the first minimum among duplicated triangles."""
    o, d = (torch.from_numpy(x) for x in _aimed_rays(1500, 2))
    t, s = tk.dense_tri_nearest_staged(torch.zeros((0, 9)), o, d)
    assert torch.isinf(t).all() and (s == -1).all()
    t, s = tk.dense_tri_nearest_staged(torch.zeros((3, 9)), o, d)
    assert torch.isinf(t).all() and (s == -1).all()
    rows = torch.from_numpy(_cloud_rows()[:90])
    rows = torch.cat([rows, rows[:40]])                  # slots 90.. repeat 0..
    ref = tk.dense_tri_nearest_staged(rows, o, d, chunk=130)
    for chunk in (1, 7, 64):
        out = tk.dense_tri_nearest_staged(rows, o, d, chunk=chunk)
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert int(ref[1].max()) < 90 and int((ref[1] >= 0).sum()) > 20


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
        Camera.create(*CAMERA, device="cpu"), torch.from_numpy(pix), W, H, 5, 64, return_iters=True)
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
# the kernel tiles 4 rays a thread x 128 threads and 256 triangles: a
# ragged ray count, three rays, and fewer triangles than one tile
@pytest.mark.parametrize("n_tri,n_rays", [(700, 256), (5000, 4096 + 37), (5000, 3),
                                          (100, 4096 + 37)])
def test_cuda_sweep_matches_plain_on_gpu(cuda_device, n_tri, n_rays):
    rows = torch.from_numpy(jscenes.triangle_cloud(n_tri, seed=5).reshape(-1, 9)
                            .astype(np.float32)).to(cuda_device)
    # a handful of rays is aimed into the cloud, so that some hit
    make_rays = _aimed_rays if n_rays < 64 else _rays
    o, d = (torch.from_numpy(x).to(cuda_device) for x in make_rays(n_rays, 1))
    t_k, s_k = tk.dense_tri_nearest(rows, o, d)
    t_p, s_p = tk.dense_tri_nearest_reference(rows, o, d)
    hit = torch.isfinite(t_p)
    assert (torch.isfinite(t_k) == hit).float().mean() > 0.999
    both = hit & torch.isfinite(t_k)
    assert both.any()
    # random rays graze some triangles: t divides by a small n.d, which
    # amplifies the FMA rounding of the kernel against the plain version
    assert torch.isclose(t_k[both], t_p[both], rtol=TOL, atol=TOL).float().mean() > 0.999
    torch.testing.assert_close(t_k[both], t_p[both], rtol=1e-4, atol=1e-4)
    assert (s_k == s_p)[both].float().mean() > 0.99
    assert (s_k[~torch.isfinite(t_k)] == -1).all()
