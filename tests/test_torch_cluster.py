"""The port's BVH leaf order and cluster structure against the JAX
package's, on the CPU.

With the same builder (the native C++ one, or the NumPy one both
packages fall back to) the leaf order is identical, so every cluster
table is identical bit for bit.  The lockstep cluster trace then agrees
with JAX's: t within rtol 1e-5 / atol 1e-5 on triangles, and within the
rtol 1e-4 / atol 1e-4 of the JAX package's own mixed-family cluster test
(``tests/test_cluster.py``) where spheres and tori take part (XLA on the
CPU contracts the sphere quadratic to FMA, torch does not; grazing rays
cancel); shape ids equal except where the two candidates' distances tie
within that tolerance; probe rounds exact.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from wasm_pathtracer_tpu.models import scenes as jscenes
from wasm_pathtracer_tpu.models.scene import Material as JMaterial
from wasm_pathtracer_tpu.models.scene import SceneBuilder as JBuilder
from wasm_pathtracer_tpu.ops import bvh as jbvh
from wasm_pathtracer_tpu.ops import bvh_native as jbvh_native
from wasm_pathtracer_tpu.ops import cluster as jcl
from wasm_pathtracer_tpu.ops import trace as jtrace
from wasm_pathtracer_tpu_torch.models.scene import TENSOR_FIELDS, scene_from_numpy
from wasm_pathtracer_tpu_torch.ops import bvh as tbvh
from wasm_pathtracer_tpu_torch.ops import bvh_native as tbvh_native
from wasm_pathtracer_tpu_torch.ops import cluster as tcl
from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
from wasm_pathtracer_tpu_torch.ops import trace as ttrace


def _to_torch(scene):
    return scene_from_numpy({k: np.asarray(getattr(scene, k)) for k in TENSOR_FIELDS},
                            scene.num_inf, scene.num_shapes, scene.num_lights,
                            scene.num_plights, device="cpu")


def _cloud(n=600, seed=3):
    """Triangles over a plane with a two-triangle light."""
    b = JBuilder(background=(0.05, 0.05, 0.1))
    b.add_plane((0.0, -3.0, 0.0), (0.0, 1.0, 0.0), JMaterial.diffuse(0.8, 0.8, 0.8))
    r = np.random.default_rng(seed)
    c = r.uniform(-2.0, 2.0, (n, 1, 3)) + np.array([0.0, 0.0, 6.0])
    b.add_triangles((c + r.uniform(-0.35, 0.35, (n, 3, 3))).astype(np.float32),
                    JMaterial.diffuse(0.7, 0.4, 0.3))
    light = JMaterial.emissive(10.0, 10.0, 10.0)
    b.add_triangle((1.5, 6.0, 7.5), (1.5, 6.0, 4.5), (-1.5, 6.0, 4.5), light)
    b.add_triangle((-1.5, 6.0, 7.5), (1.5, 6.0, 7.5), (-1.5, 6.0, 4.5), light)
    return b.build()


def _mixed(seed=11):
    """Every finite family, with an emissive sphere and square."""
    r = np.random.default_rng(seed)
    b = JBuilder(background=(0.05, 0.05, 0.1))
    mat = JMaterial.diffuse(0.7, 0.5, 0.4)
    b.add_plane((0.0, -3.0, 0.0), (0.0, 1.0, 0.0), mat)
    c = r.uniform(-3, 3, (150, 1, 3)) + np.array([0, 0, 6.0])
    b.add_triangles((c + r.uniform(-0.3, 0.3, (150, 3, 3))).astype(np.float32), mat)
    for _ in range(60):
        b.add_sphere(tuple(r.uniform(-3, 3, 3) + [0, 0, 6.0]), float(r.uniform(0.1, 0.4)),
                     mat)
    for _ in range(8):
        b.add_torus(tuple(r.uniform(-2, 2, 3) + [0, 0, 6.0]), float(r.uniform(0.4, 0.8)),
                    float(r.uniform(0.1, 0.25)), mat)
    for _ in range(20):
        lo = r.uniform(-3, 3, 3) + np.array([0, 0, 6.0])
        hi = lo + r.uniform(0.2, 0.8, 3)
        b.add_aarect(lo[0], hi[0], lo[1], hi[1], lo[2], hi[2], mat)
    for _ in range(12):
        b.add_square(tuple(r.uniform(-3, 3, 3) + [0, 0, 6.0]), float(r.uniform(0.3, 1.0)),
                     mat)
    b.add_sphere((0.0, 3.5, 6.0), 0.3, JMaterial.emissive(8.0, 8.0, 8.0))
    b.add_square((1.0, 4.0, 6.0), 1.0, JMaterial.emissive(6.0, 6.0, 6.0))
    return b.build()


SCENES = {
    "cloud": (_cloud, dict(group=64, min_count=64)),
    "mixed": (_mixed, dict(group=32, min_count=8)),
    "mixed_lights_dense": (_mixed, dict(group=32, min_count=8, exclude_lights=True)),
    "mesh24": (lambda: jscenes.mesh_scene(jscenes.surface_mesh(24)), {}),
}


@pytest.fixture(params=["native", "numpy"])
def builder(request, monkeypatch):
    """Both packages on the native builder, or both on the NumPy one."""
    if request.param == "numpy":
        def refuse(*a, **k):
            raise RuntimeError("native builder disabled for this test")
        monkeypatch.setattr(jbvh_native, "build", refuse)
        monkeypatch.setattr(tbvh_native, "build", refuse)
    return request.param


def _pair(name):
    make, kw = SCENES[name]
    j = make()
    t = _to_torch(j)
    return j, t, jbvh.attach_clusters(jtrace.prepare(j), j, **kw), \
        tbvh.attach_clusters(ttrace.prepare(t), t, **kw)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_attach_clusters_tables_identical(name, builder):
    j, t, pj, pt = _pair(name)
    cj, ct = pj.cluster, pt.cluster
    assert cj is not None and ct is not None
    for k in tcl.ARRAY_FIELDS:
        a, b = np.asarray(getattr(cj, k)), getattr(ct, k).numpy()
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=k)
    assert tuple(cj.families) == ct.families
    # the dense remainder is the same shape-id sets
    for k in ttrace.INDEX_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(pj, k)),
                                      getattr(pt, k).numpy(), err_msg=k)


@pytest.mark.parametrize("n", [1, 5, 700])
def test_leaf_order_identical(n, builder):
    """The leaf order itself, on AABBs with duplicates and degenerate
    centroids (every fourth box repeated)."""
    r = np.random.default_rng(n)
    lo = r.uniform(-5, 5, (n, 3)).astype(np.float32)
    lo[::4] = lo[0]
    hi = lo + r.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    if builder == "native":
        ref = jbvh_native.build(lo, hi, 16)[2]
    else:
        ref = jbvh.build(lo, hi, 16)[2]
        np.testing.assert_array_equal(tbvh.build_bvh2(lo, hi, 16)[1], ref)
    np.testing.assert_array_equal(tbvh.leaf_order(lo, hi, 16), ref)


def test_native_builder_output_stays_in_build_tree():
    """The port builds the repository's C++ source into its own build
    directory, never beside the source."""
    path = tbvh_native._lib_path()
    tbvh_native._load()
    assert path.exists()
    assert path.parent.parent.name == "bvh" and path.parent.parent.parent.name == "build"


def test_cluster_from_numpy_round_trip_and_layout():
    j, t, pj, pt = _pair("mixed")
    cj = pj.cluster
    cs = tcl.cluster_from_numpy({k: np.asarray(getattr(cj, k)) for k in tcl.ARRAY_FIELDS},
                                cj.families, device="cpu")
    for k in tcl.ARRAY_FIELDS:
        assert torch.equal(getattr(cs, k), getattr(pt.cluster, k)), k
    C, G = cs.num_clusters, cs.group
    assert cs.table.shape == (C, tcl.TABLE_ROWS, G)
    assert torch.equal(cs.table[:, :9].transpose(1, 2), cs.blocks)
    assert torch.equal(cs.table[:, 9].long(), cs.btype.long())
    assert torch.equal(cs.table[:, 10].long().reshape(-1), cs.slot_to_sid)
    assert torch.equal(cs.aabbs, torch.cat([cs.lo.T, cs.hi.T]))
    # every clustered shape appears once
    real = cs.slot_to_sid[cs.slot_to_sid >= 0]
    assert real.unique().numel() == real.numel()


def test_attach_clusters_leaves_small_scenes_dense():
    t = _to_torch(jscenes.museum())
    prep = ttrace.prepare(t)
    assert tbvh.attach_clusters(prep, t) is prep          # no family reaches 512


def _rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-4, 4, (n, 3)).astype(np.float32)
    o[:, 2] -= 2.0
    d = r.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2] = (np.array([0.0, 0.0, 6.0]) + r.normal(size=(n // 2, 3))
                   - o[: n // 2]).astype(np.float32)     # half aimed at the scene
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


# t tolerance (rtol = atol) of each scene; see the module docstring
TOL = {"cloud": 1e-5, "mesh24": 1e-5, "mixed": 1e-4, "mixed_lights_dense": 1e-4}


def _assert_sids_tie(scene, o, d, s0, s1, mask, tol):
    """Shape ids differ only where both shapes' distances tie."""
    idx = np.nonzero(mask & (s0 != s1))[0]
    if idx.size:
        t = _to_torch(scene)
        prep = ttrace.prepare(t)
        dist = []
        for s in (s0[idx], s1[idx]):
            code = prep.code_of[torch.from_numpy(s).long()].long()
            fam = (code >> 20).numpy()
            rows = t.params[torch.from_numpy(s).long()]
            tt = torch.stack([sk._family_distances(int(f), rows[i:i + 1],
                                                   torch.from_numpy(o[idx[i]:idx[i] + 1]),
                                                   torch.from_numpy(d[idx[i]:idx[i] + 1]))[0, 0]
                              for i, f in enumerate(fam)])
            dist.append(tt.numpy())
        np.testing.assert_allclose(dist[0], dist[1], rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["cloud", "mixed", "mesh24"])
def test_trace_clusters_matches_jax(name):
    j, t, pj, pt = _pair(name)
    o, d = _rays(512, seed=5)
    t_init = np.full(512, np.inf, np.float32)
    t_init[::7] = 3.0        # a bound from an earlier hit on some rays
    t0, slot0, r0 = (np.asarray(x) for x in jcl.trace_clusters(
        pj.cluster, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_init)))
    sid0 = np.where(slot0 >= 0, np.asarray(pj.cluster.slot_to_sid)[np.maximum(slot0, 0)], -1)
    t1, sid1, r1 = (x.numpy() for x in tcl.trace_clusters(
        pt.cluster, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_init)))
    np.testing.assert_array_equal(r1, r0)
    h0, h1 = sid0 >= 0, sid1 >= 0
    assert (h0 == h1).all()
    np.testing.assert_allclose(t1, t0, rtol=TOL[name], atol=TOL[name])
    assert h0.sum() > 50
    _assert_sids_tie(j, o, d, sid0, sid1, h0 & h1, TOL[name])


@pytest.mark.parametrize("name", ["cloud", "mixed_lights_dense"])
def test_trace_scene_and_shadow_ray_with_clusters_match_jax(name):
    """The dense hit merged with the clusters' (cost = dense tests +
    rounds * G), and the shadow query as a trace plus the comparison."""
    j, t, pj, pt = _pair(name)
    o, d = _rays(512, seed=7)
    ref = jtrace.trace_scene(pj, j, jnp.asarray(o), jnp.asarray(d))
    out = ttrace.trace_scene(pt, t, torch.from_numpy(o), torch.from_numpy(d))
    t0, s0, h0, c0 = (np.asarray(x) for x in ref)
    t1, s1, h1, c1 = (x.numpy() for x in out)
    assert (h0 == h1).all()
    np.testing.assert_allclose(t1[h1], t0[h0], rtol=TOL[name], atol=TOL[name])
    np.testing.assert_array_equal(c1, c0)
    _assert_sids_tie(j, o, d, s0, s1, h0 & h1, TOL[name])
    # shadow rays from the hits toward interior points of the lights (a
    # triangle light's vertex is shared with its neighbour: a ray aimed
    # there ties between the two by construction)
    r = np.random.default_rng(1)
    lsid = r.choice(np.asarray(j.light_shape), 512).astype(np.int32)
    p = np.where(h0[:, None], o + d * np.where(h0, t0, 0.0)[:, None], o).astype(np.float32)
    rows = np.asarray(j.params)[lsid]
    w = r.uniform(0.2, 0.6, (512, 2))
    interior = rows[:, 0:3] + w[:, :1] * (rows[:, 3:6] - rows[:, 0:3]) \
        + 0.5 * w[:, 1:] * (rows[:, 6:9] - rows[:, 0:3])
    tri = np.asarray(j.ptype)[lsid] == 2
    p_l = np.where(tri[:, None], interior, rows[:, 0:3]).astype(np.float32)
    occ0, k0 = jtrace.shadow_ray(pj, j, jnp.asarray(p), jnp.asarray(p_l), jnp.asarray(lsid))
    occ1, k1 = ttrace.shadow_ray(pt, t, torch.from_numpy(p), torch.from_numpy(p_l),
                                 torch.from_numpy(lsid).long())
    np.testing.assert_array_equal(occ1.numpy(), np.asarray(occ0))
    np.testing.assert_array_equal(k1.numpy(), np.asarray(k0))
