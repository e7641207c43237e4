"""The port's cluster select and probe kernels (their plain versions, on
the CPU) against the JAX package's Pallas kernels in interpret mode, on
cluster tables carried over from the JAX package by
``ops.cluster.cluster_from_numpy``.

- select_blocks (K6) and select_scan's select half (K3): entries equal
  bit for bit (the slab test is the same sequence of IEEE operations),
  cluster ids equal where the entry is finite (an exhausted lane's id is
  meaningless).
- select_scan's dense half: t within rtol 1e-5 / atol 1e-5, shape ids
  equal where it hits (``tests/test_probe_pallas.py``'s rule against the
  dense XLA trace).
- probe_pair (K4) and probe_min (K5), streamed and VMEM bodies: hits
  equal, t within rtol 1e-5 / atol 1e-5 on triangle clusters and within
  the rtol 1e-4 / atol 1e-4 of the JAX package's own mixed-family tests
  (``tests/test_cluster.py``, ``tests/test_probe_pallas.py``) where
  spheres and tori take part (the Pallas sphere test rounds a grazing
  ray's quadratic differently from JAX's own XLA block test, which the
  port's plain version follows); shape ids equal where t is finite
  unless the two slots' distances tie within that tolerance.
- probe_blocks (K7), the unreduced round, on the three cases of
  ``tests/test_probe_pallas.py`` (triangles, all families, a ragged lane
  count): finiteness equal entry by entry, distances within the same
  tolerances.

The CUDA kernels run only on a GPU; ``test_cuda_kernel_matches_plain_on
_gpu`` holds each against its plain version there and skips here.  Its
scenes hold spheres and tori, so distances take the mixed-family
tolerance there too (nvcc contracts the sphere quadratic and the torus
march to FMA, the plain version rounds each product: up to 4e-5
relative on an NVIDIA H100).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from wasm_pathtracer_tpu.models import scenes as jscenes
from wasm_pathtracer_tpu.models.scene import Material as JMaterial
from wasm_pathtracer_tpu.models.scene import SceneBuilder as JBuilder
from wasm_pathtracer_tpu.ops import bvh as jbvh
from wasm_pathtracer_tpu.ops import cluster as jcl
from wasm_pathtracer_tpu.ops import probe_pallas as jpp
from wasm_pathtracer_tpu.ops import trace as jtrace
from wasm_pathtracer_tpu_torch.models.scene import TENSOR_FIELDS, scene_from_numpy
from wasm_pathtracer_tpu_torch.ops import cluster as tcl
from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
from wasm_pathtracer_tpu_torch.ops import trace as ttrace

TOL = 1e-5
# probe t tolerance (rtol = atol) of each case; see the module docstring
PROBE_TOL = {"mixed": 1e-4, "mesh": 1e-5}


def _mixed(n_tri=200, n_sphere=60, n_torus=8, n_aarect=20, n_square=12, seed=11):
    """Every finite family (``tests/test_probe_pallas.py``'s scene)."""
    r = np.random.default_rng(seed)
    b = JBuilder(background=(0.05, 0.05, 0.1))
    mat = JMaterial.diffuse(0.7, 0.5, 0.4)
    c = r.uniform(-3, 3, (n_tri, 1, 3)) + np.array([0, 0, 6.0])
    b.add_triangles((c + r.uniform(-0.3, 0.3, (n_tri, 3, 3))).astype(np.float32), mat)
    for _ in range(n_sphere):
        b.add_sphere(tuple(r.uniform(-3, 3, 3) + [0, 0, 6.0]), float(r.uniform(0.1, 0.4)),
                     mat)
    for _ in range(n_torus):
        b.add_torus(tuple(r.uniform(-2, 2, 3) + [0, 0, 6.0]), float(r.uniform(0.4, 0.8)),
                    float(r.uniform(0.1, 0.25)), mat)
    for _ in range(n_aarect):
        lo = r.uniform(-3, 3, 3) + np.array([0, 0, 6.0])
        hi = lo + r.uniform(0.2, 0.8, 3)
        b.add_aarect(lo[0], hi[0], lo[1], hi[1], lo[2], hi[2], mat)
    for _ in range(n_square):
        b.add_square(tuple(r.uniform(-3, 3, 3) + [0, 0, 6.0]), float(r.uniform(0.3, 1.0)),
                     mat)
    light = JMaterial.emissive(10.0, 10.0, 10.0)
    b.add_triangle((1.5, 7.0, 7.5), (1.5, 7.0, 4.5), (-1.5, 7.0, 4.5), light)
    b.add_triangle((-1.5, 7.0, 7.5), (1.5, 7.0, 7.5), (-1.5, 7.0, 4.5), light)
    return b.build()


# (scene, attach_clusters keywords): all families clustered; a surface
# mesh over a one-plane remainder; triangles clustered over a dense
# remainder of every other family (spheres, tori, aarects, squares and
# the two light triangles, 24 shapes)
CASES = {
    "mixed": (_mixed, dict(group=128, min_count=32)),
    "mesh": (lambda: jscenes.mesh_scene(jscenes.surface_mesh(14)),
             dict(group=128, min_count=64)),
    "mixed_dense": (lambda: _mixed(n_sphere=10, n_torus=3, n_aarect=5, n_square=4),
                    dict(group=128, families=[2], exclude_lights=True)),
}


def _to_torch(scene):
    return scene_from_numpy({k: np.asarray(getattr(scene, k)) for k in TENSOR_FIELDS},
                            scene.num_inf, scene.num_shapes, scene.num_lights,
                            scene.num_plights)


def _case(name, device="cpu"):
    """(JAX scene, JAX prep, port prep on ``device``): the port prep's
    dense tables are its own, its cluster set the JAX one carried over."""
    make, kw = CASES[name]
    j = make()
    pj = jbvh.attach_clusters(jtrace.prepare(j), j, **kw)
    cj = pj.cluster
    cs = tcl.cluster_from_numpy({k: np.asarray(getattr(cj, k)) for k in tcl.ARRAY_FIELDS},
                                cj.families, device)
    return j, pj, ttrace.prepare_from_sets(
        _to_torch(j).to(device), [np.asarray(getattr(pj, a)) for a in ttrace.INDEX_FIELDS],
        cluster=cs)


def _rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-4, 4, (n, 3)).astype(np.float32)
    o[:, 2] -= 2.0
    d = r.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2] = (np.array([0.0, 0.0, 6.0]) + r.normal(size=(n // 2, 3))
                   - o[: n // 2]).astype(np.float32)       # half aimed at the scene
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _cursors(n, C, seed):
    """Random lex cursors, half of them fresh (-inf, -1)."""
    r = np.random.default_rng(seed)
    skip_e = np.where(r.random(n) < 0.5, -np.inf, r.uniform(0, 5, n)).astype(np.float32)
    skip_c = r.integers(-1, C, n).astype(np.int32)
    return skip_e, skip_c


def _assert_select_equal(ref, out):
    e0, c0, eb0, cb0, ea0 = (np.asarray(x) for x in ref)
    e1, c1, eb1, cb1, ea1 = (x.numpy() for x in out)
    for a, b in ((e0, e1), (eb0, eb1), (ea0, ea1)):
        np.testing.assert_array_equal(b, a)
    for e, a, b in ((e0, c0, c1), (eb0, cb0, cb1)):
        fin = np.isfinite(e)
        np.testing.assert_array_equal(b[fin], a[fin])
    assert np.isfinite(e0).mean() > 0.2


@pytest.mark.parametrize("name", ["mixed", "mesh"])
def test_select_blocks_matches_pallas(name):
    _, pj, pt = _case(name)
    cs = pt.cluster
    n = 160
    o, d = _rays(n, seed=7)
    skip_e, skip_c = _cursors(n, cs.num_clusters, seed=0)
    with pltpu.force_tpu_interpret_mode():
        ref = jpp.select_blocks(pj.cluster, jpp.pack_aabbs(pj.cluster), jnp.asarray(o),
                                jnp.asarray(d), jnp.asarray(skip_e), jnp.asarray(skip_c),
                                cs.num_clusters)
    out = pk.select_blocks(pt.cluster, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(skip_e), torch.from_numpy(skip_c))
    _assert_select_equal(ref, out)


@pytest.mark.parametrize("name", ["mesh", "mixed_dense"])
def test_select_scan_matches_pallas(name):
    j, pj, pt = _case(name)
    cs = pt.cluster
    assert pk.dense_scan_ok(pt) and jpp.dense_scan_ok(pj)
    n = 160
    o, d = _rays(n, seed=5)
    skip_e, skip_c = _cursors(n, cs.num_clusters, seed=7)
    with pltpu.force_tpu_interpret_mode():
        fams, tabs = jpp.pack_dense_tables(pj, j)
        ref = jpp.select_scan(pj.cluster, jpp.pack_aabbs(pj.cluster), fams, tabs,
                              jnp.asarray(o), jnp.asarray(d), jnp.asarray(skip_e),
                              jnp.asarray(skip_c), cs.num_clusters)
    out = pk.select_scan(cs, pt, torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(skip_e), torch.from_numpy(skip_c))
    _assert_select_equal(ref[:5], out[:5])
    t0, s0 = np.asarray(ref[5]), np.asarray(ref[6])
    t1, s1 = out[5].numpy(), out[6].numpy()
    hit = np.isfinite(t0)
    np.testing.assert_array_equal(np.isfinite(t1), hit)
    np.testing.assert_allclose(t1[hit], t0[hit], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(s1[hit], s0[hit])
    assert (s1[~hit] == -1).all() and hit.sum() >= 8


def _assert_probe_close(cs, o, d, cidx, ref, out, tol):
    """Hits and t agree within ``tol``; shape ids equal except on a tie
    of the two slots' distances."""
    t0, s0 = (np.asarray(x) for x in ref)
    t1, s1 = (x.numpy() for x in out)
    fin = np.isfinite(t0)
    np.testing.assert_array_equal(np.isfinite(t1), fin)
    np.testing.assert_allclose(t1[fin], t0[fin], rtol=tol, atol=tol)
    assert (s1[~fin] == -1).all()
    idx = np.nonzero(fin & (s1 != s0))[0]
    if idx.size:
        c = torch.from_numpy(cidx[idx]).long()
        t_slots = tcl._block_test(torch.from_numpy(o[idx]), torch.from_numpy(d[idx]),
                                  cs.blocks[c], cs.btype[c], cs.families).numpy()
        grid = cs.slot_to_sid.view(cs.num_clusters, cs.group)[c].numpy()
        rows = np.arange(idx.size)
        ta = t_slots[rows, (grid == s0[idx, None]).argmax(1)]
        tb = t_slots[rows, (grid == s1[idx, None]).argmax(1)]
        np.testing.assert_allclose(ta, tb, rtol=tol, atol=tol)
    assert fin.mean() > 0.05


# interpret mode costs ~10-30 s a probe call whatever the ray count, so
# each probe body runs once: the pair on every family, the min kernel's
# VMEM body on every family and its streamed body on the mesh
@pytest.mark.parametrize("name", ["mixed"])
def test_probe_pair_matches_pallas(name):
    _, pj, pt = _case(name)
    cs = pt.cluster
    C = cs.num_clusters
    n = 48
    o, d = _rays(n, seed=9)
    # the clusters each ray enters first and second, so that rounds hit
    fresh = (torch.full((n,), -torch.inf), torch.full((n,), -1, dtype=torch.int32))
    sel = pk.select_blocks_reference(cs, torch.from_numpy(o), torch.from_numpy(d), *fresh)
    c1 = np.where(np.arange(n) % 4 == 3, np.arange(n) * 13 % C, sel[1].numpy())
    c2 = np.where(np.arange(n) % 4 == 3, (c1 * 7 + 3) % C, sel[3].numpy())
    c1, c2 = c1.astype(np.int32), c2.astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        row1, row2 = jpp.probe_pair_raw(pj.cluster, jpp.pack_table(pj.cluster),
                                        jnp.asarray(o), jnp.asarray(d), jnp.asarray(c1),
                                        jnp.asarray(c2))
    out = pk.probe_pair(cs, torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(c1), torch.from_numpy(c2))
    for row, cidx, res in ((row1, c1, out[:2]), (row2, c2, out[2:])):
        row = np.asarray(row)
        _assert_probe_close(cs, o, d, cidx, (row[:, 0], row[:, 1].astype(np.int32)), res,
                            PROBE_TOL[name])


@pytest.mark.parametrize("name,stream", [("mixed", False), ("mesh", True)])
def test_probe_min_matches_pallas(name, stream):
    _, pj, pt = _case(name)
    cs = pt.cluster
    n = 37                                               # ragged lane count
    o, d = _rays(n, seed=3)
    cidx = (np.arange(n, dtype=np.int32) * 7) % cs.num_clusters
    with pltpu.force_tpu_interpret_mode():
        ref = jpp.probe_blocks_min(pj.cluster, jpp.pack_table(pj.cluster), jnp.asarray(o),
                                   jnp.asarray(d), jnp.asarray(cidx), stream=stream)
    out = pk.probe_min(cs, torch.from_numpy(o), torch.from_numpy(d),
                       torch.from_numpy(cidx))
    _assert_probe_close(cs, o, d, cidx, ref, out, PROBE_TOL[name])
    # and JAX's XLA block test with its argmin, which the plain version
    # transcribes, at the kernel tests' tolerance on every family
    c = jnp.asarray(cidx)
    t_blk = jcl._block_test(jnp.asarray(o), jnp.asarray(d), jnp.take(pj.cluster.blocks, c, 0),
                            jnp.take(pj.cluster.btype, c, 0), pj.cluster.families)
    sid = jnp.take(pj.cluster.slot_to_sid.reshape(cs.num_clusters, cs.group), c, 0)[
        jnp.arange(n), jnp.argmin(t_blk, axis=1)]
    _assert_probe_close(cs, o, d, cidx, (jnp.min(t_blk, axis=1), sid), out, TOL)


# the three cases of tests/test_probe_pallas.py: (scene keywords, rays)
K7_CASES = {
    "triangles": (dict(n_tri=300, n_sphere=0, n_torus=0, n_aarect=0, n_square=0), 128),
    "all_families": (dict(), 128),
    "ragged_lanes": (dict(n_tri=150, n_sphere=40, n_torus=0, n_aarect=0, n_square=0), 101),
}


@pytest.mark.parametrize("case", list(K7_CASES))
def test_probe_blocks_matches_pallas(case):
    kw, n = K7_CASES[case]
    j = _mixed(**kw)
    pj = jbvh.attach_clusters(jtrace.prepare(j), j, group=128, min_count=32)
    cj = pj.cluster
    cs = tcl.cluster_from_numpy({k: np.asarray(getattr(cj, k)) for k in tcl.ARRAY_FIELDS},
                                cj.families)
    o, d = _rays(n, seed=1)
    # three rays of four probe the cluster they enter first, so that slots hit
    fresh = (torch.full((n,), -torch.inf), torch.full((n,), -1, dtype=torch.int32))
    sel = pk.select_blocks_reference(cs, torch.from_numpy(o), torch.from_numpy(d), *fresh)
    cidx = np.where(np.arange(n) % 4 == 3, np.arange(n) * 13 % cs.num_clusters,
                    sel[1].numpy()).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpp.probe_blocks(cj, jpp.pack_table(cj), jnp.asarray(o),
                                          jnp.asarray(d), jnp.asarray(cidx)))
    out = pk.probe_blocks(cs, torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(cidx))
    assert out.shape == (n, cs.group) and out.dtype == torch.float32
    out = out.numpy()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(out), fin)
    tol = PROBE_TOL["mesh" if case == "triangles" else "mixed"]
    np.testing.assert_allclose(out[fin], ref[fin], rtol=tol, atol=tol)
    assert fin.sum() >= 10
    # the reduced round is the first minimum of the unreduced one
    t_min, _ = pk.probe_min(cs, torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(cidx))
    np.testing.assert_array_equal(t_min.numpy(), out.min(axis=1))


def test_lockstep_trace_with_unreduced_probe_equals_reduced():
    """``trace_clusters`` with ``unreduced_probe`` (K7's distances and the
    first minimum taken outside) returns what the reduced probe (K5)
    returns, bit for bit, and the JAX lockstep trace's hits."""
    import dataclasses
    j, pj, pt = _case("mixed")
    o, d = _rays(96, seed=13)
    t_init = torch.full((96,), torch.inf)
    ref = tcl.trace_clusters(pt.cluster, torch.from_numpy(o), torch.from_numpy(d), t_init)
    cs7 = dataclasses.replace(pt.cluster, unreduced_probe=True)
    out = tcl.trace_clusters(cs7, torch.from_numpy(o), torch.from_numpy(d), t_init)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    t0, slot0, rounds0 = jcl.trace_clusters(pj.cluster, jnp.asarray(o), jnp.asarray(d),
                                            jnp.full((96,), jnp.inf))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(rounds0))
    hit = np.asarray(slot0) >= 0
    np.testing.assert_array_equal(out[1].numpy() >= 0, hit)
    np.testing.assert_allclose(out[0].numpy()[hit], np.asarray(t0)[hit], rtol=1e-4, atol=1e-4)
    assert hit.sum() > 10


def test_probe_clamps_cluster_ids():
    """Out-of-range cluster ids (an exhausted lane's) are clamped into
    [0, C), as the TPU wrappers clamp them."""
    _, _, pt = _case("mesh")
    cs = pt.cluster
    o, d = (torch.from_numpy(x) for x in _rays(32, seed=1))
    C = cs.num_clusters
    lo = pk.probe_min(cs, o, d, torch.full((32,), -5, dtype=torch.int32))
    hi = pk.probe_min(cs, o, d, torch.full((32,), C + 9, dtype=torch.int32))
    for out, c in ((lo, 0), (hi, C - 1)):
        ref = pk.probe_min(cs, o, d, torch.full((32,), c, dtype=torch.int32))
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_wrappers_reject_bad_cuda_inputs():
    """A wrapper never falls back to its plain version off the CPU: a
    tensor on another device type is refused."""
    _, _, pt = _case("mesh")
    o, d = (torch.from_numpy(x).to("meta") for x in _rays(8, seed=1))
    c = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        pk.probe_min(pt.cluster, o, d, c)
    with pytest.raises(ValueError):
        pk.select_blocks(pt.cluster, o, d, torch.zeros(8, device="meta"), c)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["select_blocks", "select_scan", "probe_pair",
                                    "probe_min", "probe_blocks"])
def test_cuda_kernel_matches_plain_on_gpu(cuda_device, kernel):
    _, _, prep = _case("mixed_dense" if kernel == "select_scan" else "mixed", cuda_device)
    cs = prep.cluster
    n = 4096 + 37
    o, d = (torch.from_numpy(x).to(cuda_device) for x in _rays(n, seed=21))
    skip_e, skip_c = (torch.from_numpy(x).to(cuda_device)
                      for x in _cursors(n, cs.num_clusters, seed=4))
    if kernel in ("select_blocks", "select_scan"):
        args = (cs, o, d, skip_e, skip_c) if kernel == "select_blocks" else \
            (cs, prep, o, d, skip_e, skip_c)
        out = getattr(pk, kernel)(*args)
        ref = getattr(pk, kernel + "_reference")(*args)
        for a, b in zip(out[0:5:2], ref[0:5:2]):
            torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
        for c_k, c_p, e in ((out[1], ref[1], ref[0]), (out[3], ref[3], ref[2])):
            assert (c_k == c_p)[torch.isfinite(e)].float().mean() > 0.999
        if kernel == "select_scan":
            hit = torch.isfinite(ref[5])
            assert (torch.isfinite(out[5]) == hit).float().mean() > 0.999
            both = hit & torch.isfinite(out[5])
            torch.testing.assert_close(out[5][both], ref[5][both], rtol=PROBE_TOL["mixed"],
                                       atol=PROBE_TOL["mixed"])
        return
    c1 = (torch.arange(n, device=cuda_device, dtype=torch.int32) * 13) % cs.num_clusters
    c2 = (c1 * 7 + 3) % cs.num_clusters
    if kernel == "probe_blocks":
        t_k, t_p = pk.probe_blocks(cs, o, d, c1), pk.probe_blocks_reference(cs, o, d, c1)
        fin = torch.isfinite(t_p)
        assert (torch.isfinite(t_k) == fin).float().mean() > 0.999
        both = fin & torch.isfinite(t_k)
        torch.testing.assert_close(t_k[both], t_p[both], rtol=PROBE_TOL["mixed"],
                                   atol=PROBE_TOL["mixed"])
        assert torch.equal(t_k.amin(dim=1), pk.probe_min(cs, o, d, c1)[0])
        return
    args = (cs, o, d, c1, c2) if kernel == "probe_pair" else (cs, o, d, c1)
    out = getattr(pk, kernel)(*args)
    ref = getattr(pk, kernel + "_reference")(*args)
    for t_k, s_k, t_p, s_p in zip(out[0::2], out[1::2], ref[0::2], ref[1::2]):
        fin = torch.isfinite(t_p)
        assert (torch.isfinite(t_k) == fin).float().mean() > 0.999
        both = fin & torch.isfinite(t_k)
        torch.testing.assert_close(t_k[both], t_p[both], rtol=PROBE_TOL["mixed"],
                                   atol=PROBE_TOL["mixed"])
        assert (s_k == s_p)[both].float().mean() > 0.995
