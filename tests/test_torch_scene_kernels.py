"""The port's scene kernels (their plain versions, on the CPU) against the
JAX package's Pallas kernels in interpret mode and its dense XLA trace.

Tolerances are those of the JAX package's own kernel tests
(``tests/test_scene_pallas.py``): the two sides agree to float32
rounding, so hits agree on > 99.9% of rays, t within rtol 1e-5 /
atol 1e-4 where both hit, shape ids on > 99.5%.  Occlusion verdicts from
origins within the scene are compared exactly: they may differ only on an
exact float tie between the nearest blocker and the light's own surface,
which these rays do not produce.  From origins far outside the scene they
may differ on rounding ties (``test_occluded_far_origins_differ_only_on_
rounding_ties`` states the rule).

The CUDA kernels themselves run only on a GPU; ``test_kernels_match_plain
_on_gpu`` holds them against the plain versions there and skips here.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from wasm_pathtracer_tpu.models import scenes as jscenes
from wasm_pathtracer_tpu.models.scene import Material as JMaterial
from wasm_pathtracer_tpu.models.scene import SceneBuilder as JBuilder
from wasm_pathtracer_tpu.ops import intersect as jisx
from wasm_pathtracer_tpu.ops import scene_pallas as jsp
from wasm_pathtracer_tpu.ops import trace as jtrace
from wasm_pathtracer_tpu_torch.models.scene import TENSOR_FIELDS, scene_from_numpy
from wasm_pathtracer_tpu_torch.ops import intersect as tisx
from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
from wasm_pathtracer_tpu_torch.ops import trace as ttrace


def _to_torch(scene):
    return scene_from_numpy({k: np.asarray(getattr(scene, k)) for k in TENSOR_FIELDS},
                            scene.num_inf, scene.num_shapes, scene.num_lights,
                            scene.num_plights)


def _all_families(emissive_sphere_and_square: bool):
    """Every primitive family at once, with sizes that are not multiples
    of 8 (the JAX tests' synthetic scenes)."""
    b = JBuilder(background=(0.1, 0.1, 0.1))
    r = np.random.default_rng(13 if emissive_sphere_and_square else 11)
    for _ in range(3):
        b.add_sphere(r.uniform(-2, 2, 3), 0.5, JMaterial.diffuse(0.6, 0.4, 0.3))
    if emissive_sphere_and_square:
        b.add_sphere((0.0, 2.5, 1.0), 0.4, JMaterial.emissive(5.0, 5.0, 5.0))
    b.add_plane((0, -2, 0), (0, 1, 0), JMaterial.diffuse(0.5, 0.5, 0.5))
    for _ in range(2):
        b.add_torus(r.uniform(-2, 2, 3), 0.8, 0.25, JMaterial.diffuse(0.7, 0.7, 0.2))
    lo = r.uniform(-2, 0, (2, 3))
    hi = lo + r.uniform(0.2, 1.0, (2, 3))
    for j in range(2):
        b.add_aarect(lo[j][0], hi[j][0], lo[j][1], hi[j][1], lo[j][2], hi[j][2],
                     JMaterial.diffuse(0.2, 0.6, 0.7))
    if emissive_sphere_and_square:
        b.add_square((0.5, 3.0, 0.5), 1.5, JMaterial.emissive(6.0, 6.0, 6.0))
    else:
        b.add_square((0.5, -1.0, 0.5), 1.5, JMaterial.diffuse(0.9, 0.2, 0.2))
    b.add_triangles(jscenes.triangle_cloud(5, seed=4), JMaterial.emissive(4.0, 4.0, 4.0))
    return b.build()


SCENES = {
    "museum": jscenes.museum,
    "sphere_plane": jscenes.sphere_plane,
    "whitted": jscenes.whitted,
    "all_families": lambda: _all_families(False),
}


def _rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _assert_traces_agree(ref, out):
    t0, sid0, hit0 = (np.asarray(x) for x in ref[:3])
    t1, sid1, hit1 = (x.numpy() for x in out[:3])
    assert (hit0 == hit1).mean() > 0.999
    both = hit0 & hit1
    np.testing.assert_allclose(t1[both], t0[both], rtol=1e-5, atol=1e-4)
    assert (sid0[both] == sid1[both]).mean() > 0.995
    assert np.isinf(t1[~hit1]).all() and (sid1[~hit1] == -1).all()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_nearest_matches_pallas_interpret(name):
    j = SCENES[name]()
    o, d = _rays(1024, seed=3)
    jprep = jtrace.prepare(j)
    with pltpu.force_tpu_interpret_mode():
        ref = jsp.trace_scene_fused(jprep, j, jnp.asarray(o), jnp.asarray(d))
    t = _to_torch(j)
    out = sk.trace_scene_fused(ttrace.prepare(t), t, torch.from_numpy(o),
                               torch.from_numpy(d))
    _assert_traces_agree(ref, out)
    np.testing.assert_array_equal(np.asarray(ref[3]), out[3].numpy())


@pytest.mark.parametrize("name", sorted(SCENES))
def test_nearest_matches_dense_trace(name):
    j = SCENES[name]()
    o, d = _rays(2048, seed=5)
    ref = jtrace.trace_scene(jtrace.prepare(j), j, jnp.asarray(o), jnp.asarray(d))
    t = _to_torch(j)
    out = ttrace.trace_scene(ttrace.prepare(t), t, torch.from_numpy(o),
                             torch.from_numpy(d))
    _assert_traces_agree(ref, out)


def _shadow_inputs(scene, seed, n=512):
    r = np.random.default_rng(seed)
    p = r.uniform(-4, 4, (n, 3)).astype(np.float32)
    lsid = r.choice(np.asarray(scene.light_shape), n).astype(np.int32)
    p_l = np.asarray(scene.params)[lsid][:, 0:3]
    to_l = p_l - p
    dl = np.linalg.norm(to_l, axis=-1).astype(np.float32)
    dd = (to_l / np.maximum(dl, 1e-30)[:, None]).astype(np.float32)
    o = (p + dd * np.float32(1e-4)).astype(np.float32)
    return o, dd, dl, lsid


@pytest.mark.parametrize("name,seed", [("museum", 11), ("all_family_lights", 17)])
def test_occluded_matches_pallas_and_trace(name, seed):
    j = jscenes.museum() if name == "museum" else _all_families(True)
    o, dd, dl, lsid = _shadow_inputs(j, seed)
    jprep = jtrace.prepare(j)
    t0, sid0, hit0, _ = jtrace.trace_scene(jprep, j, jnp.asarray(o), jnp.asarray(dd))
    pred = np.asarray(hit0 & (t0 < dl) & (sid0 != lsid))
    with pltpu.force_tpu_interpret_mode():
        occ_j, _ = jsp.occluded_fused(jprep, j, jnp.asarray(o), jnp.asarray(dd),
                                      jnp.asarray(dl), jnp.asarray(lsid))
    t = _to_torch(j)
    occ, cost = sk.occluded_fused(ttrace.prepare(t), t, torch.from_numpy(o),
                                  torch.from_numpy(dd), torch.from_numpy(dl),
                                  torch.from_numpy(lsid).long())
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_j))
    np.testing.assert_array_equal(occ.numpy(), pred)
    assert (cost.numpy() == t.num_shapes).all()


@pytest.mark.parametrize("name", ["sphere_plane", "all_families"])
def test_occluded_far_origins_differ_only_on_rounding_ties(name):
    """``chip_smoke.py``'s shadow rays, from the hits of camera and random
    rays, on the CPU.  From origins within the scene, verdicts agree as
    above.  From grazing ground-plane hits 50 to ~10^5 units out (a
    float32 ulp there is 4e-6 to 8e-3) the plain version and the Pallas
    kernel round t = (n.v0 - n.o) / (n.d) differently, so verdicts may
    differ, but only where the plain verdict itself flips when the
    origin moves by at most 16 ulp, and on < 2% of rays: the rule
    ``chip_smoke.py`` holds the CUDA kernel to."""
    from chip_smoke import rounding_ties, shadow_rays, test_rays
    j = jscenes.sphere_plane() if name == "sphere_plane" else _all_families(True)
    t = _to_torch(j)
    prep = ttrace.prepare(t)
    o, d = test_rays(8192, 7, torch.device("cpu"))
    so, sd, dist, excl, far = shadow_rays(prep, t, o, d, 8)
    occ = sk.fused_occluded(prep.tables, so, sd, dist, excl)
    sid_of_code = {int(c): s for s, c in enumerate(prep.code_of.tolist())}
    lsid = np.array([sid_of_code.get(int(c), -1) for c in excl], np.int32)
    with pltpu.force_tpu_interpret_mode():
        occ_j, _ = jsp.occluded_fused(jtrace.prepare(j), j, jnp.asarray(so.numpy()),
                                      jnp.asarray(sd.numpy()),
                                      jnp.asarray(dist.numpy()), jnp.asarray(lsid))
    diff = torch.from_numpy(np.asarray(occ_j)) != occ
    assert not diff[~far].any()
    assert far.sum() > 1000 and diff[far].float().mean() < 0.02
    idx = torch.nonzero(diff)[:, 0]
    assert rounding_ties(prep.tables, so[idx], sd[idx], dist[idx], excl[idx]).all()


def test_occluded_without_exclusion_is_any_hit_before_dist():
    """excl = -1: occluded iff anything is hit before ``dist``."""
    t = _to_torch(jscenes.museum())
    prep = ttrace.prepare(t)
    o, d = (torch.from_numpy(x) for x in _rays(512, seed=21))
    tt, _, hit, _ = ttrace.trace_scene(prep, t, o, d)
    dist = torch.full((512,), 3.0)
    occ = sk.fused_occluded(prep.tables, o, d, dist,
                            torch.full((512,), -1, dtype=torch.int32))
    assert torch.equal(occ, hit & (tt < dist))


def test_shape_codes_and_decode_invert():
    t = _to_torch(_all_families(True))
    prep = ttrace.prepare(t)
    code = prep.code_of.long()
    fam, slot = code >> sk.SLOT_BITS, code & ((1 << sk.SLOT_BITS) - 1)
    sid = prep.sid_of_slot[prep.fam_offset[fam] + slot]
    assert torch.equal(sid, torch.arange(t.num_shapes))
    ptype = t.ptype.long()
    assert torch.equal(fam, ptype)   # family order is PrimType order


def test_wrappers_take_plain_version_on_cpu_and_count_only_launches():
    t = _to_torch(jscenes.sphere_plane())
    prep = ttrace.prepare(t)
    tables = prep.tables
    o, d = (torch.from_numpy(x) for x in _rays(64, seed=1))
    n0, n1 = sk.fused_nearest.launches, sk.fused_occluded.launches
    a = sk.fused_nearest(tables, o, d)
    b = sk.fused_nearest_reference(tables, o, d)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    dist = torch.ones(64)
    excl = torch.full((64,), -1, dtype=torch.int32)
    assert torch.equal(sk.fused_occluded(tables, o, d, dist, excl),
                       sk.fused_occluded_reference(tables, o, d, dist, excl))
    assert (sk.fused_nearest.launches, sk.fused_occluded.launches) == (n0, n1)


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is
    refused; there is no fallback to the plain version."""
    t = _to_torch(jscenes.sphere_plane())
    tables = ttrace.prepare(t).tables
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        sk.fused_nearest(tables, o, o)
    with pytest.raises(ValueError):
        sk.fused_occluded(tables, o, o, torch.zeros(4, device="meta"),
                          torch.zeros(4, dtype=torch.int32, device="meta"))


_FAMILY_CASES = {
    "planes": (lambda m, o, d, p: m.rays_vs_planes(o, d, p[:, 0:3], p[:, 3:6]), 0),
    "spheres": (lambda m, o, d, p: m.rays_vs_spheres(o, d, p[:, 0:3], p[:, 3]), 1),
    "triangles": (lambda m, o, d, p: m.rays_vs_triangles(o, d, p[:, 0:3], p[:, 3:6],
                                                         p[:, 6:9]), 2),
    "tori": (lambda m, o, d, p: m.rays_vs_tori(o, d, p[:, 0:3], p[:, 3], p[:, 4]), 3),
    "aarects": (lambda m, o, d, p: m.rays_vs_aarects(o, d, p[:, 0:3], p[:, 3:6]), 4),
    "squares": (lambda m, o, d, p: m.rays_vs_squares(o, d, p[:, 0:3], p[:, 3]), 5),
}


@pytest.mark.parametrize("family", sorted(_FAMILY_CASES))
def test_family_distances_match_intersect(family):
    fn, ptype = _FAMILY_CASES[family]
    # the museum's planes, triangles, tori and aarects; the synthetic
    # scene's spheres and squares
    j = jscenes.museum() if ptype in (0, 2, 3, 4) else _all_families(True)
    rows = np.asarray(j.params)[np.asarray(j.ptype) == ptype]
    # from near one primitive, aim at points near another's first corner
    # or centre, so most rays hit
    r = np.random.default_rng(ptype + 30)
    n = 4096
    o = rows[r.integers(0, len(rows), n), 0:3] + r.uniform(-6, 6, (n, 3))
    aim = rows[r.integers(0, len(rows), n), 0:3] + r.normal(0, 0.8, (n, 3))
    o = o.astype(np.float32)
    d = (aim - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = np.asarray(fn(jisx, jnp.asarray(o), jnp.asarray(d), jnp.asarray(rows)))
    out = fn(tisx, torch.from_numpy(o), torch.from_numpy(d),
             torch.from_numpy(rows)).numpy()
    assert (np.isfinite(ref) == np.isfinite(out)).mean() > 0.999
    both = np.isfinite(ref) & np.isfinite(out)
    assert both.any()
    np.testing.assert_allclose(out[both], ref[both], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", ["museum", "whitted", "all_families"])
def test_hit_info_matches(name):
    """Normals, entering flags and material rows at the nearest hits
    (whitted: textured square, reflective and refractive spheres)."""
    j = SCENES[name]()
    o, d = _rays(1024, seed=9)
    jprep = jtrace.prepare(j)
    t0, sid0, hit0, _ = jtrace.trace_scene(jprep, j, jnp.asarray(o), jnp.asarray(d))
    ts = jnp.where(hit0, t0, 1.0)
    ref = jtrace.hit_info(j, jnp.asarray(o), jnp.asarray(d), ts, jnp.maximum(sid0, 0))
    t = _to_torch(j)
    out = ttrace.hit_info(t, torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(np.array(ts)),
                          torch.from_numpy(np.maximum(np.asarray(sid0), 0)).long())
    hit = np.asarray(hit0)
    for k in ("n", "albedo", "emission", "extra"):
        np.testing.assert_allclose(out[k].numpy()[hit], np.asarray(ref[k])[hit],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("is_entering", "kind"):
        np.testing.assert_array_equal(out[k].numpy()[hit], np.asarray(ref[k])[hit])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernels_match_plain_on_gpu(cuda_device, name):
    t = _to_torch(SCENES[name]()).to(cuda_device)
    prep = ttrace.prepare(t)
    tables = prep.tables
    o, d = (torch.from_numpy(x).to(cuda_device) for x in _rays(16_384 + 37, seed=3))
    tk, fk, sk_ = sk.fused_nearest(tables, o, d)
    tp, fp, sp = sk.fused_nearest_reference(tables, o, d)
    both = (fk >= 0) & (fp >= 0)
    assert ((fk >= 0) == (fp >= 0)).float().mean() > 0.999
    torch.testing.assert_close(tk[both], tp[both], rtol=1e-5, atol=1e-4)
    assert ((fk == fp) & (sk_ == sp))[both].float().mean() > 0.995
    dist = torch.where(fp >= 0, tp, 10.0) * 0.5
    excl = torch.full_like(fk, -1)
    occ_k = sk.fused_occluded(tables, o, d, dist, excl)
    occ_p = sk.fused_occluded_reference(tables, o, d, dist, excl)
    assert (occ_k == occ_p).float().mean() > 0.999
