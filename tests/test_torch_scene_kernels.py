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

The CUDA kernels test triangles in the staged form of the dense sweep;
``fused_nearest_staged`` and ``fused_occluded_staged`` are their
arithmetic in plain PyTorch, held here against the Pallas kernels at the
same tolerances, with every kind of excluded light and on a scene moved
1e3 units away.  The CUDA kernels themselves run only on a GPU;
``test_kernels_match_plain_on_gpu`` holds them against the plain
versions there and skips here.
"""

import dataclasses

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
                            scene.num_plights, device="cpu")


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


def _assert_traces_agree(ref, out, atol=1e-4):
    t0, sid0, hit0 = (np.asarray(x) for x in ref[:3])
    t1, sid1, hit1 = (x.numpy() for x in out[:3])
    assert (hit0 == hit1).mean() > 0.999
    both = hit0 & hit1
    np.testing.assert_allclose(t1[both], t0[both], rtol=1e-5, atol=atol)
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
    so, sd, dist, lsid, far = shadow_rays(prep, t, o, d, 8)
    occ = sk.fused_occluded(prep.tables, so, sd, dist, lsid, prep.code_of)
    with pltpu.force_tpu_interpret_mode():
        occ_j, _ = jsp.occluded_fused(jtrace.prepare(j), j, jnp.asarray(so.numpy()),
                                      jnp.asarray(sd.numpy()),
                                      jnp.asarray(dist.numpy()),
                                      jnp.asarray(lsid.numpy().astype(np.int32)))
    diff = torch.from_numpy(np.asarray(occ_j)) != occ
    assert not diff[~far].any()
    assert far.sum() > 1000 and diff[far].float().mean() < 0.02
    idx = torch.nonzero(diff)[:, 0]
    assert rounding_ties(prep.tables, prep.code_of, so[idx], sd[idx], dist[idx],
                         lsid[idx]).all()


def test_occluded_without_exclusion_is_any_hit_before_dist():
    """excl = -1: occluded iff anything is hit before ``dist``."""
    t = _to_torch(jscenes.museum())
    prep = ttrace.prepare(t)
    o, d = (torch.from_numpy(x) for x in _rays(512, seed=21))
    tt, _, hit, _ = ttrace.trace_scene(prep, t, o, d)
    dist = torch.full((512,), 3.0)
    occ = sk.fused_occluded(prep.tables, o, d, dist,
                            torch.full((512,), -1, dtype=torch.int64), prep.code_of)
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
    a = sk.fused_nearest(tables, o, d, prep.sid_of_slot)
    b = sk.fused_nearest_reference(tables, o, d, prep.sid_of_slot)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    dist = torch.ones(64)
    lsid = torch.full((64,), -1, dtype=torch.int64)
    assert torch.equal(sk.fused_occluded(tables, o, d, dist, lsid, prep.code_of),
                       sk.fused_occluded_reference(tables, o, d, dist, lsid, prep.code_of))
    assert (sk.fused_nearest.launches, sk.fused_occluded.launches) == (n0, n1)


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is
    refused; there is no fallback to the plain version."""
    t = _to_torch(jscenes.sphere_plane())
    prep = ttrace.prepare(t)
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        sk.fused_nearest(prep.tables, o, o, prep.sid_of_slot.to("meta"))
    with pytest.raises(ValueError):
        sk.fused_occluded(prep.tables, o, o, torch.zeros(4, device="meta"),
                          torch.zeros(4, dtype=torch.int64, device="meta"),
                          prep.code_of.to("meta"))


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
    _assert_nearest_matches_plain(tables, o, d, prep.sid_of_slot)
    tp, _ = sk.fused_nearest_reference(tables, o, d, prep.sid_of_slot)
    dist = torch.where(torch.isfinite(tp), tp, 10.0) * 0.5
    lsid = torch.full((o.shape[0],), -1, dtype=torch.int64, device=cuda_device)
    occ_k = sk.fused_occluded(tables, o, d, dist, lsid, prep.code_of)
    occ_p = sk.fused_occluded_reference(tables, o, d, dist, lsid, prep.code_of)
    assert (occ_k == occ_p).float().mean() > 0.999


def _assert_nearest_matches_plain(tables, o, d, sid_map):
    tk, sk_ = sk.fused_nearest(tables, o, d, sid_map)
    tp, sp = sk.fused_nearest_reference(tables, o, d, sid_map)
    both = (sk_ >= 0) & (sp >= 0)
    assert ((sk_ >= 0) == (sp >= 0)).float().mean() > 0.999
    torch.testing.assert_close(tk[both], tp[both], rtol=1e-5, atol=1e-4)
    assert (sk_ == sp)[both].float().mean() > 0.995
    assert torch.isinf(tk[sk_ < 0]).all()


@pytest.mark.gpu
def test_kernels_match_plain_on_headline_rays_on_gpu(cuda_device):
    """The rays K1 and K2 get in one iteration of the museum headline
    (``chip_smoke.headline_inputs``)."""
    from chip_smoke import headline_inputs
    got = headline_inputs(cuda_device)
    _assert_nearest_matches_plain(*got["fused_nearest"])
    args = got["fused_occluded"]
    occ_k = sk.fused_occluded(*args)
    occ_p = sk.fused_occluded_reference(*args)
    assert (occ_k == occ_p).float().mean() > 0.999


# ---------------------------------------------------------------------------
# the kernels' own arithmetic (staged triangles, K2's limit), in plain
# PyTorch, against the Pallas kernels
# ---------------------------------------------------------------------------

def _moved(scene, offset):
    """``scene`` with every position moved by ``offset`` along each axis
    (plane locations, sphere, torus and square centres, triangle
    vertices, aarect corners)."""
    params = np.asarray(scene.params).copy()
    ptype = np.asarray(scene.ptype)
    cols = {0: [0, 1, 2], 1: [0, 1, 2], 2: list(range(9)), 3: [0, 1, 2],
            4: list(range(6)), 5: [0, 1, 2]}
    for pt, c in cols.items():
        rows = ptype == pt
        params[np.ix_(rows, c)] += np.float32(offset)
    return dataclasses.replace(scene, params=jnp.asarray(params))


def _staged_vs_pallas(j, o, d, atol=1e-4):
    jprep = jtrace.prepare(j)
    with pltpu.force_tpu_interpret_mode():
        ref = jsp.trace_scene_fused(jprep, j, jnp.asarray(o), jnp.asarray(d))
    t = _to_torch(j)
    prep = ttrace.prepare(t)
    tt, sid = sk.fused_nearest_staged(prep.tables, torch.from_numpy(o),
                                      torch.from_numpy(d), prep.sid_of_slot)
    _assert_traces_agree(ref, (tt, sid, torch.isfinite(tt)), atol=atol)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_staged_nearest_matches_pallas_interpret(name):
    o, d = _rays(1024, seed=3)
    _staged_vs_pallas(SCENES[name](), o, d)


@pytest.mark.parametrize("name", ["museum", "all_families"])
def test_staged_nearest_far_from_the_origin(name):
    """The scene and the rays moved 1e3 units along each axis: the
    staged edge offsets k_i = slack - a_i . m_i then cancel against
    p . m_i of the same size, and hits and shape ids are held to the
    rates above.  So does n.v0 - n.o in every form of t: a float32 ulp of
    a coordinate there is 6.1e-5, and the Pallas kernel's own t lies up
    to 1e-4 from a float64 evaluation of the same plane, so t is held
    within 8 ulp of the coordinates (4.9e-4) instead of 1e-4."""
    o, d = _rays(2048, seed=23)
    _staged_vs_pallas(_moved(SCENES[name](), 1e3), o + np.float32(1e3), d,
                      atol=8 * float(np.spacing(np.float32(1e3))))


def _emissive_torus_scene():
    """A torus light beside a plane, a sphere, five triangles and a box."""
    b = JBuilder(background=(0.1, 0.1, 0.1))
    b.add_torus((0.5, 0.0, -0.5), 0.9, 0.3, JMaterial.emissive(3.0, 3.0, 3.0))
    b.add_plane((0, -2, 0), (0, 1, 0), JMaterial.diffuse(0.5, 0.5, 0.5))
    b.add_sphere((1.5, 0.5, 1.0), 0.6, JMaterial.diffuse(0.6, 0.4, 0.3))
    b.add_triangles(jscenes.triangle_cloud(5, seed=9), JMaterial.diffuse(0.4, 0.4, 0.4))
    lo = np.array([-1.5, -1.0, 1.2])
    b.add_aarect(lo[0], lo[0] + 0.5, lo[1], lo[1] + 0.8, lo[2], lo[2] + 0.4,
                 JMaterial.diffuse(0.2, 0.6, 0.7))
    return b.build()


def _occlusion_case(case):
    """(JAX scene, o, d, dist, light_sid) of one kind of excluded light,
    from origins inside the scene:

    - ``no_light``: light_sid -1 toward random points;
    - ``missed_light``: toward random points (on no surface), with a
      random light of the scene as the exclusion, which most rays miss
      (t_exc = +inf);
    - ``torus_light``: toward the centre of the scene's emissive torus
      with it as the exclusion (the ray crosses the ring, so t_exc is
      finite and below dist)."""
    r = np.random.default_rng({"no_light": 41, "missed_light": 43, "torus_light": 47}[case])
    n = 512
    if case == "torus_light":
        j = _emissive_torus_scene()
        lights = np.asarray(j.light_shape)
        tor = [s for s in lights if int(np.asarray(j.ptype)[s]) == 3]
        lsid = np.full(n, tor[0], np.int64)
        target = np.asarray(j.params)[lsid][:, 0:3] + r.normal(0, 0.05, (n, 3))
    else:
        j = _all_families(True)
        target = r.uniform(-3, 3, (n, 3))
        lsid = (np.full(n, -1, np.int64) if case == "no_light"
                else r.choice(np.asarray(j.light_shape), n).astype(np.int64))
    p = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    to = (target - p).astype(np.float32)
    dist = np.linalg.norm(to, axis=-1).astype(np.float32)
    d = (to / dist[:, None]).astype(np.float32)
    o = (p + d * np.float32(1e-4)).astype(np.float32)
    return j, o, d, dist, lsid


@pytest.mark.parametrize("case", ["no_light", "missed_light", "torus_light"])
def test_staged_occluded_matches_pallas_interpret(case):
    """Verdicts from in-scene origins agree exactly: K2's limit
    min(dist, t_exc) and its early exit decide what the TPU kernel's
    t_non < dist && t_non < t_exc decides."""
    j, o, d, dist, lsid = _occlusion_case(case)
    with pltpu.force_tpu_interpret_mode():
        occ_j, _ = jsp.occluded_fused(jtrace.prepare(j), j, jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(dist), jnp.asarray(lsid.astype(np.int32)))
    t = _to_torch(j)
    prep = ttrace.prepare(t)
    args = (prep.tables, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(dist),
            torch.from_numpy(lsid), prep.code_of)
    occ_s = sk.fused_occluded_staged(*args)
    occ_p = sk.fused_occluded_reference(*args)
    np.testing.assert_array_equal(occ_s.numpy(), np.asarray(occ_j))
    np.testing.assert_array_equal(occ_p.numpy(), np.asarray(occ_j))
    # the case does what it says: both verdicts occur, and the exclusion
    # matters where there is one
    assert 0.05 < occ_s.float().mean() < 0.95
    if case != "no_light":
        none = torch.full_like(args[4], -1)
        assert not torch.equal(sk.fused_occluded_staged(*args[:4], none, prep.code_of),
                               occ_s)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_staged_distances_are_the_kernel_families(name):
    """Outside the triangles the staged version is the plain one bit for
    bit; with them, it agrees at the kernel tolerances."""
    j = SCENES[name]()
    t = _to_torch(j)
    prep = ttrace.prepare(t)
    o, d = (torch.from_numpy(x) for x in _rays(1024, seed=29))
    for fam in range(6):
        if prep.tables.counts[fam] == 0:
            continue
        rows = prep.tables.family(fam)
        a = sk._staged_family_distances(fam, rows, o, d)
        b = sk._family_distances(fam, rows, o, d)
        if fam != sk.FAM_TRI:
            assert torch.equal(a, b)
        else:
            fa, fb = torch.isfinite(a), torch.isfinite(b)
            assert (fa == fb).float().mean() > 0.999
            torch.testing.assert_close(a[fa & fb], b[fa & fb], rtol=1e-5, atol=1e-4)
