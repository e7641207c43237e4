"""The port's scene model and camera against the JAX package's: scene
tables identical bit for bit, the state converter exact, primary rays to
float32 rounding."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from wasm_pathtracer_tpu.models import camera as jcamera
from wasm_pathtracer_tpu.models import scene as jscene
from wasm_pathtracer_tpu.models import scenes as jscenes
from wasm_pathtracer_tpu_torch.models import camera as tcamera
from wasm_pathtracer_tpu_torch.models import scenes as tscenes
from wasm_pathtracer_tpu_torch.models import scene as tscene
from wasm_pathtracer_tpu_torch.models.scene import TENSOR_FIELDS, scene_from_numpy

SCENE_IDS = [0, 2, 3, 4, 100, 101]


def _jax_arrays(scene):
    return {k: np.asarray(getattr(scene, k)) for k in TENSOR_FIELDS}


@pytest.mark.parametrize("scene_id", SCENE_IDS)
def test_scene_tables_identical(scene_id):
    j = jscenes.select_scene(scene_id)
    t = tscenes.select_scene(scene_id, device="cpu")
    for k, a in _jax_arrays(j).items():
        b = getattr(t, k).numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("num_inf", "num_shapes", "num_lights", "num_plights"):
        assert getattr(j, k) == getattr(t, k), k


@pytest.mark.parametrize("scene_id", SCENE_IDS)
def test_scene_from_numpy_round_trips(scene_id):
    j = jscenes.select_scene(scene_id)
    t = scene_from_numpy(_jax_arrays(j), j.num_inf, j.num_shapes,
                         j.num_lights, j.num_plights, device="cpu")
    for k, a in _jax_arrays(j).items():
        np.testing.assert_array_equal(a, getattr(t, k).numpy(), err_msg=k)
    back = t.to("cpu")
    assert back.num_shapes == j.num_shapes


@pytest.mark.parametrize("ptype", [1, 2, 3, 4, 5])
def test_prim_aabb_matches_jax(ptype):
    """Random rows of every finite family (positive radii and sizes)."""
    rows = np.random.default_rng(ptype).uniform(0.05, 3.0, (64, 9)).astype(np.float32)
    rows[::2, :3] *= -1.0
    for p in rows:
        want = jscene.prim_aabb(ptype, p)
        got = tscene.prim_aabb(ptype, p)
        for a, b in zip(want, got):
            assert b.dtype == np.float32 and b.shape == (3,)
            np.testing.assert_array_equal(b, a)


def test_prim_aabb_refuses_a_plane():
    with pytest.raises(ValueError, match="no AABB for ptype 0"):
        tscene.prim_aabb(0, np.zeros(9, np.float32))


@pytest.mark.parametrize("scene_id", [0, 100, 101])
def test_finite_aabb_matches_jax(scene_id):
    want = jscene.finite_aabb(jscenes.select_scene(scene_id))
    got = tscene.finite_aabb(tscenes.select_scene(scene_id, device="cpu"))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)


def test_museum_shape():
    s = tscenes.museum(device="cpu")
    ptype = s.ptype.numpy()
    assert s.num_shapes == 146 and s.num_lights == 108
    assert [(ptype == k).sum() for k in range(6)] == [1, 0, 108, 27, 10, 0]


@pytest.mark.parametrize("scene_id", [1, 2, 3, 4, 5])
def test_mesh_scenes_not_ported(scene_id):
    """The mesh and cloud ids follow the JAX registry: id 1 is no scene
    in either package; 2-5 build with JAX's shape and light counts (2-4
    also have identical tables, ``test_scene_tables_identical``)."""
    if scene_id == 1:
        for registry in (jscenes, tscenes):
            with pytest.raises(ValueError):
                registry.select_scene(scene_id)
        return
    j = jscenes.select_scene(scene_id)
    t = tscenes.select_scene(scene_id, device="cpu")
    for k in ("num_inf", "num_shapes", "num_lights", "num_plights"):
        assert getattr(j, k) == getattr(t, k), k
    np.testing.assert_array_equal(np.asarray(j.ptype), t.ptype.numpy())


def _assert_same_tables(j, t):
    for k, a in _jax_arrays(j).items():
        np.testing.assert_array_equal(a, getattr(t, k).numpy(), err_msg=k)
    assert (j.num_shapes, j.num_lights) == (t.num_shapes, t.num_lights)


@pytest.mark.parametrize("n", [1, 37, 500])
def test_cloud_and_meshes_identical(n):
    """The generators and the mesh scenes, without and with an uploaded
    mesh (the upload transform: x0.5, +5 z)."""
    np.testing.assert_array_equal(tscenes.triangle_cloud(n), jscenes.triangle_cloud(n))
    _assert_same_tables(jscenes.cloud(n), tscenes.cloud(n, device="cpu"))
    mesh = np.random.default_rng(n).uniform(-1, 1, (n, 3, 3)).astype(np.float32)
    meshes = {tscenes.MESH_BUNNY_HIGH: mesh, tscenes.MESH_CLOUD_10K: mesh[::-1]}
    _assert_same_tables(jscenes.cloud(n, meshes, jscenes.MESH_CLOUD_10K),
                        tscenes.cloud(n, meshes, tscenes.MESH_CLOUD_10K, device="cpu"))
    _assert_same_tables(jscenes.bunny_high(meshes), tscenes.bunny_high(meshes, device="cpu"))
    assert tscenes.bunny_high(meshes, device="cpu").num_shapes == 4 + n


@pytest.mark.parametrize("n", [5, 24])
def test_surface_mesh_scene_identical(n):
    surf = tscenes.surface_mesh(n)
    np.testing.assert_array_equal(surf, jscenes.surface_mesh(n))
    assert surf.shape == (2 * n * (n - 1), 3, 3)
    _assert_same_tables(jscenes.mesh_scene(jscenes.surface_mesh(n)),
                        tscenes.mesh_scene(surf, device="cpu"))


def test_invalid_scene_raises():
    with pytest.raises(ValueError):
        tscenes.select_scene(42, device="cpu")


@pytest.mark.parametrize("scene_id,W,H", [(0, 64, 48), (100, 37, 29)])
def test_primary_rays_allclose(scene_id, W, H):
    """Same pixels and jitter through both cameras; float32 rounding of
    the normalisation and two rotations."""
    r = np.random.default_rng(scene_id)
    n = 1000
    px = r.integers(0, W, n).astype(np.int32)
    py = r.integers(0, H, n).astype(np.int32)
    jx, jy = r.random(n, dtype=np.float32), r.random(n, dtype=np.float32)
    jc = jcamera.initial_camera(scene_id)
    o0, d0 = jcamera.primary_rays(jc, jnp.asarray(px), jnp.asarray(py),
                                  jnp.asarray(jx), jnp.asarray(jy), W, H)
    tc = tcamera.camera_from_numpy(np.asarray(jc.location), np.asarray(jc.rot_x),
                                   np.asarray(jc.rot_y), device="cpu")
    o1, d1 = tcamera.primary_rays(tc, torch.from_numpy(px), torch.from_numpy(py),
                                  torch.from_numpy(jx), torch.from_numpy(jy), W, H)
    np.testing.assert_array_equal(np.asarray(o0), o1.numpy())
    np.testing.assert_allclose(d1.numpy(), np.asarray(d0), rtol=1e-5, atol=1e-6)
