"""The port's scene model and camera against the JAX package's: scene
tables identical bit for bit, the state converter exact, primary rays to
float32 rounding."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from wasm_pathtracer_tpu.models import camera as jcamera
from wasm_pathtracer_tpu.models import scenes as jscenes
from wasm_pathtracer_tpu_torch.models import camera as tcamera
from wasm_pathtracer_tpu_torch.models import scenes as tscenes
from wasm_pathtracer_tpu_torch.models.scene import TENSOR_FIELDS, scene_from_numpy

SCENE_IDS = [0, 100, 101]


def _jax_arrays(scene):
    return {k: np.asarray(getattr(scene, k)) for k in TENSOR_FIELDS}


@pytest.mark.parametrize("scene_id", SCENE_IDS)
def test_scene_tables_identical(scene_id):
    j = jscenes.select_scene(scene_id)
    t = tscenes.select_scene(scene_id)
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
                         j.num_lights, j.num_plights)
    for k, a in _jax_arrays(j).items():
        np.testing.assert_array_equal(a, getattr(t, k).numpy(), err_msg=k)
    back = t.to("cpu")
    assert back.num_shapes == j.num_shapes


def test_museum_shape():
    s = tscenes.museum()
    ptype = s.ptype.numpy()
    assert s.num_shapes == 146 and s.num_lights == 108
    assert [(ptype == k).sum() for k in range(6)] == [1, 0, 108, 27, 10, 0]


@pytest.mark.parametrize("scene_id", [1, 2, 3, 4, 5])
def test_mesh_scenes_not_ported(scene_id):
    with pytest.raises(NotImplementedError):
        tscenes.select_scene(scene_id)


def test_invalid_scene_raises():
    with pytest.raises(ValueError):
        tscenes.select_scene(42)


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
                                   np.asarray(jc.rot_y))
    o1, d1 = tcamera.primary_rays(tc, torch.from_numpy(px), torch.from_numpy(py),
                                  torch.from_numpy(jx), torch.from_numpy(jy), W, H)
    np.testing.assert_array_equal(np.asarray(o0), o1.numpy())
    np.testing.assert_allclose(d1.numpy(), np.asarray(d0), rtol=1e-5, atol=1e-6)
