"""The port's photon-guided NEE against the JAX package's, on the CPU.

- grid bounds: equal.
- one ``emit_photons`` batch: ``num_photons`` equal, bins allclose
  (rtol 1e-5, atol 1e-5: the deposit is a float scatter-add whose order
  differs, and the weights follow the float32 rounding of the trace).
- ``sample`` on a grid carried over with ``photon_grid_from_numpy``:
  pdf allclose (rtol 1e-5); light ids equal except where the draw ``r``
  lies within float32 rounding of a CDF edge (the two cumulative sums may
  round differently), checked against the JAX CDF.
- ``render_queue`` and ``render_queue_flat`` with PNEE on that grid: the
  per-path rule of ``test_torch_integrator.py`` (counts equal, radiance
  rtol 1e-3 / atol 2e-3 on >= 99% of paths, mean to 1e-3).
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
from wasm_pathtracer_tpu.ops import bvh as jbvh
from wasm_pathtracer_tpu.ops import integrator as jint
from wasm_pathtracer_tpu.ops import photon as jph
from wasm_pathtracer_tpu.ops import trace as jtrace
from wasm_pathtracer_tpu.ops import wavefront as jwave
from wasm_pathtracer_tpu.runtime.session import Session as JSession
from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models import scenes as tscenes
from wasm_pathtracer_tpu_torch.models.camera import Camera
from wasm_pathtracer_tpu_torch.ops import bvh as tbvh
from wasm_pathtracer_tpu_torch.ops import integrator as tint
from wasm_pathtracer_tpu_torch.ops import photon as tph
from wasm_pathtracer_tpu_torch.ops import trace as ttrace
from wasm_pathtracer_tpu_torch.ops import wavefront as twave
from wasm_pathtracer_tpu_torch.runtime.session import Session

MUSEUM_CAMERA = ((0.0, 16.34, -23.76), 0.54, 0.0)
MESH_CAMERA = ((0.0, 1.0, -6.0), 0.1, 0.0)
GRID_FIELDS = ("bins", "lo", "hi", "num_photons")
RES = 12


def _jax_grid(scene, prep, n_batches=2, batch=4096, res=RES):
    """A JAX photon grid after ``n_batches`` emission batches."""
    st = JSettings(render_type=JType.PNEE)
    lo, hi = jph.grid_bounds_for_scene(scene, st)
    grid = jph.PhotonGrid.create(scene.num_lights, lo, hi, res)
    for k in range(n_batches):
        grid = jph.emit_photons(grid, prep, scene, st, jnp.uint32(100 + k), batch)
    return grid


def _carry(grid):
    return tph.photon_grid_from_numpy({k: np.asarray(getattr(grid, k))
                                       for k in GRID_FIELDS}, grid.res)


@pytest.mark.parametrize("name,fit", [("museum", True), ("sphere_plane", True),
                                      ("museum", False)])
def test_grid_bounds_match_jax(name, fit):
    st_j = JSettings(photon_grid_fit_scene=fit)
    st_t = RenderSettings(photon_grid_fit_scene=fit)
    lo0, hi0 = jph.grid_bounds_for_scene(getattr(jscenes, name)(), st_j)
    lo1, hi1 = tph.grid_bounds_for_scene(getattr(tscenes, name)(), st_t)
    np.testing.assert_array_equal(lo1, np.asarray(lo0))
    np.testing.assert_array_equal(hi1, np.asarray(hi0))
    assert lo1.dtype == np.float32


def test_emit_photons_matches_jax():
    j, t = jscenes.museum(), tscenes.museum()
    ref = _jax_grid(j, jtrace.prepare(j), n_batches=2)
    st = RenderSettings(render_type=RenderType.PNEE)
    grid = tph.PhotonGrid.create(t.num_lights, *tph.grid_bounds_for_scene(t, st), RES)
    prep = ttrace.prepare(t)
    for k in range(2):
        new = tph.emit_photons(grid, prep, t, st, 100 + k, 4096)
        assert new is not grid and new.bins is grid.bins      # in place, new object
        grid = new
    assert int(grid.num_photons) == int(ref.num_photons) > 2000
    np.testing.assert_allclose(grid.bins.numpy(), np.asarray(ref.bins), rtol=1e-5,
                               atol=1e-5)
    assert float(grid.bins.max()) > 2.0 and grid.bins.shape == (RES ** 3, 108)


def test_sample_matches_jax():
    j = jscenes.museum()
    ref_grid = _jax_grid(j, jtrace.prepare(j), n_batches=3)
    grid = _carry(ref_grid)
    r = np.random.default_rng(4)
    lo, hi = np.asarray(ref_grid.lo), np.asarray(ref_grid.hi)
    n = 4000
    p = r.uniform(lo, hi, (n, 3)).astype(np.float32)
    p[:200] = lo + (hi - lo) * r.uniform(-0.2, 1.2, (200, 3)).astype(np.float32)  # some outside
    rid = r.integers(0, 2**31, n)
    slot = r.integers(0, 16, n) * 8 + 4
    lid0, pdf0 = (np.asarray(x) for x in jph.sample(
        ref_grid, jnp.asarray(p), jnp.uint32(9), jnp.asarray(rid, jnp.uint32),
        jnp.asarray(slot, jnp.uint32)))
    lid1, pdf1 = tph.sample(grid, torch.from_numpy(p), 9, torch.from_numpy(rid),
                            torch.from_numpy(slot))
    assert lid1.dtype == torch.int64 and not pdf1.requires_grad
    lid1, pdf1 = lid1.numpy(), pdf1.numpy()
    diff = np.nonzero(lid1 != lid0)[0]
    assert diff.size <= 4, f"{diff.size} light ids differ"
    same = lid1 == lid0
    np.testing.assert_allclose(pdf1[same], pdf0[same], rtol=1e-5)
    assert (np.abs(lid1[diff] - lid0[diff]) <= 1).all()       # a neighbouring CDF bin
    assert np.unique(lid1).size > 30 and pdf1.min() > 0.0
    outside = ((p < lo) | (p > hi)).any(-1)
    assert outside.sum() > 20
    np.testing.assert_allclose(pdf1[outside], 1.0 / 108)
    # the tables are built once per grid
    assert grid.tables() is grid.tables() and len(grid.tables()) == 3


def _per_path_rule(ref, out, S):
    (a0, c0, k0), (a1, c1, k1) = ref, out
    np.testing.assert_array_equal(c1, c0)
    assert int(c1.sum()) == S
    close = np.isclose(a1, a0, rtol=1e-3, atol=2e-3).all(-1)
    assert close.mean() >= 0.99, f"only {close.mean():.3f} of paths agree"
    np.testing.assert_allclose(a1.mean(0), a0.mean(0), atol=1e-3)
    assert int(k0.astype(np.int64).sum()) == int(k1.sum())


@pytest.mark.parametrize("debug", [False, True])
def test_render_queue_pnee_matches_jax(debug):
    """PNEE through ``render_queue`` on the museum, with the light-debug
    view as its second case."""
    j, t = jscenes.museum(), tscenes.museum()
    pj = jtrace.prepare(j)
    grid_j = _jax_grid(j, pj, n_batches=2)
    W = H = 16
    pix = np.arange(W * H, dtype=np.int32)
    kw = dict(max_bounces=5, is_debug_photons=debug)
    ref = jax.jit(lambda s: jint.render_queue(
        pj, j, JSettings(render_type=JType.PNEE, **kw), JCamera.create(*MUSEUM_CAMERA),
        jnp.asarray(pix), W, H, s, 64, photon_grid=grid_j))(jnp.uint32(7))
    out = tint.render_queue(
        ttrace.prepare(t), t, RenderSettings(render_type=RenderType.PNEE, **kw),
        Camera.create(*MUSEUM_CAMERA), torch.from_numpy(pix), W, H, 7, 64,
        photon_grid=_carry(grid_j))
    _per_path_rule([np.asarray(x) for x in ref], [x.numpy() for x in out], W * H)
    # the guided pick differs from the uniform one
    uni = tint.render_queue(
        ttrace.prepare(t), t, RenderSettings(render_type=RenderType.NORMAL_NEE, **kw),
        Camera.create(*MUSEUM_CAMERA), torch.from_numpy(pix), W, H, 7, 64)
    assert not np.allclose(uni[0].numpy(), out[0].numpy(), atol=1e-3)


def test_render_queue_flat_pnee_matches_jax():
    """PNEE through the flat wavefront on a clustered mesh scene."""
    j = jscenes.mesh_scene(jscenes.surface_mesh(10))
    t = tscenes.mesh_scene(tscenes.surface_mesh(10))
    kw = dict(group=64, min_count=64)
    pj = jbvh.attach_clusters(jtrace.prepare(j), j, **kw)
    pt = tbvh.attach_clusters(ttrace.prepare(t), t, **kw)
    assert pt.cluster is not None
    grid_j = _jax_grid(j, pj, n_batches=1, batch=2048, res=8)
    W = H = 12
    pix = np.arange(W * H, dtype=np.int32)
    ref = jwave.render_queue_flat(
        pj, j, JSettings(render_type=JType.PNEE, max_bounces=4),
        JCamera.create(*MESH_CAMERA), jnp.asarray(pix), W, H, jnp.uint32(3), 64,
        photon_grid=grid_j)
    out = twave.render_queue_flat(
        pt, t, RenderSettings(render_type=RenderType.PNEE, max_bounces=4),
        Camera.create(*MESH_CAMERA), torch.from_numpy(pix), W, H, 3, 64,
        photon_grid=_carry(grid_j))
    _per_path_rule([np.asarray(x) for x in ref], [x.numpy() for x in out], W * H)
    assert out[0].sum() > 0


def test_session_photon_budget_matches_jax():
    """A PNEE half spends its ticks on photons first: the emission loop,
    its seeds and its tick price follow the JAX session, so the grids and
    then the frames agree."""
    kw = dict(max_bounces=4, ray_batch_size=2048, regen_lanes=512, total_photons=5000,
              photon_grid_res=8)
    j = JSession(32, 32, scene_id=100, left=JSettings(render_type=JType.PNEE, **kw),
                 right=JSettings(render_type=JType.NORMAL_NEE, **kw))
    t = Session(32, 32, scene_id=100, left=RenderSettings(render_type=RenderType.PNEE, **kw),
                right=RenderSettings(render_type=RenderType.NORMAL_NEE, **kw), device="cpu")
    # 64 ticks buy one batch: not enough photons yet, no paths on the left
    assert j.left.compute(64) == t.left.compute(64) == 0
    assert int(t.left.photon_grid.num_photons) == int(j.left.photon_grid.num_photons) > 0
    assert not t.left._photons_done()
    assert j.compute(8192) == t.compute(8192) > 0
    assert t.left._photons_done()
    assert int(t.left.photon_grid.num_photons) == int(j.left.photon_grid.num_photons)
    np.testing.assert_allclose(t.left.photon_grid.bins.numpy(),
                               np.asarray(j.left.photon_grid.bins), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t.buffer.count.numpy(), np.asarray(j.buffer.count))
    a0, a1 = np.asarray(j.buffer.acc), t.buffer.acc.numpy()
    assert np.isclose(a1, a0, rtol=1e-3, atol=2e-3).all(-1).mean() >= 0.99
    assert j.num_bvh_hits == t.num_bvh_hits
    # a new scene drops the grid, a reset keeps it
    grid = t.left.photon_grid
    t.reset()
    assert t.left.photon_grid is grid
    t.update_scene(0)
    assert t.left.photon_grid is not grid and int(t.left.photon_grid.num_photons) == 0
    assert t.left.photon_grid.bins.shape == (8 ** 3, 108)
