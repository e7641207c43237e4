"""The port's pixel-sharded renderers and train step
(``wasm_pathtracer_tpu_torch.parallel.shard``) on the CPU.

- Against the JAX package: ``render_image_sharded`` on the one-member
  mesh against JAX's on a 2-device mesh; ``render_queue_sharded`` (NEE,
  and PNEE on a JAX photon grid carried across) and
  ``render_queue_flat_sharded`` against JAX's unsharded loops, which
  ``tests/test_sharding.py`` holds equal to its sharded ones; the train
  step on 2 gloo ranks against JAX's on a 2-device mesh.  Tolerances are
  those of the files these mirror: ``test_torch_integrator.py``'s per-path
  rule, ``test_torch_wavefront.py``'s 2e-5, ``test_torch_train.py``'s.
- Across rank counts: 2 and 3 gloo ranks (spawned processes over a
  ``FileStore``) against the port's one-member mesh.  Every path's stream
  is keyed by its global index, so counts are exact, and with one sample
  per pixel each pixel's sum is one path's radiance, equal bit for bit
  (x + 0 is exact).  With three samples a pixel's paths may sit on other
  ranks and be summed in another order: rtol 1e-5, atol 1e-6 (JAX's
  ``test_sharding.py``).  An image pixel's samples stay on its rank, so
  images are equal bit for bit at any sample count.
- The ranks of a train step hold bit-identical leaves after SGD and Adam.

Spawned ranks import this module, so it imports only numpy, torch and
the port at the top; JAX is imported inside the tests.  Every join has a
deadline.
"""

import os
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models import scenes as tscenes
from wasm_pathtracer_tpu_torch.models.camera import Camera
from wasm_pathtracer_tpu_torch.ops import bvh as tbvh
from wasm_pathtracer_tpu_torch.ops import photon as tph
from wasm_pathtracer_tpu_torch.ops import trace as ttrace
from wasm_pathtracer_tpu_torch.parallel import (make_ray_mesh, make_train_step,
                                                render_image_sharded,
                                                render_queue_flat_sharded,
                                                render_queue_sharded)

SP_CAMERA = ((0.0, 1.5, -2.0), 0.25, 0.0)
CLOUD_CAMERA = ((0.0, 0.5, -2.0), 0.05, 0.0)
MESH_CAMERA = ((0.0, 1.0, -6.0), 0.1, 0.0)
CLUSTERS = dict(group=64, min_count=64)
# seconds a spawned world may take, start-up included
DEADLINE = 150


def spawn_worlds(fn, tmps, deadline: float = DEADLINE):
    """Run ``fn(rank, world, tmp)`` in ``world`` spawned processes for each
    ``{world: tmp}`` of ``tmps``, all side by side, and wait for every one,
    each world at most ``deadline`` seconds from its start.  A rank that
    raises or exits non-zero fails the caller, as does a deadline."""
    ctxs = [(mp.start_processes(fn, args=(w, str(t)), nprocs=w, join=False,
                                start_method="spawn"), time.monotonic() + deadline)
            for w, t in tmps.items()]
    try:
        for ctx, end in ctxs:
            while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
                if time.monotonic() >= end:
                    raise AssertionError(f"spawned ranks did not finish in {deadline} s")
    finally:
        for ctx, _ in ctxs:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)


def init_gloo(rank, world, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world, timeout=timedelta(seconds=60))


def _sp():
    scene = tscenes.sphere_plane(device="cpu")
    return scene, ttrace.prepare(scene), Camera.create(*SP_CAMERA, device="cpu")


def case_dense(mesh, spp, rt=RenderType.NORMAL_NEE, photon_grid=None, lanes=128):
    """sphere_plane 16x16, 6 bounces, ``spp`` paths a pixel."""
    scene, prep, cam = _sp()
    st = RenderSettings(render_type=rt, max_bounces=6)
    pix = torch.arange(16 * 16).repeat(spp)
    return render_queue_sharded(mesh, prep, scene, st, cam, pix, 16, 16, 5, lanes,
                                photon_grid=photon_grid)


def case_flat(mesh, spp, lanes=64):
    """cloud(96) clustered, 16x16, 5 bounces, ``spp`` paths a pixel."""
    scene = tscenes.cloud(96, device="cpu")
    prep = tbvh.attach_clusters(ttrace.prepare(scene), scene, **CLUSTERS)
    assert prep.cluster is not None
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=5)
    pix = torch.arange(16 * 16).repeat(spp)
    cam = Camera.create(*CLOUD_CAMERA, device="cpu")
    return render_queue_flat_sharded(mesh, prep, scene, st, cam, pix, 16, 16, 11, lanes)


def case_image(mesh, spp, W=16, H=16, max_bounces=4, seed=9):
    scene, prep, cam = _sp()
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=max_bounces)
    return render_image_sharded(mesh, prep, scene, st, cam, W, H, seed, spp=spp)


def case_ragged(mesh):
    """37 paths on an 8x8 frame: 37 is no multiple of 2 or 3."""
    scene, prep, cam = _sp()
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=4)
    return render_queue_sharded(mesh, prep, scene, st, cam, torch.arange(37), 8, 8, 2, 32)


def _queue_arrays(out):
    return dict(acc=out[0].numpy(), cnt=out[1].numpy(), cost=out[2].numpy())


# name: mesh -> {array name: array}
WORLD_CASES = {
    "dense_spp1": lambda m: _queue_arrays(case_dense(m, 1)),
    "dense_spp3": lambda m: _queue_arrays(case_dense(m, 3)),
    "flat_spp1": lambda m: _queue_arrays(case_flat(m, 1)),
    "flat_spp3": lambda m: _queue_arrays(case_flat(m, 3)),
    "image_spp1": lambda m: dict(img=case_image(m, 1).numpy()),
    "image_spp3": lambda m: dict(img=case_image(m, 3).numpy()),
    "ragged": lambda m: _queue_arrays(case_ragged(m)),
}

# the train step: test_torch_train.py's "materials_camera" case
TRAIN_W = TRAIN_H = 16


def _train_setup():
    scene = tscenes.mesh_scene(tscenes.surface_mesh(6), device="cpu")
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=3, rr_clamp_max=0.95)
    target = np.random.default_rng(4).uniform(0.0, 0.4, (TRAIN_H, TRAIN_W, 3))
    return scene, st, torch.from_numpy(target.astype(np.float32))


def _leaves(loss, scene, cam):
    return dict(loss=np.asarray(float(loss)), albedo=scene.albedo.numpy(),
                emission=scene.emission.numpy(), location=cam.location.numpy(),
                rot_x=cam.rot_x.numpy(), rot_y=cam.rot_y.numpy())


def case_train(mesh):
    """One SGD step at lr 0.5, and two Adam steps (lr 0.02), on
    albedo, emission and camera."""
    scene, st, target = _train_setup()
    prep = ttrace.prepare(scene)
    out = {}
    sgd = make_train_step(mesh, prep, st, TRAIN_W, TRAIN_H, lr=0.5)
    out.update({f"sgd_{k}": v for k, v in _leaves(
        *sgd(scene, Camera.create(*MESH_CAMERA, device="cpu"), target, 5)).items()})
    adam = make_train_step(mesh, prep, st, TRAIN_W, TRAIN_H,
                           optimizer=lambda p: torch.optim.Adam(p, lr=0.02))
    sc, cam = scene, Camera.create(*MESH_CAMERA, device="cpu")
    for seed in (5, 16):
        loss, sc, cam = adam(sc, cam, target, seed)
    out.update({f"adam_{k}": v for k, v in _leaves(loss, sc, cam).items()})
    return out


def _rank_main(rank, world, tmp):
    """One rank: every case of ``WORLD_CASES`` and the train step, written
    to ``rank<r>.npz`` in ``tmp``."""
    init_gloo(rank, world, tmp)
    try:
        mesh = make_ray_mesh(device="cpu")
        assert (mesh.rank, mesh.size) == (rank, world)
        out = {}
        for name, fn in WORLD_CASES.items():
            out.update({f"{name}/{k}": v for k, v in fn(mesh).items()})
        out.update({f"train/{k}": v for k, v in case_train(mesh).items()})
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: [each rank's {key: array}]} for 2 and 3 gloo ranks,
    the two worlds run side by side."""
    tmps = {w: tmp_path_factory.mktemp(f"world{w}") for w in (2, 3)}
    spawn_worlds(_rank_main, tmps)
    return {w: [dict(np.load(t / f"rank{r}.npz")) for r in range(w)]
            for w, t in tmps.items()}


@pytest.fixture(scope="module")
def world1():
    """The same cases on the one-member mesh, in this process."""
    mesh = make_ray_mesh(device="cpu")
    assert mesh.group is None and mesh.size == 1
    return {name: fn(mesh) for name, fn in WORLD_CASES.items()}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", sorted(WORLD_CASES))
def test_world_matches_one_member_mesh(worlds, world1, case, world):
    ref = world1[case]
    for r, got in enumerate(worlds[world]):
        out = {k.split("/", 1)[1]: v for k, v in got.items() if k.startswith(case + "/")}
        assert set(out) == set(ref)
        if "img" in ref:
            assert out["img"].shape == (16, 16, 3)
            np.testing.assert_array_equal(out["img"], ref["img"], err_msg=f"rank {r}")
            continue
        np.testing.assert_array_equal(out["cnt"], ref["cnt"], err_msg=f"rank {r}")
        # the cost counts the pad paths' tests too (as JAX's does): equal
        # where the queue needs no pad
        if out["cnt"].sum() % world == 0:
            np.testing.assert_array_equal(out["cost"], ref["cost"], err_msg=f"rank {r}")
        else:
            assert out["cost"] >= ref["cost"]
        if case.endswith("spp3"):
            np.testing.assert_allclose(out["acc"], ref["acc"], rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(out["acc"], ref["acc"], err_msg=f"rank {r}")
        assert out["acc"].sum() > 0
    if case == "ragged":
        cnt = ref["cnt"]
        assert (cnt[:37] == 1).all() and (cnt[37:] == 0).all()
    elif "img" not in ref:
        spp = 3 if case.endswith("spp3") else 1
        assert (ref["cnt"] == spp).all()


@pytest.mark.parametrize("world", [2, 3])
def test_train_ranks_agree(worlds, world):
    """After an SGD step and two Adam steps every rank holds the same
    leaves, bit for bit, and they moved."""
    ranks = [{k: v for k, v in got.items() if k.startswith("train/")}
             for got in worlds[world]]
    for other in ranks[1:]:
        assert set(other) == set(ranks[0])
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)
    scene, _, _ = _train_setup()
    for opt in ("sgd", "adam"):
        assert not np.array_equal(ranks[0][f"train/{opt}_albedo"], scene.albedo.numpy())
        assert np.isfinite(ranks[0][f"train/{opt}_loss"])


def test_train_step_matches_jax(worlds):
    """One SGD step on 2 gloo ranks against JAX's on a 2-device mesh: the
    loss (rtol 1e-5) and each leaf's change (rtol 1e-4, atol 1e-5 of the
    largest change)."""
    import jax
    import jax.numpy as jnp
    from wasm_pathtracer_tpu.config import RenderSettings as JSettings
    from wasm_pathtracer_tpu.config import RenderType as JType
    from wasm_pathtracer_tpu.models import scenes as jscenes
    from wasm_pathtracer_tpu.models.camera import Camera as JCamera
    from wasm_pathtracer_tpu.ops import trace as jtrace
    from wasm_pathtracer_tpu.parallel import make_ray_mesh as jmake_ray_mesh
    from wasm_pathtracer_tpu.parallel import make_train_step as jmake_train_step

    j = jscenes.mesh_scene(jscenes.surface_mesh(6))
    js = JSettings(render_type=JType.NORMAL_NEE, max_bounces=3, early_exit=False,
                   rr_clamp_max=0.95)
    step = jmake_train_step(jmake_ray_mesh(jax.devices()[:2]), jtrace.prepare(j), js,
                            TRAIN_W, TRAIN_H, lr=0.5)
    cam0 = JCamera.create(*MESH_CAMERA)
    _, _, target = _train_setup()
    jl, jsc, jcam = step(j, cam0, jnp.asarray(target.numpy()), jnp.uint32(5))
    got = worlds[2][0]
    np.testing.assert_allclose(float(got["train/sgd_loss"]), float(jl), rtol=1e-5)
    pairs = dict(albedo=(j.albedo, jsc.albedo), emission=(j.emission, jsc.emission),
                 location=(cam0.location, jcam.location), rot_x=(cam0.rot_x, jcam.rot_x),
                 rot_y=(cam0.rot_y, jcam.rot_y))
    for name, (before, after) in pairs.items():
        b = np.asarray(before)
        want = np.asarray(after) - b
        np.testing.assert_allclose(got[f"train/sgd_{name}"] - b, want, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-12),
                                   err_msg=name)


def test_image_matches_jax():
    """The one-member mesh's frame against JAX's on a 2-device mesh:
    sphere_plane 8x8, NEE, 3 bounces; per-path rule (rtol 1e-3, atol
    2e-3 on >= 99% of pixels)."""
    import jax
    import jax.numpy as jnp
    from wasm_pathtracer_tpu.config import RenderSettings as JSettings
    from wasm_pathtracer_tpu.config import RenderType as JType
    from wasm_pathtracer_tpu.models import scenes as jscenes
    from wasm_pathtracer_tpu.models.camera import Camera as JCamera
    from wasm_pathtracer_tpu.ops import trace as jtrace
    from wasm_pathtracer_tpu.parallel import make_ray_mesh as jmake_ray_mesh
    from wasm_pathtracer_tpu.parallel import render_image_sharded as jrender

    j = jscenes.sphere_plane()
    ref = np.asarray(jrender(jmake_ray_mesh(jax.devices()[:2]), jtrace.prepare(j), j,
                             JSettings(render_type=JType.NORMAL_NEE, max_bounces=3),
                             JCamera.create(*SP_CAMERA), 8, 8, jnp.uint32(9)))
    out = case_image(make_ray_mesh(device="cpu"), 1, W=8, H=8, max_bounces=3).numpy()
    assert out.shape == ref.shape == (8, 8, 3)
    close = np.isclose(out, ref, rtol=1e-3, atol=2e-3).all(-1)
    assert close.mean() >= 0.99, f"only {close.mean():.3f} of pixels agree"
    assert out.sum() > 0


def _jax_queue_reference(kind):
    """(acc, cnt, cost) of JAX's unsharded loop for ``kind``, and the
    port's photon grid for PNEE (the JAX grid carried across)."""
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

    pix = jnp.arange(16 * 16, dtype=jnp.int32)
    if kind == "flat":
        j = jscenes.cloud(96)
        prep = jbvh.attach_clusters(jtrace.prepare(j), j, **CLUSTERS)
        out = jax.jit(lambda s: jwave.render_queue_flat(
            prep, j, JSettings(render_type=JType.NORMAL_NEE, max_bounces=5),
            JCamera.create(*CLOUD_CAMERA), pix, 16, 16, s, 64))(jnp.uint32(11))
        return [np.asarray(x) for x in out], None
    j = jscenes.sphere_plane()
    prep = jtrace.prepare(j)
    grid = tgrid = None
    rt = JType.PNEE if kind == "pnee" else JType.NORMAL_NEE
    if kind == "pnee":
        lo, hi = jph.grid_bounds_for_scene(j, JSettings(render_type=JType.PNEE))
        grid = jph.PhotonGrid.create(j.num_lights, lo, hi, 8)
        grid = jph.emit_photons(grid, prep, j, JSettings(render_type=JType.PNEE),
                                jnp.uint32(100), 2048)
        tgrid = tph.photon_grid_from_numpy(
            {k: np.asarray(getattr(grid, k)) for k in ("bins", "lo", "hi", "num_photons")},
            grid.res, device="cpu")
    out = jax.jit(lambda s: jint.render_queue(
        prep, j, JSettings(render_type=rt, max_bounces=6), JCamera.create(*SP_CAMERA),
        pix, 16, 16, s, 64, photon_grid=grid))(jnp.uint32(5))
    return [np.asarray(x) for x in out], tgrid


@pytest.mark.parametrize("kind", ["dense", "pnee", "flat"])
def test_queue_matches_jax(kind):
    """The one-member mesh's sharded queue against JAX's unsharded loop,
    one path a pixel: counts and the primitive-test total exact; radiance
    by the per-path rule (dense, PNEE) or within rtol/atol 2e-5 (flat)."""
    (a0, c0, k0), grid = _jax_queue_reference(kind)
    mesh = make_ray_mesh(device="cpu")
    if kind == "flat":
        out = case_flat(mesh, 1)
    else:
        out = case_dense(mesh, 1, rt=RenderType.PNEE if kind == "pnee"
                         else RenderType.NORMAL_NEE, photon_grid=grid, lanes=64)
    a1, c1, k1 = (x.numpy() for x in out)
    np.testing.assert_array_equal(c1, c0)
    assert (c1 == 1).all()
    assert int(k1) == int(k0.astype(np.int64).sum())
    if kind == "flat":
        np.testing.assert_allclose(a1, a0, rtol=2e-5, atol=2e-5)
    else:
        close = np.isclose(a1, a0, rtol=1e-3, atol=2e-3).all(-1)
        assert close.mean() >= 0.99, f"only {close.mean():.3f} of paths agree"
        np.testing.assert_allclose(a1.mean(0), a0.mean(0), atol=1e-3)
    assert a1.sum() > 0
