"""The port's train step (``parallel.make_train_step``) against the JAX
package's on a one-device mesh, on the CPU.

The parity scene is the mesh scene (plane, a small triangle mesh, a
two-triangle area light): with triangles only, JAX's jitted step follows
the same arithmetic as its op-by-op run (``tests/test_torch_wavefront.py``),
so the jitted ``make_train_step`` is the reference.  One step's loss
agrees at rtol 1e-5 and each updated leaf's change at rtol 1e-4 /
atol 1e-5 * max|change| (the gradient, times the step size).

Also: the guards refuse, with the JAX package's messages, the preps
whose trace cannot carry a gradient or whose tables cannot follow a
moved light; the cluster prep with the lights left dense takes a light
step; and after a light step the kernels' tables hold the moved light.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from wasm_pathtracer_tpu.config import RenderSettings as JSettings
from wasm_pathtracer_tpu.config import RenderType as JType
from wasm_pathtracer_tpu.models import scenes as jscenes
from wasm_pathtracer_tpu.models.camera import Camera as JCamera
from wasm_pathtracer_tpu.ops import trace as jtrace
from wasm_pathtracer_tpu.parallel import make_ray_mesh
from wasm_pathtracer_tpu.parallel import make_train_step as jmake_train_step
from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models import scenes as tscenes
from wasm_pathtracer_tpu_torch.models.camera import Camera
from wasm_pathtracer_tpu_torch.models.scene import TENSOR_FIELDS, scene_from_numpy
from wasm_pathtracer_tpu_torch.ops import bvh as tbvh
from wasm_pathtracer_tpu_torch.ops import integrator as tintegrator
from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
from wasm_pathtracer_tpu_torch.ops import trace as ttrace
from wasm_pathtracer_tpu_torch.parallel import make_ray_mesh as tmake_ray_mesh
from wasm_pathtracer_tpu_torch.parallel import make_train_step

from tests.torch_port_helpers import one_thread  # noqa: F401 (a fixture)

W = H = 16
# the one-member mesh: one process on the CPU
CPU = tmake_ray_mesh(device="cpu")
CAMERA = ((0.0, 1.0, -6.0), 0.1, 0.0)


def _to_torch(scene):
    return scene_from_numpy({k: np.asarray(getattr(scene, k)) for k in TENSOR_FIELDS},
                            scene.num_inf, scene.num_shapes, scene.num_lights,
                            scene.num_plights, device="cpu")


def _target():
    r = np.random.default_rng(4)
    return r.uniform(0.0, 0.4, (H, W, 3)).astype(np.float32)


# make_train_step keywords; "adam" trains with Adam (optax's in JAX)
CASES = {
    "materials_camera": dict(train_materials=True, train_camera=True, lr=0.5),
    "lights_cross": dict(train_lights=True, train_materials=False, train_camera=False,
                         lr=0.5, spp=2),
    "adam": dict(train_materials=True, train_camera=True),
}


def _steps(case, n_steps):
    """``n_steps`` steps of both packages from the same scene, camera,
    target and seeds; returns their (loss, scene, camera) after each."""
    j = jscenes.mesh_scene(jscenes.surface_mesh(6))
    # the mesh's albedo 0.9 would put first bounces' Russian-roulette
    # keep chance on the default clamp bound 0.9, a kink of the
    # estimator: there a one-ulp difference in a bounce's throughput
    # (sin and cos of two libraries, or XLA's FMA) picks the other side
    # of the kink, and JAX's jitted and op-by-op gradients differ there
    # by 3e-3 themselves.  At 0.95 no path sits on it.
    js = JSettings(render_type=JType.NORMAL_NEE, max_bounces=3, early_exit=False,
                   rr_clamp_max=0.95)
    ts = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=3,
                        rr_clamp_max=0.95)
    kw = CASES[case]
    jopt = topt = None
    if case == "adam":
        jopt = optax.adam(0.02)
        topt = lambda params: torch.optim.Adam(params, lr=0.02)  # noqa: E731
    jstep = jmake_train_step(make_ray_mesh(jax.devices()[:1]), jtrace.prepare(j), js,
                             W, H, optimizer=jopt, **kw)
    t = _to_torch(j)
    tstep = make_train_step(CPU, ttrace.prepare(t), ts, W, H, optimizer=topt, **kw)
    target = _target()
    jcam, tcam = JCamera.create(*CAMERA), Camera.create(*CAMERA, device="cpu")
    jsc, tsc = j, t
    state = jstep.init(j, jcam) if jopt is not None else None
    out = []
    for k in range(n_steps):
        seed = 5 + 11 * k
        if jopt is None:
            jl, jsc, jcam = jstep(jsc, jcam, jnp.asarray(target), jnp.uint32(seed))
        else:
            jl, jsc, jcam, state = jstep(jsc, jcam, jnp.asarray(target), jnp.uint32(seed),
                                         state)
        tl, tsc, tcam = tstep(tsc, tcam, torch.from_numpy(target), seed)
        out.append(((jl, jsc, jcam), (tl, tsc, tcam)))
    return j, out


def _assert_step_close(before_j, after_j, after_t, leaves):
    for name, get in leaves.items():
        b = np.asarray(get(before_j))
        want = np.asarray(get(after_j[0])) - b
        got = np.asarray(get(after_t[0])) - b
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


def _leaf_getters(case):
    scene_leaves = {
        "materials_camera": dict(albedo=lambda s: s.albedo, emission=lambda s: s.emission),
        "lights_cross": dict(light_rows=lambda s: np.asarray(s.params)[np.asarray(s.light_shape)]),
        "adam": dict(albedo=lambda s: s.albedo, emission=lambda s: s.emission),
    }[case]
    return scene_leaves


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(case):
    """One step (two with Adam, whose state then matters): the loss and
    every updated leaf, scene and camera."""
    n = 2 if case == "adam" else 1
    j, out = _steps(case, n)
    before = j
    cam0 = JCamera.create(*CAMERA)
    for k, ((jl, jsc, jcam), (tl, tsc, tcam)) in enumerate(out):
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        _assert_step_close(before, (jsc,), (tsc,), _leaf_getters(case))
        if CASES[case].get("train_camera"):
            for f in ("location", "rot_x", "rot_y"):
                b = np.asarray(getattr(cam0, f))
                want = np.asarray(getattr(jcam, f)) - b
                got = getattr(tcam, f).numpy() - b
                np.testing.assert_allclose(got, want, rtol=1e-4,
                                           atol=1e-5 * max(np.abs(want).max(), 1e-12))
        else:
            assert torch.equal(tcam.location, torch.tensor(CAMERA[0]))
        before, cam0 = jsc, jcam
    assert (np.asarray(out[-1][1][1].albedo) >= 0).all()


def _mesh_scene(n=24):
    return tscenes.mesh_scene(tscenes.surface_mesh(n), device="cpu")


def test_train_step_guards():
    """The refusals of the JAX package, with its messages, and the dense
    triangle sweep (Pallas without a VJP in the JAX package)."""
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=3)
    scene = _mesh_scene(8)
    dense = ttrace.prepare(scene)
    with pytest.raises(ValueError, match=r"requires a dense or cluster ScenePrep \(no attached BVH\)"):
        make_train_step(CPU, tbvh.attach_bvh(dense, scene), st, W, H, train_lights=True,
                        train_camera=False)
    baked = tbvh.attach_clusters(dense, scene, min_count=64)
    assert baked.cluster.has_baked_lights
    with pytest.raises(ValueError, match="exclude_lights=True"):
        make_train_step(CPU, baked, st, W, H, train_lights=True, train_materials=False,
                        train_camera=False)
    with pytest.raises(ValueError, match="cluster traversal while_loop is not"):
        make_train_step(CPU, baked, st, W, H)
    with pytest.raises(ValueError, match="no use_pallas dense sweep"):
        make_train_step(CPU, ttrace.prepare(scene, use_pallas=True), st, W, H)
    with pytest.raises(ValueError, match="edge_aware_screen=True requires the dense"):
        make_train_step(CPU, ttrace.prepare(scene, use_pallas=True), st, W, H,
                        train_camera=False, edge_aware_screen=True)
    # materials alone need no geometry gradient: a sweep prep is fine
    make_train_step(CPU, ttrace.prepare(scene, use_pallas=True), st, W, H, train_camera=False)


def test_train_lights_cluster_prep_guard_and_step():
    """``tests/test_grads.py``'s mesh-scale light step: the lights kept
    out of the baked cluster tables, one finite step that moves them."""
    scene = _mesh_scene()
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=3)
    prep = tbvh.attach_clusters(ttrace.prepare(scene), scene, min_count=64,
                                exclude_lights=True)
    assert prep.cluster is not None and not prep.cluster.has_baked_lights
    step = make_train_step(CPU, prep, st, W, H, lr=0.01, train_lights=True,
                           train_materials=False, train_camera=False)
    target = torch.zeros((H, W, 3)) + 0.2
    loss, scene2, _ = step(scene, Camera.create(*CAMERA, device="cpu"), target, 5)
    assert np.isfinite(float(loss))
    rows = scene2.params[scene2.light_shape.long()]
    assert torch.isfinite(rows).all()
    assert not torch.equal(rows, scene.params[scene.light_shape.long()])


def test_tables_follow_a_light_step(monkeypatch):
    """The step after a light step renders with tables gathered from the
    moved shape table (those of a prep made afresh from the returned
    scene), not the tables of the prep it was built with.
    ``refresh_tables`` after a light lift makes the nearest hits (K1's
    plain version here) see the light where it now is."""
    seen = []
    render = tintegrator.render_pixels

    def spy(prep_, *args, **kw):
        seen.append(prep_.tables.flat.clone())
        return render(prep_, *args, **kw)

    monkeypatch.setattr(tintegrator, "render_pixels", spy)
    scene = _mesh_scene(6)
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=2)
    prep = ttrace.prepare(scene)
    step = make_train_step(CPU, prep, st, W, H, lr=50.0, train_lights=True,
                           train_materials=False, train_camera=False)
    target = torch.zeros((H, W, 3)) + 5.0
    _, moved, cam = step(scene, Camera.create(*CAMERA, device="cpu"), target, 3)
    lid = moved.light_shape.long()
    assert (moved.params[lid] - scene.params[lid]).abs().max() > 1e-3
    step(moved, cam, target, 4)
    assert len(seen) == 2 and torch.equal(seen[0], prep.tables.flat)
    assert torch.equal(seen[1], ttrace.prepare(moved).tables.flat)
    assert not torch.equal(seen[1], prep.tables.flat)

    rows = scene.params[lid].clone()
    rows[:, 1::3] += 0.5
    lifted = scene.with_light_rows(rows)
    fresh, refreshed = ttrace.prepare(lifted), ttrace.refresh_tables(prep, lifted)
    # rays straight up at the lights' centroids
    c = rows.reshape(-1, 3, 3).mean(1)
    o = c - torch.tensor([0.0, 3.0, 0.0])
    d = torch.tensor([[0.0, 1.0, 0.0]]).expand_as(o).contiguous()
    t_new, sid_new = sk.fused_nearest(refreshed.tables, o, d, refreshed.sid_of_slot)
    want = sk.fused_nearest(fresh.tables, o, d, fresh.sid_of_slot)
    assert torch.equal(t_new, want[0]) and torch.equal(sid_new, want[1])
    torch.testing.assert_close(t_new, torch.full_like(t_new, 3.0))
    t_old, _ = sk.fused_nearest(prep.tables, o, d, prep.sid_of_slot)
    torch.testing.assert_close(t_old, torch.full_like(t_old, 2.5))


def _example_output(main, argv, capsys):
    """(exit code, initial albedo error as printed, [(loss, max albedo
    error) of each printed step]) of an inverse-render example's run."""
    rc = main(argv)
    out = capsys.readouterr().out
    steps = [(float(line.split()[3]), float(line.split()[7])) for line in out.splitlines()
             if line.startswith("step")]
    init = [line.split()[3] for line in out.splitlines()
            if line.startswith("max albedo error:")]
    return rc, init, steps


def test_inverse_render_example_runs(capsys, monkeypatch, one_thread):
    """The port's inverse-render example against the JAX package's
    (``examples/inverse_render.py``) at 2 steps of a 12x12 frame on the
    CPU: the same verdict, the same initial albedo error, and every
    printed loss and albedo error equal to the printed precision (5 and
    3 decimals; the two packages sum in other orders).  The JAX example
    runs as written, but for its ``render_image_sharded`` calls run under
    ``jax.jit``: called eagerly, ``shard_map`` dispatches op by op, about
    three minutes of this test on the CPU; jit changes no printed digit."""
    import wasm_pathtracer_tpu.parallel as jparallel
    from wasm_pathtracer_tpu_torch.examples import inverse_render
    eager, jitted = jparallel.render_image_sharded, {}

    def render_jitted(mesh, prep, scene, st, cam, width, height, seed, spp=1):
        key = (id(mesh), id(prep), st, width, height, spp)
        if key not in jitted:
            jitted[key] = jax.jit(lambda scene, cam, seed: eager(
                mesh, prep, scene, st, cam, width, height, seed, spp=spp))
        return jitted[key](scene, cam, seed)

    monkeypatch.setattr(jparallel, "render_image_sharded", render_jitted)
    spec = importlib.util.spec_from_file_location(
        "jax_inverse_render", pathlib.Path(__file__).parents[1] / "examples/inverse_render.py")
    jax_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_example)
    argv = ["--steps", "2", "--size", "12"]
    j_rc, j_init, j_steps = _example_output(jax_example.main, argv, capsys)
    assert len(jitted) == 2
    rc, init, steps = _example_output(inverse_render.main, ["--device", "cpu"] + argv, capsys)
    assert rc == j_rc and rc in (0, 1)
    assert len(init) == 1 and init == j_init
    assert len(steps) == len(j_steps) == 2 and np.isfinite(steps).all()
    np.testing.assert_allclose([s[0] for s in steps], [s[0] for s in j_steps],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose([s[1] for s in steps], [s[1] for s in j_steps],
                               rtol=0, atol=1e-3)
