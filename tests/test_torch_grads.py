"""The port's gradients against the JAX package's, on the CPU.

The port takes each ray's hit from the kernels (their plain versions
here) on detached rays and re-evaluates the winner's distance under
autograd; the JAX package differentiates its dense XLA trace through
``argmin`` to the same winner.  Both hold discrete choices (the shape
hit, the occlusion verdict, the RNG draws) constant, so the gradients
are those of one function.  Scenes with spheres or tori are compared
against JAX run op by op (``jax.disable_jit()``): jitted XLA contracts
their quadratics and the torus march to FMA (``tests/test_torch_wavefront.py``).

Tolerances: per leaf rtol 1e-4 and atol 1e-5 * max|g| (float32
reductions are summed in another order on each side); the re-evaluated
distance equals the discrete trace's bit for bit.  The finite-difference
contracts of ``tests/test_grads.py`` are mirrored as ``slow`` tests.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wasm_pathtracer_tpu.config import RenderSettings as JSettings
from wasm_pathtracer_tpu.config import RenderType as JType
from wasm_pathtracer_tpu.models import scenes as jscenes
from wasm_pathtracer_tpu.models.camera import Camera as JCamera
from wasm_pathtracer_tpu.models.scene import Material as JMaterial
from wasm_pathtracer_tpu.models.scene import SceneBuilder as JBuilder
from wasm_pathtracer_tpu.ops import integrator as jint
from wasm_pathtracer_tpu.ops import intersect as jisx
from wasm_pathtracer_tpu.ops import photon as jph
from wasm_pathtracer_tpu.ops import trace as jtrace
from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models.camera import Camera
from wasm_pathtracer_tpu_torch.models.scene import TENSOR_FIELDS, scene_from_numpy
from wasm_pathtracer_tpu_torch.ops import integrator as tint
from wasm_pathtracer_tpu_torch.ops import intersect as tisx
from wasm_pathtracer_tpu_torch.ops import photon as tph
from wasm_pathtracer_tpu_torch.ops import trace as ttrace

W = H = 16
SEEDS = (3, 17, 91, 222)
CAMERA = ((0.0, 1.5, -2.0), 0.25, 0.0)
LEAVES = ("albedo", "emission", "light_rows", "location", "rot_x", "rot_y")


def _to_torch(scene, device="cpu"):
    return scene_from_numpy({k: np.asarray(getattr(scene, k)) for k in TENSOR_FIELDS},
                            scene.num_inf, scene.num_shapes, scene.num_lights,
                            scene.num_plights, device=device)


def _leaf_values(j, camera):
    return dict(albedo=np.asarray(j.albedo), emission=np.asarray(j.emission),
                light_rows=np.asarray(j.params[j.light_shape]),
                location=np.asarray(camera[0], np.float32),
                rot_x=np.float32(camera[1]), rot_y=np.float32(camera[2]))


def _jax_grads(j, st, camera, seed, grid=None):
    """(loss, grads by leaf) of mean radiance, JAX op by op."""
    prep = jtrace.prepare(j)
    pix = jnp.arange(W * H, dtype=jnp.int32)

    def loss(v):
        sc = j.with_materials(albedo=v["albedo"], emission=v["emission"])
        sc = sc.with_light_rows(v["light_rows"])
        cam = JCamera(location=v["location"], rot_x=v["rot_x"], rot_y=v["rot_y"])
        col, _ = jint.render_pixels(prep, sc, st, cam, pix % W, pix // W, W, H,
                                    jnp.uint32(seed), photon_grid=grid)
        return jnp.mean(col)

    v = {k: jnp.asarray(x) for k, x in _leaf_values(j, camera).items()}
    with jax.disable_jit():
        val, g = jax.value_and_grad(loss)(v)
    return float(val), {k: np.asarray(x) for k, x in g.items()}


def _torch_grads(j, st, camera, seed, grid=None, device="cpu"):
    """(loss, grads by leaf) of mean radiance through the port."""
    t = _to_torch(j, device)
    prep = ttrace.prepare(t)
    v = {k: torch.tensor(np.asarray(x), device=device).requires_grad_(True)
         for k, x in _leaf_values(j, camera).items()}
    sc = t.with_materials(albedo=v["albedo"], emission=v["emission"])
    sc = sc.with_light_rows(v["light_rows"])
    cam = Camera(v["location"], v["rot_x"], v["rot_y"])
    pix = torch.arange(W * H, device=device)
    col, _ = tint.render_pixels(prep, sc, st, cam, pix % W, pix // W, W, H, seed,
                                photon_grid=grid)
    loss = col.mean()
    g = torch.autograd.grad(loss, [v[k] for k in LEAVES])
    return float(loss), {k: x.cpu().numpy() for k, x in zip(LEAVES, g)}


def _assert_grads_close(got, want):
    for k in want:
        scale = float(np.max(np.abs(want[k])))
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=k)


def _settings(rt=1, max_bounces=5, **kw):
    return (JSettings(render_type=JType(rt), max_bounces=max_bounces,
                      early_exit=False, **kw),
            RenderSettings(render_type=RenderType(rt), max_bounces=max_bounces, **kw))


# ---------------------------------------------------------------------------
# The torus march's implicit-function-theorem gradient
# ---------------------------------------------------------------------------

def _torus_rays(n=96, seed=5):
    """Torus-local rays: a third aimed at random points of the tube, a
    third grazing the top of the tube, a third that miss."""
    r = np.random.default_rng(seed)
    Rb = r.uniform(0.8, 1.2, n)
    rb = r.uniform(0.2, 0.35, n)
    phi = r.uniform(0, 2 * np.pi, n)
    th = r.uniform(0, 2 * np.pi, n)
    kind = np.arange(n) % 3
    o = r.normal(size=(n, 3))
    o *= r.uniform(3, 4, (n, 1)) / np.linalg.norm(o, axis=1, keepdims=True)
    ring = Rb + rb * np.cos(th)
    tgt = np.stack([ring * np.cos(phi), rb * np.sin(th), ring * np.sin(phi)], 1)
    top = np.stack([Rb * np.cos(phi), rb * (1 - 2e-3), Rb * np.sin(phi)], 1)
    tangent = np.stack([-np.sin(phi), np.zeros(n), np.cos(phi)], 1)
    o = np.where((kind == 1)[:, None], top - 3 * tangent, o)
    tgt = np.where((kind == 1)[:, None], top, tgt)
    tgt = np.where((kind == 2)[:, None], tgt + np.array([0.0, 3.0, 0.0]), tgt)
    d = tgt - o
    # misses: radially outward from outside the torus's bounding sphere
    d = np.where((kind == 2)[:, None], o, d)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = r.uniform(0.5, 1.5, n)
    return [x.astype(np.float32) for x in (o, d, Rb, rb, w)]


def test_tori_march_gradient_matches_jax():
    """The IFT backward against ``jax.vjp`` of the JAX ``custom_vjp``:
    the same roots bit for bit, gradients with respect to the local
    origin, direction and both radii at rtol 1e-4, zero on misses."""
    o, d, Rb, rb, w = _torus_rays()
    with jax.disable_jit():
        t_j, vjp = jax.vjp(jisx.tori_march, *(jnp.asarray(x) for x in (o, d, Rb, rb)))
        g_j = vjp(jnp.asarray(w))
    args = [torch.from_numpy(x).requires_grad_(True) for x in (o, d, Rb, rb)]
    t_t = tisx.tori_march(*args)
    g_t = torch.autograd.grad(t_t, args, grad_outputs=torch.from_numpy(w))
    t_j, t_t = np.asarray(t_j), t_t.detach().numpy()
    hit = np.isfinite(t_j)
    kind = np.arange(len(o)) % 3
    assert hit[kind == 1].all() and not hit[kind == 2].any()
    np.testing.assert_array_equal(t_t, t_j)
    for got, want in zip(g_t, g_j):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
        assert (got[~hit] == 0).all()


def test_tori_march_refuses_a_second_derivative():
    """Like the JAX version's ``custom_vjp`` (which admits no
    forward-mode derivative), the IFT backward is differentiable once:
    a gradient of a gradient through a torus hit raises."""
    o, d, Rb, rb, _ = (torch.from_numpy(x[:12:3]) for x in _torus_rays(n=12))
    R = Rb.clone().requires_grad_(True)
    t = tisx.tori_march(o, d, R, rb)
    g = torch.autograd.grad((t * t).sum(), R, create_graph=True)[0]
    assert torch.isfinite(g).all()
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g.sum(), R)


# ---------------------------------------------------------------------------
# The winner's distance re-evaluated under autograd
# ---------------------------------------------------------------------------

def _all_families():
    """Every primitive family (``tests/test_torch_scene_kernels.py``'s
    synthetic scene)."""
    b = JBuilder(background=(0.1, 0.1, 0.1))
    r = np.random.default_rng(11)
    for _ in range(3):
        b.add_sphere(r.uniform(-2, 2, 3), 0.5, JMaterial.diffuse(0.6, 0.4, 0.3))
    b.add_plane((0, -2, 0), (0, 1, 0), JMaterial.diffuse(0.5, 0.5, 0.5))
    for _ in range(2):
        b.add_torus(r.uniform(-2, 2, 3), 0.8, 0.25, JMaterial.diffuse(0.7, 0.7, 0.2))
    lo = r.uniform(-2, 0, (2, 3))
    hi = lo + r.uniform(0.2, 1.0, (2, 3))
    for k in range(2):
        b.add_aarect(lo[k][0], hi[k][0], lo[k][1], hi[k][1], lo[k][2], hi[k][2],
                     JMaterial.diffuse(0.2, 0.6, 0.7))
    b.add_square((0.5, -1.0, 0.5), 1.5, JMaterial.diffuse(0.9, 0.2, 0.2))
    b.add_triangles(jscenes.triangle_cloud(5, seed=4), JMaterial.emissive(4.0, 4.0, 4.0))
    return b.build()


def _family_rays(j, n=1024, seed=3):
    """Rays from a sphere of radius 6 around the scene toward the
    anchors of its finite shapes (sphere and torus centres moved onto
    the surface, triangle centroids, box and square centres), a quarter
    toward random points (the plane), so every family is hit."""
    r = np.random.default_rng(seed)
    p = np.asarray(j.params)
    pt = np.asarray(j.ptype)
    anchors = []
    for row, kind in zip(p, pt):
        if kind == 1:
            anchors.append(row[:3] + row[3] * np.array([0.0, 0.9, 0.0]))
        elif kind == 2:
            anchors.append(row[:9].reshape(3, 3).mean(0))
        elif kind == 3:
            anchors.append(row[:3] + np.array([row[3], 0.0, 0.0]))
        elif kind == 4:
            anchors.append(0.5 * (row[:3] + row[3:6]))
        elif kind == 5:
            anchors.append(row[:3])
    anchors = np.array(anchors)
    o = r.normal(size=(n, 3))
    o *= 6.0 / np.linalg.norm(o, axis=-1, keepdims=True)
    tgt = anchors[r.integers(0, len(anchors), n)] + r.normal(scale=0.05, size=(n, 3))
    tgt = np.where((np.arange(n) % 4 == 0)[:, None], r.uniform(-2, 2, (n, 3)), tgt)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), \
        r.uniform(0.5, 1.5, n).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _winner_case():
    """JAX's dense trace and its VJP, and the port's discrete trace with
    the re-evaluated distance and its gradient, on the same rays."""
    j = _all_families()
    o, d, w = _family_rays(j)
    jprep = jtrace.prepare(j)

    def t_of(o_, d_, params):
        t, sid, hit, _ = jtrace.trace_scene(jprep, dataclasses.replace(j, params=params),
                                            o_, d_)
        return jnp.where(hit, t, 0.0), sid

    with jax.disable_jit():
        t_j, vjp, sid_j = jax.vjp(t_of, jnp.asarray(o), jnp.asarray(d), j.params,
                                  has_aux=True)
        g_j = vjp(jnp.asarray(w))

    t = _to_torch(j)
    prep = ttrace.prepare(t)
    t_d, sid_d, _, _ = ttrace.trace_scene(prep, t, torch.from_numpy(o), torch.from_numpy(d))
    args = [torch.from_numpy(o).requires_grad_(True),
            torch.from_numpy(d).requires_grad_(True),
            t.params.clone().requires_grad_(True)]
    sc = dataclasses.replace(t, params=args[2])
    t_r, sid_r, hit_r, _ = ttrace.trace_scene(prep, sc, args[0], args[1])
    g_t = torch.autograd.grad(torch.where(hit_r, t_r, 0.0), args,
                              grad_outputs=torch.from_numpy(w))
    return dict(ptype=np.asarray(j.ptype), sid_j=np.asarray(sid_j),
                g_j=[np.asarray(x) for x in g_j], t_disc=t_d.numpy(),
                sid_disc=sid_d.numpy(), t_re=t_r.detach().numpy(),
                sid_re=sid_r.numpy(), g_t=[x.numpy() for x in g_t])


def test_winner_t_equals_trace_t_bit_for_bit():
    """On the CPU the re-evaluated distance is the discrete trace's
    (the plain versions) exactly, for every family."""
    c = _winner_case()
    np.testing.assert_array_equal(c["sid_re"], c["sid_disc"])
    np.testing.assert_array_equal(c["t_re"], c["t_disc"])
    hit = c["sid_disc"] >= 0
    assert set(np.unique(c["ptype"][c["sid_disc"][hit]])) == set(range(6))


@pytest.mark.parametrize("family", range(6),
                         ids=["plane", "sphere", "triangle", "torus", "aarect", "square"])
def test_winner_t_gradient_matches_jax(family):
    """d t / d(o, d, params) of the rays whose winner is of ``family``
    against ``jax.vjp`` of JAX's dense ``trace_scene`` distance."""
    c = _winner_case()
    same = c["sid_j"] == c["sid_disc"]
    assert same.mean() > 0.999
    rays = same & (c["sid_disc"] >= 0) & (c["ptype"][np.maximum(c["sid_disc"], 0)] == family)
    assert rays.sum() >= 8
    for k in (0, 1):
        got, want = c["g_t"][k][rays], c["g_j"][k][rays]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    rows = c["ptype"] == family
    got, want = c["g_t"][2][rows], c["g_j"][2][rows]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_trace_scene_diff_off_the_autograd_path_is_trace_scene(monkeypatch):
    """Where nothing requires grad, ``trace_scene`` skips the
    re-evaluation: it returns the discrete trace, and the same trace
    under ``torch.no_grad`` of rays that require grad."""
    j = _all_families()
    t = _to_torch(j)
    prep = ttrace.prepare(t)
    o, d, _ = (torch.from_numpy(x) for x in _family_rays(j, 256))
    a = ttrace._trace_discrete(prep, t, o, d)
    with torch.no_grad():
        c = ttrace.trace_scene(prep, t, o.requires_grad_(), d)

    def no_reevaluation(*args):
        raise AssertionError("winner_t ran off the autograd path")

    monkeypatch.setattr(ttrace, "winner_t", no_reevaluation)
    b = ttrace.trace_scene(prep, t, o.detach(), d)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert not b[0].requires_grad and not c[0].requires_grad


# ---------------------------------------------------------------------------
# render_pixels: value and gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_render_pixels_gradients_match_jax(seed):
    """``tests/test_grads.py``'s setup (sphere_plane, 16x16, 5 bounces,
    NEE): mean radiance and its gradients with respect to albedo,
    emission, the light rows and the camera against ``jax.grad``; the
    port with per-bounce checkpointing on and off gives the same
    gradients."""
    j = jscenes.sphere_plane()
    js, ts = _settings()
    loss_j, g_j = _jax_grads(j, js, CAMERA, seed)
    loss_r, g_r = _torch_grads(j, ts, CAMERA, seed)
    loss_p, g_p = _torch_grads(j, ts.replace(checkpoint_bounces=False), CAMERA, seed)
    assert loss_r == loss_p
    for k in LEAVES:
        np.testing.assert_array_equal(g_r[k], g_p[k], err_msg=k)
    np.testing.assert_allclose(loss_r, loss_j, rtol=1e-5)
    _assert_grads_close(g_r, g_j)
    assert all(np.abs(g_j[k]).max() > 0 for k in LEAVES if k != "rot_y")


@functools.lru_cache(maxsize=1)
def _pnee_grid():
    """``tests/test_grads.py``'s PNEE grid, emitted by the port and
    carried into the JAX package's ``PhotonGrid``, so both sample the
    same histogram."""
    t = _to_torch(jscenes.sphere_plane())
    st = RenderSettings(render_type=RenderType.PNEE, max_bounces=4)
    lo, hi = tph.grid_bounds_for_scene(t, st)
    tgrid = tph.PhotonGrid.create(t.num_lights, lo, hi, st.photon_grid_res, device="cpu")
    for k in range(4):
        tgrid = tph.emit_photons(tgrid, ttrace.prepare(t), t, st, 900 + k, 2048)
    grid = jph.PhotonGrid(bins=jnp.asarray(tgrid.bins.numpy()), lo=jnp.asarray(tgrid.lo.numpy()),
                          hi=jnp.asarray(tgrid.hi.numpy()),
                          num_photons=jnp.int32(int(tgrid.num_photons)), res=tgrid.res)
    return grid, tgrid


def test_pnee_gradients_match_jax():
    """Gradients through the PNEE estimator (the photon grid's selection
    pdf is detached in both packages)."""
    j = jscenes.sphere_plane()
    grid, tgrid = _pnee_grid()
    assert int(grid.num_photons) > 0
    js, ts = _settings(rt=2, max_bounces=4, rr_clamp_min=0.9, rr_clamp_max=0.9)
    loss_j, g_j = _jax_grads(j, js, CAMERA, 17, grid=grid)
    loss_t, g_t = _torch_grads(j, ts, CAMERA, 17, grid=tgrid)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    _assert_grads_close(g_t, g_j)


def test_remat_recomputes_the_bounces(monkeypatch):
    """With checkpointing the backward pass runs each bounce's discrete
    trace again: twice the calls of the plain backward."""
    j = jscenes.sphere_plane()
    _, ts = _settings(max_bounces=3)
    calls = []
    real = ttrace.trace_scene

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ttrace, "trace_scene", counting)
    n = {}
    for remat in (False, True):
        calls.clear()
        _torch_grads(j, ts.replace(checkpoint_bounces=remat), CAMERA, 3)
        n[remat] = len(calls)
    assert n[True] == 2 * n[False] > 0


# ---------------------------------------------------------------------------
# Finite-difference contracts (``tests/test_grads.py``), port only
# ---------------------------------------------------------------------------

def _fd_vs_grad(loss, x0, direction, h, seeds=SEEDS):
    """Directional derivative: analytic against central finite
    differences, averaged over seeds (common random numbers)."""
    ana, fd = 0.0, 0.0
    for s in seeds:
        x = x0.clone().requires_grad_(True)
        g = torch.autograd.grad(loss(x, s), x)[0]
        ana += float(torch.sum(g * direction))
        with torch.no_grad():
            fd += (float(loss(x0 + h * direction, s))
                   - float(loss(x0 - h * direction, s))) / (2 * h)
    return ana / len(seeds), fd / len(seeds)


def _port_loss(j, st, camera, leaf, grid=None):
    t = _to_torch(j)
    prep = ttrace.prepare(t)
    pix = torch.arange(W * H)

    def loss(x, seed):
        sc = {"emission": lambda: t.with_materials(emission=x),
              "albedo": lambda: t.with_materials(albedo=x),
              "light_rows": lambda: t.with_light_rows(x)}[leaf]()
        p = prep if leaf != "light_rows" else ttrace.refresh_tables(prep, sc)
        col, _ = tint.render_pixels(p, sc, st, Camera.create(*camera, device="cpu"), pix % W,
                                    pix // W, W, H, seed, photon_grid=grid)
        return col.mean()

    return t, loss


def _light_scene():
    b = JBuilder(background=(0.1, 0.1, 0.1))
    b.add_plane((0.0, -1.0, 0.0), (0.0, 1.0, 0.0), JMaterial.diffuse(0.8, 0.8, 0.8))
    light = JMaterial.emissive(8.0, 8.0, 8.0)
    b.add_triangle((1.0, 4.0, 6.0), (1.0, 4.0, 4.0), (-1.0, 4.0, 4.0), light)
    b.add_triangle((-1.0, 4.0, 6.0), (1.0, 4.0, 6.0), (-1.0, 4.0, 4.0), light)
    return b.build()


@pytest.mark.slow
def test_emission_gradient_matches_fd():
    _, ts = _settings()
    t, loss = _port_loss(jscenes.sphere_plane(), ts, CAMERA, "emission")
    direction = torch.zeros_like(t.emission)
    direction[2:4] = 1.0
    ana, fd = _fd_vs_grad(loss, t.emission, direction, h=0.05)
    assert ana > 0
    assert abs(ana - fd) <= 0.02 * max(abs(fd), 1e-6) + 1e-5, (ana, fd)


@pytest.mark.slow
def test_albedo_gradient_matches_fd():
    _, ts = _settings(rr_clamp_min=0.9, rr_clamp_max=0.9)
    t, loss = _port_loss(jscenes.sphere_plane(), ts, CAMERA, "albedo")
    direction = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, tuple(t.albedo.shape)).astype(np.float32))
    ana, fd = _fd_vs_grad(loss, t.albedo, direction, h=5e-3)
    assert abs(ana - fd) <= 0.05 * max(abs(fd), 1e-6) + 1e-5, (ana, fd)


@pytest.mark.slow
def test_light_vertex_gradient_matches_fd():
    _, ts = _settings(max_bounces=4, rr_clamp_min=0.9, rr_clamp_max=0.9)
    j = _light_scene()
    t, loss = _port_loss(j, ts, ((0.0, 1.5, -2.0), 0.6, 0.0), "light_rows")
    rows0 = t.params[t.light_shape.long()]
    direction = torch.zeros_like(rows0)
    direction[:, 1::3] = 1.0
    ana, fd = _fd_vs_grad(loss, rows0, direction, h=2e-2)
    assert np.isfinite(ana) and ana != 0.0
    assert np.sign(ana) == np.sign(fd), (ana, fd)
    assert abs(ana - fd) <= 0.10 * max(abs(fd), 1e-5), (ana, fd)


@pytest.mark.slow
def test_light_vertex_gradient_with_occluder_matches_fd():
    """With the edge-aware NEE warp the light-lift gradient under the
    sphere's penumbra carries the shadow boundary's flux
    (``tests/test_grads.py``'s magnitude bound)."""
    _, ts = _settings(max_bounces=4, rr_clamp_min=0.9, rr_clamp_max=0.9,
                      edge_aware_nee=True)
    cam = ((0.0, 1.5, -2.0), 0.55, 0.0)
    j = jscenes.sphere_plane()
    t, loss_e = _port_loss(j, ts, cam, "light_rows")
    _, loss_p = _port_loss(j, ts.replace(edge_aware_nee=False), cam, "light_rows")
    rows0 = t.params[t.light_shape.long()]
    direction = torch.zeros_like(rows0)
    direction[:, 1::3] = 1.0
    h = 0.05
    fd, ana = [], []
    for s in range(24):
        sd = 11 + 97 * s
        x = rows0.clone().requires_grad_(True)
        ana.append(float(torch.sum(torch.autograd.grad(loss_e(x, sd), x)[0] * direction)))
        with torch.no_grad():
            fd.append((float(loss_p(rows0 + h * direction, sd))
                       - float(loss_p(rows0 - h * direction, sd))) / (2 * h))
    fd, ana = np.array(fd), np.array(ana)
    sem = fd.std() / np.sqrt(len(fd)) + ana.std() / np.sqrt(len(ana))
    assert np.isfinite(ana).all()
    assert np.sign(ana.mean()) == np.sign(fd.mean()), (ana.mean(), fd.mean())
    assert abs(ana.mean() - fd.mean()) <= 0.20 * abs(fd.mean()) + 2.5 * sem
    assert 0.5 < ana.mean() / fd.mean() < 2.0, (ana.mean(), fd.mean())


@pytest.mark.slow
def test_pnee_emission_gradient_matches_fd():
    _, tgrid = _pnee_grid()
    _, ts = _settings(rt=2, max_bounces=4, rr_clamp_min=0.9, rr_clamp_max=0.9)
    t, loss = _port_loss(jscenes.sphere_plane(), ts, CAMERA, "emission", grid=tgrid)
    direction = torch.zeros_like(t.emission)
    direction[2:4] = 1.0
    ana, fd = _fd_vs_grad(loss, t.emission, direction, h=0.05)
    assert ana > 0
    assert abs(ana - fd) <= 0.02 * max(abs(fd), 1e-6) + 1e-5, (ana, fd)


# ---------------------------------------------------------------------------
# On the card: K1/K2 and the re-evaluation against the plain route
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_gradients_on_gpu_match_cpu(cuda_device):
    """The gradient path on the card (K1/K2 decide, the re-evaluation
    differentiates) against the port on the CPU (plain versions):
    sphere_plane, 16x16, 5 bounces."""
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    j = jscenes.sphere_plane()
    _, ts = _settings()
    n1, n2 = sk.fused_nearest.launches, sk.fused_occluded.launches
    loss_g, g_g = _torch_grads(j, ts, CAMERA, 3, device=cuda_device)
    assert sk.fused_nearest.launches > n1 and sk.fused_occluded.launches > n2
    loss_c, g_c = _torch_grads(j, ts, CAMERA, 3)
    np.testing.assert_allclose(loss_g, loss_c, rtol=1e-4)
    for k in LEAVES:
        scale = float(np.max(np.abs(g_c[k])))
        np.testing.assert_allclose(g_g[k], g_c[k], rtol=1e-3, atol=1e-4 * scale, err_msg=k)
