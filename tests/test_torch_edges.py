"""The port's edge-aware warps (``ops.edges``) against the JAX package's,
on the CPU.

``tests/test_edges.py``'s invariants, each held on the port and, where
the JAX function takes the same inputs, against it: the warps preserve
the forward value (T(u) == u, J == 1), ``project_screen`` inverts the
primary rays, and the occluder clearances of spheres, tori and boxes
vanish at silhouettes.  The gradient of ``render_pixels_edgeaware`` with
both warps on (screen and NEE) is held against ``jax.grad`` of the JAX
one, run op by op on the sphere scene (``tests/test_torch_grads.py``
says why), at rtol 1e-4 / atol 1e-5 * max|g|.
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
from wasm_pathtracer_tpu.models.scene import Material as JMaterial
from wasm_pathtracer_tpu.models.scene import SceneBuilder as JBuilder
from wasm_pathtracer_tpu.ops import edges as jedges
from wasm_pathtracer_tpu.ops import trace as jtrace
from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models.camera import Camera, primary_rays
from wasm_pathtracer_tpu_torch.models.scene import TENSOR_FIELDS, scene_from_numpy
from wasm_pathtracer_tpu_torch.ops import bvh as tbvh
from wasm_pathtracer_tpu_torch.ops import edges
from wasm_pathtracer_tpu_torch.ops import integrator as tint
from wasm_pathtracer_tpu_torch.ops import intersect as tisx
from wasm_pathtracer_tpu_torch.ops import trace as ttrace

W = H = 12
CAMERA = ((0.0, 1.5, -2.0), 0.45, 0.0)


def _to_torch(scene):
    return scene_from_numpy({k: np.asarray(getattr(scene, k)) for k in TENSOR_FIELDS},
                            scene.num_inf, scene.num_shapes, scene.num_lights,
                            scene.num_plights)


def _setup():
    scene = _to_torch(jscenes.sphere_plane())
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=4,
                        rr_clamp_min=0.9, rr_clamp_max=0.9)
    return scene, ttrace.prepare(scene), Camera.create(*CAMERA), st


def _pix(w=W, h=H):
    pix = torch.arange(w * h)
    return pix % w, pix // w


def test_forward_value_preserved():
    scene, prep, cam, st = _setup()
    px, py = _pix()
    col_e, _ = edges.render_pixels_edgeaware(prep, scene, st, cam, px, py, W, H, 5)
    col_p, _ = tint.render_pixels(prep, scene, st, cam, px, py, W, H, 5)
    torch.testing.assert_close(col_e, col_p, rtol=1e-5, atol=1e-6)


def test_nee_warp_value_preserved():
    """With the light rows on an autograd path the warp runs, and the
    radiance is the plain NEE's."""
    scene, prep, cam, st = _setup()
    rows = scene.params[scene.light_shape.long()].clone().requires_grad_(True)
    sc = scene.with_light_rows(rows)
    px, py = _pix()
    col_e, _ = tint.render_pixels(prep, sc, st.replace(edge_aware_nee=True), cam,
                                  px, py, W, H, 5)
    col_p, _ = tint.render_pixels(prep, sc, st, cam, px, py, W, H, 5)
    torch.testing.assert_close(col_e, col_p, rtol=1e-5, atol=1e-6)
    g = torch.autograd.grad(col_e.mean(), rows)[0]
    assert torch.isfinite(g).all() and g.abs().max() > 0


def test_warp_jacobian_value_is_one():
    scene, prep, cam, st = _setup()
    u = torch.tensor([[3.2, 4.7], [0.4, 11.2], [6.0, 6.0]])
    T, J = edges.warp_jacobian(
        lambda uu: edges._screen_warp_T(prep, scene, st, cam, uu, W, H, 8, 1.25, 1.0), u)
    torch.testing.assert_close(T.detach(), u)
    assert torch.equal(J.detach(), torch.ones(3))


def test_project_screen_inverts_primary_rays():
    _, _, cam, st = _setup()
    px = torch.tensor([2, 7, 11])
    py = torch.tensor([0, 5, 9])
    jx = torch.tensor([0.3, 0.8, 0.1])
    jy = torch.tensor([0.6, 0.2, 0.9])
    o, d = primary_rays(cam, px, py, jx, jy, W, H, st.screen_z)
    x = o + d * torch.tensor([2.0, 5.0, 9.0])[:, None]
    u = edges.project_screen(cam, x, W, H, st.screen_z)
    want = torch.stack([px + jx, py + jy], -1)
    torch.testing.assert_close(u, want, atol=1e-3, rtol=0)


def _segments(x0, targets):
    nu = targets - x0
    seg_len = np.sqrt(np.sum(nu ** 2, -1))
    return x0, (nu / seg_len[:, None]).astype(np.float32), seg_len.astype(np.float32)


def _clearance_both(jscene, x0, nu, seg_len):
    """``_segment_clearance`` of both packages on the same segments (no
    light excluded)."""
    lsid = np.full((x0.shape[0],), -7)
    jB, jz = jedges._segment_clearance(
        jtrace.prepare(jscene), jax.tree.map(jax.lax.stop_gradient, jscene),
        jnp.asarray(lsid, jnp.int32), jnp.asarray(x0), jnp.asarray(nu),
        jnp.asarray(seg_len))
    t = _to_torch(jscene)
    tB, tz = edges._segment_clearance(ttrace.prepare(t), t, torch.from_numpy(lsid),
                                      *(torch.from_numpy(a) for a in (x0, nu, seg_len)))
    np.testing.assert_allclose(tB.numpy(), np.asarray(jB), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-4, atol=1e-5)
    return tB.numpy(), tz.numpy()


def test_segment_clearance_sphere():
    """Clearance -> 0 at grazing, the silhouette point on the sphere;
    from the blocked and the clear side."""
    x0 = np.tile(np.array([[3.0, 0.0, 5.0]], np.float32), (3, 1))
    targets = np.array([[-3.0, 0.0, 5.0], [-3.0, 2.05, 5.0], [-3.0, 6.0, 5.0]],
                       np.float32)
    B, z = _clearance_both(jscenes.sphere_plane(), *_segments(x0, targets))
    assert B[0] > 0.1 and B[1] < 0.02 and B[2] > B[1]
    assert abs(np.linalg.norm(z[1] - np.array([0, 0, 5.0])) - 1.0) < 1e-5


def test_segment_clearance_torus():
    """Torus clearance (the signed SDF minimum along the segment)
    vanishes at grazing from both sides; the silhouette point lies on
    the surface.  Torus at (0, 0, 5), R = 1, r = 0.25."""
    b = JBuilder(background=(0.0, 0.0, 0.0))
    b.add_torus((0.0, 0.0, 5.0), 1.0, 0.25, JMaterial.diffuse(0.5, 0.5, 0.5))
    x0 = np.tile(np.array([[3.0, 0.0, 5.0]], np.float32), (4, 1))
    targets = np.array([[-3.0, 0.0, 5.0], [-3.0, 0.76, 5.0], [-3.0, 3.0, 5.0],
                        [0.0, 3.0, 5.0]], np.float32)
    B, z = _clearance_both(b.build(), *_segments(x0, targets))
    assert B[0] > 0.03 and B[1] < 0.02 and B[2] > B[1]
    sdf = tisx._torus_sdf(torch.from_numpy(z[1]) - torch.tensor([0.0, 0.0, 5.0]), 1.0, 0.25)
    assert abs(float(sdf)) < 5e-3


def test_boundary_test_aarect_per_axis_normalization():
    """An elongated box reads B ~ 0 only near its outline edges."""
    b = JBuilder(background=(0.0, 0.0, 0.0))
    b.add_aarect(-0.1, 0.1, -1.0, 2.0, -20.0, 20.0, JMaterial.diffuse(0.5, 0.5, 0.5))
    j = b.build()
    x0 = np.array([[0.1, 0.5, 0.0], [0.1, 1.98, 0.0], [0.1, 0.5, 19.9]], np.float32)
    d0 = np.tile(np.array([[-1.0, 0.0, 0.0]], np.float32), (3, 1))
    sid = np.zeros((3,), np.int64)
    B = edges._boundary_test(_to_torch(j), torch.from_numpy(sid), torch.from_numpy(x0),
                             torch.from_numpy(d0), torch.from_numpy(-d0)).numpy()
    jB = jedges._boundary_test(j, jnp.asarray(sid, jnp.int32), jnp.asarray(x0),
                               jnp.asarray(d0), jnp.asarray(-d0))
    np.testing.assert_allclose(B, np.asarray(jB), rtol=1e-6)
    assert B[0] > 0.15 and B[1] < 0.02 and B[2] < 0.02


def test_nee_warp_matches_jax():
    """``nee_warp`` on ``tests/test_edges.py``'s shading points (two in
    the sphere's penumbra, two clear): the values (s1, s2, 1) and the
    vertical light-lift velocity of s1 against ``jax.jvp``."""
    j = jscenes.sphere_plane()
    jprep = jtrace.prepare(j)
    rows0 = np.asarray(j.params[j.light_shape])
    lsid = int(np.asarray(j.light_shape)[0])
    x = np.array([[1.2, -1.0, 5.2], [1.3, -1.0, 5.0], [0.0, 2.8, 5.0], [2.5, 3.0, 5.0]],
                 np.float32)
    s1 = np.array([0.4, 0.5, 0.4, 0.5], np.float32)
    s2 = np.array([0.5, 0.3, 0.5, 0.3], np.float32)

    def jwarp(delta):
        sc = j.with_light_rows(jnp.asarray(rows0).at[:, 1::3].add(delta))
        lv = jnp.broadcast_to(sc.params[j.light_shape][0][None], (4, 9))
        return jedges.nee_warp(jprep, sc, lv, jnp.full((4,), lsid, jnp.int32),
                               jnp.asarray(x), jnp.asarray(s1), jnp.asarray(s2))

    with jax.disable_jit():
        (jw1, jw2, jJ), (jvel, _, _) = jax.jvp(jwarp, (jnp.float32(0.0),),
                                                (jnp.float32(1.0),))

    t = _to_torch(j)
    prep = ttrace.prepare(t)
    delta = torch.zeros((), requires_grad=True)
    shift = torch.zeros((1, 9))
    shift[:, 1::3] = 1.0
    sc = t.with_light_rows(torch.from_numpy(rows0) + delta * shift)
    lv = sc.params[t.light_shape.long()][0][None].expand(4, 9)
    w1, w2, J = edges.nee_warp(prep, sc, lv, torch.full((4,), lsid), torch.from_numpy(x),
                               torch.from_numpy(s1), torch.from_numpy(s2))
    np.testing.assert_array_equal(w1.detach().numpy(), np.asarray(jw1))
    np.testing.assert_array_equal(w2.detach().numpy(), np.asarray(jw2))
    assert torch.equal(J.detach(), torch.ones(4)) and np.array_equal(np.asarray(jJ), np.ones(4))
    vel = [float(torch.autograd.grad(w1[k], delta, retain_graph=True)[0]) for k in range(4)]
    np.testing.assert_allclose(vel, np.asarray(jvel), rtol=1e-4, atol=1e-6)
    assert max(abs(v) for v in vel[:2]) > 1e-3      # near the boundary: moves
    assert max(abs(v) for v in vel[2:]) < 2e-3      # clear segments: gated down


def test_render_pixels_edgeaware_gradients_match_jax():
    """Both warps on (screen and NEE), 16x16: mean radiance and its
    gradients with respect to the camera and the light rows against
    ``jax.grad`` of the JAX ``render_pixels_edgeaware``."""
    w = h = 16
    j = jscenes.sphere_plane()
    jprep = jtrace.prepare(j)
    rows0 = np.asarray(j.params[j.light_shape])
    js = JSettings(render_type=JType.NORMAL_NEE, max_bounces=4, rr_clamp_min=0.9,
                   rr_clamp_max=0.9, early_exit=False, edge_aware_nee=True)
    pix = jnp.arange(w * h, dtype=jnp.int32)

    def jloss(loc, rx, rows):
        cam = JCamera(location=loc, rot_x=rx, rot_y=jnp.float32(0.0))
        col, _ = jedges.render_pixels_edgeaware(jprep, j.with_light_rows(rows), js, cam,
                                                pix % w, pix // w, w, h, jnp.uint32(5),
                                                window_margin=0.75)
        return jnp.mean(col)

    with jax.disable_jit():
        lj, gj = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(CAMERA[0], jnp.float32), jnp.float32(CAMERA[1]), jnp.asarray(rows0))

    scene, prep, _, st = _setup()
    args = [torch.tensor(CAMERA[0]).requires_grad_(True),
            torch.tensor(CAMERA[1]).requires_grad_(True),
            torch.from_numpy(rows0).requires_grad_(True)]
    px, py = _pix(w, h)
    col, _ = edges.render_pixels_edgeaware(
        prep, scene.with_light_rows(args[2]), st.replace(edge_aware_nee=True),
        Camera(args[0], args[1], torch.tensor(0.0)), px, py, w, h, 5, window_margin=0.75)
    gt = torch.autograd.grad(col.mean(), args)
    np.testing.assert_allclose(float(col.mean()), float(lj), rtol=1e-5)
    for got, want in zip(gt, gj):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())
    assert float(gt[1]) != 0.0


def test_edgeaware_needs_a_dense_prep():
    """As in the JAX package: the screen warp refuses a cluster prep."""
    scene = _to_torch(jscenes.museum())
    prep = tbvh.attach_clusters(ttrace.prepare(scene), scene, min_count=1,
                                exclude_lights=True)
    px, py = _pix(2, 2)
    with pytest.raises(AssertionError, match="dense differentiable"):
        edges.render_pixels_edgeaware(prep, scene, RenderSettings(), Camera.create(*CAMERA),
                                      px, py, 2, 2, 1)


@pytest.mark.slow
def test_camera_gradient_matches_fd_edgeaware():
    """``tests/test_grads.py``'s FD contract on the port: with the
    screen warp the camera-pitch gradient carries the silhouette flux."""
    w = h = 16
    scene, prep, _, st = _setup()
    px, py = _pix(w, h)

    def loss(rx, seed, warp):
        cam = Camera(torch.tensor(CAMERA[0]), rx, torch.tensor(0.0))
        if warp:
            col, _ = edges.render_pixels_edgeaware(prep, scene, st, cam, px, py, w, h,
                                                   seed, window_margin=0.75)
        else:
            col, _ = tint.render_pixels(prep, scene, st, cam, px, py, w, h, seed)
        return col.mean()

    h_ = 0.05
    fd, ana = [], []
    for s in range(64):
        sd = 11 + 97 * s
        with torch.no_grad():
            fd.append((float(loss(torch.tensor(CAMERA[1] + h_), sd, False))
                       - float(loss(torch.tensor(CAMERA[1] - h_), sd, False))) / (2 * h_))
        rx = torch.tensor(CAMERA[1]).requires_grad_(True)
        ana.append(float(torch.autograd.grad(loss(rx, sd, True), rx)[0]))
    fd, ana = np.array(fd), np.array(ana)
    sem = fd.std() / np.sqrt(len(fd)) + ana.std() / np.sqrt(len(ana))
    assert np.isfinite(ana).all()
    assert np.sign(ana.mean()) == np.sign(fd.mean()), (ana.mean(), fd.mean())
    assert abs(ana.mean() - fd.mean()) <= 0.10 * abs(fd.mean()) + 2.5 * sem
