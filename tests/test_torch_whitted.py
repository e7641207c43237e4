"""The port's Whitted tracer against the JAX package's, on the CPU.

Both packages trace the same tables: the JAX scene is read field by
field into the port (``scene_from_numpy``).  JAX runs op by op as its
own tests run it; the port runs its kernels' plain versions.

Images agree within rtol 1e-4 / atol 1e-4 on >= 99.5% of pixels.  The
rest may differ by a shadow verdict taken the other way on a rounding
tie: JAX decides occlusion by a nearest-hit trace and ``sid !=
light_sid``, the port's any-hit query by t < min(dist, t_light), and an
area light's shadow ray is aimed at a point on the light itself, so the
light's own distance equals ``dist`` up to rounding.

Gradients of mean(img^2) are held to 1e-3 relative (atol 1e-3 of the
largest component): both hold the hit shapes and the shadow verdicts
constant, and the float32 sums run in another order on each side.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wasm_pathtracer_tpu.config import RenderSettings as JSettings
from wasm_pathtracer_tpu.models import scenes as jscenes
from wasm_pathtracer_tpu.models.camera import Camera as JCamera
from wasm_pathtracer_tpu.models.scene import Material as JMaterial
from wasm_pathtracer_tpu.models.scene import SceneBuilder as JBuilder
from wasm_pathtracer_tpu.ops import trace as jtrace
from wasm_pathtracer_tpu.ops import whitted as jwhitted
from wasm_pathtracer_tpu_torch.config import RenderSettings
from wasm_pathtracer_tpu_torch.models import scenes as tscenes
from wasm_pathtracer_tpu_torch.models.camera import Camera
from wasm_pathtracer_tpu_torch.models.scene import TENSOR_FIELDS, scene_from_numpy
from wasm_pathtracer_tpu_torch.ops import trace as ttrace
from wasm_pathtracer_tpu_torch.ops import whitted as twhitted


def _to_torch(scene):
    return scene_from_numpy({k: np.asarray(getattr(scene, k)) for k in TENSOR_FIELDS},
                            scene.num_inf, scene.num_shapes, scene.num_lights,
                            scene.num_plights, device="cpu")


def _render_pair(scene, camera, W=32, H=32, depth=3):
    """(JAX image, port image), each (H, W, 3)."""
    pix = jnp.arange(W * H, dtype=jnp.int32)
    want = jwhitted.render_whitted(jtrace.prepare(scene), scene, JSettings(),
                                   JCamera.create(*camera), pix % W, pix // W, W, H,
                                   depth=depth)
    t = _to_torch(scene)
    tp = torch.arange(W * H)
    got = twhitted.render_whitted(ttrace.prepare(t), t, RenderSettings(),
                                  Camera.create(*camera, device="cpu"), tp % W, tp // W, W, H,
                                  depth=depth)
    return np.asarray(want).reshape(H, W, 3), got.numpy().reshape(H, W, 3)


def _assert_images_close(got, want):
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4).all(-1)
    assert close.mean() >= 0.995, (close.mean(), np.abs(got - want).max())
    assert np.isfinite(got).all()


def _point_light_scene():
    b = JBuilder(background=(0.0, 0.0, 0.0))
    b.add_plane((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), JMaterial.diffuse(1.0, 1.0, 1.0))
    b.add_sphere((0.0, 1.0, 0.0), 0.5, JMaterial.diffuse(0.5, 0.5, 0.5))
    b.add_point_light((0.0, 3.0, 0.0), (1.0, 1.0, 1.0), 10.0)
    return b.build()


def _dir_spot_scene():
    b = JBuilder()
    b.add_plane((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), JMaterial.diffuse(1.0, 1.0, 1.0))
    b.add_directional_light((0.0, -1.0, 0.0), (0.5, 0.5, 0.5))
    b.add_spot_light((0.0, 2.0, 0.0), (0.0, -1.0, 0.0), 0.3, (1.0, 0.0, 0.0), 5.0)
    return b.build()


def _mirror_scene():
    b = JBuilder(background=(0.0, 0.0, 1.0))
    b.add_sphere((0.0, 0.0, 3.0), 1.0, JMaterial.reflect(1.0, 1.0, 1.0, 1.0))
    return b.build()


def _glass_scene(absorb):
    b = JBuilder(background=(1.0, 1.0, 1.0))
    b.add_sphere((0.0, 0.0, 3.0), 1.0, JMaterial.refract(absorb, 1.0))
    return b.build()


def whitted_lit():
    """Scene 101 with a point, a spot and a directional light added."""
    b = JBuilder(background=(135.0 / 255.0, 206.0 / 255.0, 250.0 / 255.0))
    tex = b.add_texture(jscenes.checker_texture())
    b.add_square((0.0, -1.0, 4.0), 8.0, JMaterial.diffuse(1.0, 1.0, 1.0, texture_id=tex))
    b.add_sphere((-1.3, 1.0, -0.2), 0.7, JMaterial.refract((0.5, 1.0, 0.5), 1.02))
    b.add_sphere((-0.4, 0.0, 1.0), 0.6, JMaterial.reflect(1.0, 1.0, 1.0, 0.3))
    light = JMaterial.emissive(10.0, 10.0, 10.0)
    b.add_triangle((1.0, 6.0, -2.0), (1.0, 6.0, -4.0), (-1.0, 6.0, -4.0), light)
    b.add_triangle((-1.0, 6.0, -2.0), (1.0, 6.0, -2.0), (-1.0, 6.0, -4.0), light)
    b.add_point_light((1.5, 3.0, -1.0), (1.0, 0.9, 0.8), 20.0)
    b.add_spot_light((0.0, 4.0, 1.0), (0.0, -1.0, 0.0), 0.4, (0.2, 0.4, 1.0), 30.0)
    b.add_directional_light((0.3, -1.0, 0.5), (0.3, 0.3, 0.3))
    return b.build()


# the scenes of tests/test_whitted.py, with their cameras and depths
CASES = {
    "whitted_scene": (jscenes.whitted, ((0.0, 1.0, -4.0), 0.1, 0.0), 3),
    "point_light": (_point_light_scene, ((0.0, 2.0, -4.0), 0.35, 0.0), 1),
    "dir_spot": (_dir_spot_scene, ((0.0, 3.0, -4.0), 0.5, 0.0), 1),
    "mirror": (_mirror_scene, ((0.0, 0.0, 0.0), 0.0, 0.0), 2),
    "refract": (lambda: _glass_scene((0.0, 0.0, 0.0)), ((0.0, 0.0, 0.0), 0.0, 0.0), 4),
    "beer": (lambda: _glass_scene((0.0, 2.0, 2.0)), ((0.0, 0.0, 0.0), 0.0, 0.0), 4),
    "textured_floor": (jscenes.whitted, ((0.0, 2.0, -4.0), 0.45, 0.0), 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_whitted_matches_jax(case):
    make, camera, depth = CASES[case]
    want, got = _render_pair(make(), camera, depth=depth)
    _assert_images_close(got, want)
    assert got.max() > 0.0
    if case == "mirror":            # the centre reflects the blue sky
        assert got[16, 16, 2] > 0.5 and got[16, 16, 0] < 0.2
    if case == "refract":           # ior 1: straight through to the background
        assert np.allclose(got[16, 16], 1.0, atol=0.05)


@pytest.mark.parametrize("make", [_point_light_scene, _dir_spot_scene],
                         ids=["point_light", "dir_spot"])
def test_direct_light_matches_jax(make):
    """``_direct_light`` at the points of tests/test_whitted.py: the one
    under the sphere is shadowed, the spot adds red under its cone."""
    scene = make()
    p = np.asarray([[0.0, 0.0, 0.0], [2.5, 0.0, 0.0], [50.0, 0.0, 0.0]], np.float32)
    n = np.asarray([[0.0, 1.0, 0.0]] * 3, np.float32)
    alb = np.ones((3, 3), np.float32)
    want = np.asarray(jwhitted._direct_light(jtrace.prepare(scene), scene, jnp.asarray(p),
                                             jnp.asarray(n), jnp.asarray(alb), 2e-4))
    t = _to_torch(scene)
    got = twhitted._direct_light(ttrace.prepare(t), t, torch.as_tensor(p),
                                 torch.as_tensor(n), torch.as_tensor(alb), 2e-4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    if scene.num_plights == 1:
        assert got[0].max() == 0.0 and got[1].max() > 0.0
    else:
        assert got[0, 0] > got[0, 2] and np.isclose(got[2, 0], got[2, 2], atol=1e-5)


def test_museum_light_chunks_match_jax():
    """The museum's 108 area lights: 7 chunks of 16, the last padded with
    zero-area slots of shape id -2."""
    scene = jscenes.museum()
    assert scene.num_lights == 108
    want, got = _render_pair(scene, ((0.0, 16.34, -23.76), 0.54, 0.0), 16, 16, depth=1)
    _assert_images_close(got, want)
    assert got.max() > 0.0


def test_whitted_gradients_match_jax():
    """d mean(img^2) / d (albedo, point-light colours, camera) at 16x16,
    depth 2, on scene 101 with area, point, spot and directional lights
    at once; the images agree as in the other tests."""
    W = H = 16
    scene = whitted_lit()
    cam = ((0.0, 1.0, -4.0), 0.1, 0.0)
    vals = dict(albedo=np.asarray(scene.albedo), plight_color=np.asarray(scene.plight_color),
                location=np.asarray(cam[0], np.float32), rot_x=np.float32(cam[1]),
                rot_y=np.float32(cam[2]))
    prep = jtrace.prepare(scene)
    pix = jnp.arange(W * H, dtype=jnp.int32)

    def loss(v):
        sc = dataclasses.replace(scene.with_materials(albedo=v["albedo"]),
                                 plight_color=v["plight_color"])
        c = JCamera(location=v["location"], rot_x=v["rot_x"], rot_y=v["rot_y"])
        img = jwhitted.render_whitted(prep, sc, JSettings(), c, pix % W, pix // W, W, H,
                                      depth=2)
        return jnp.mean(img ** 2), img

    want, want_img = jax.grad(loss, has_aux=True)(
        {k: jnp.asarray(x) for k, x in vals.items()})

    t = _to_torch(scene)
    leaves = {k: torch.tensor(np.asarray(x)).requires_grad_(True) for k, x in vals.items()}
    sc = dataclasses.replace(t.with_materials(albedo=leaves["albedo"]),
                             plight_color=leaves["plight_color"])
    c = Camera(leaves["location"], leaves["rot_x"], leaves["rot_y"])
    tp = torch.arange(W * H)
    img = twhitted.render_whitted(ttrace.prepare(t), sc, RenderSettings(), c, tp % W,
                                  tp // W, W, H, depth=2)
    _assert_images_close(img.detach().numpy(), np.asarray(want_img))
    got = torch.autograd.grad((img ** 2).mean(), list(leaves.values()))
    for k, g in zip(leaves, got):
        w = np.asarray(want[k])
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-3 * np.abs(w).max(),
                                   err_msg=k)


def test_cli_whitted_png_matches_jax(tmp_path):
    """``--whitted 1`` on scene 101 at 128x128 writes the JAX CLI's pixels
    (within 1 in uint8)."""
    from wasm_pathtracer_tpu.runtime import cli as jcli
    from wasm_pathtracer_tpu_torch.runtime import cli as tcli
    args = ["--scene", "101", "--width", "128", "--height", "128", "--whitted", "1"]
    jcli.main(args + ["--out", str(tmp_path / "j.png")])
    tcli.main(args + ["--device", "cpu", "--out", str(tmp_path / "t.png")])
    a, b = (_png_pixels(tmp_path / f) for f in ("j.png", "t.png"))
    assert a.shape == b.shape == (128, 128, 3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert b.max() > 0


def _png_pixels(path):
    """Decode an 8-bit RGB PNG as ``utils.png`` writes it (filter 0)."""
    import struct
    import zlib
    data = pathlib.Path(path).read_bytes()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    return raw[:, 1:].reshape(h, w, 3)


@pytest.mark.gpu
def test_whitted_on_card_matches_plain():
    """Scene 101 at 64x64, depth 4, through the kernels on the card
    against the plain versions on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    W = H = 64
    imgs = []
    for dev in ("cuda", "cpu"):
        scene = tscenes.whitted(device=dev)
        pix = torch.arange(W * H, device=dev)
        imgs.append(twhitted.render_whitted(
            ttrace.prepare(scene), scene, RenderSettings(),
            Camera.create((0.0, 1.0, -4.0), 0.1, 0.0, device=dev), pix % W, pix // W,
            W, H, depth=4).cpu().numpy())
    close = np.isclose(imgs[0], imgs[1], rtol=1e-3, atol=1e-3).all(-1)
    assert close.mean() >= 0.995
