"""The port's session and CLI against the JAX package's session, on the
CPU.  Accumulated buffers follow the per-path rule of
``test_torch_integrator.py``: sample counts equal, per-pixel radiance
sums agree (rtol 1e-3, atol 2e-3) on >= 99% of pixels."""

import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wasm_pathtracer_tpu.config import RenderSettings as JSettings
from wasm_pathtracer_tpu.config import RenderType as JType
from wasm_pathtracer_tpu.ops import accum as jaccum
from wasm_pathtracer_tpu.runtime.session import Session as JSession
from wasm_pathtracer_tpu_torch.config import DebugView, RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models import camera as tcamera
from wasm_pathtracer_tpu_torch.models import scenes as tscenes
from wasm_pathtracer_tpu_torch.models.scene import (TENSOR_FIELDS, Material, SceneBuilder,
                                                   scene_from_numpy)
from wasm_pathtracer_tpu_torch.ops import accum, adaptive, photon
from wasm_pathtracer_tpu_torch.ops import cluster as tcluster
from wasm_pathtracer_tpu_torch.ops.cluster import ARRAY_FIELDS
from wasm_pathtracer_tpu_torch.ops.trace import INDEX_FIELDS
from wasm_pathtracer_tpu_torch.runtime import session as tsession
from wasm_pathtracer_tpu_torch.runtime.session import Session

from tests.torch_port_helpers import one_thread, tensors_of  # noqa: F401 (a fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _pair(W=64, H=64, ticks=4096):
    kw = dict(max_bounces=6, ray_batch_size=1024, regen_lanes=256)
    j = JSession(W, H, scene_id=100,
                 left=JSettings(render_type=JType.NORMAL_NEE, **kw),
                 right=JSettings(render_type=JType.NO_NEE, **kw))
    t = Session(W, H, scene_id=100,
                left=RenderSettings(render_type=RenderType.NORMAL_NEE, **kw),
                right=RenderSettings(render_type=RenderType.NO_NEE, **kw),
                device="cpu")
    assert j.compute(ticks) == t.compute(ticks)
    return j, t


def test_session_buffers_match_jax():
    j, t = _pair()
    c0, c1 = np.asarray(j.buffer.count), t.buffer.count.numpy()
    np.testing.assert_array_equal(c0, c1)
    a0, a1 = np.asarray(j.buffer.acc), t.buffer.acc.numpy()
    assert np.isclose(a1, a0, rtol=1e-3, atol=2e-3).all(-1).mean() >= 0.99
    assert j.num_bvh_hits == t.num_bvh_hits
    assert t.results().shape == (64, 64, 3) and t.results().max() > 0
    assert c1[:, :32].sum() > 0 and c1[:, 32:].sum() > 0   # both halves


def test_write_samples_matches_jax():
    """Scattered samples with repeated pixels add up as in the JAX buffer
    (float sums of ~5 samples a pixel, in either order: rtol 1e-5)."""
    r = np.random.default_rng(3)
    W, H, n = 24, 16, 2000
    px, py = r.integers(0, W, n), r.integers(0, H, n)
    col = r.random((n, 3), dtype=np.float32)
    jb = jaccum.write_samples(jaccum.AccumBuffer.create(W, H), jnp.asarray(px),
                              jnp.asarray(py), jnp.asarray(col))
    tb = accum.write_samples(accum.AccumBuffer.create(W, H, device="cpu"), torch.as_tensor(px),
                             torch.as_tensor(py), torch.as_tensor(col))
    np.testing.assert_array_equal(np.asarray(jb.count), tb.count.numpy())
    np.testing.assert_allclose(tb.acc.numpy(), np.asarray(jb.acc), rtol=1e-5)
    np.testing.assert_allclose(accum.clamped_image(tb).numpy(),
                               np.asarray(jaccum.clamped_image(jb)), rtol=1e-5)


def test_session_reset_and_camera_update():
    _, t = _pair(32, 32, 2048)
    assert t.buffer.count.sum() > 0
    t.update_camera((0.0, 2.0, -3.0), 0.3, 0.0)
    assert t.buffer.count.sum() == 0 and t.num_bvh_hits == 0
    t.update_scene(0)
    assert t.scene.num_shapes == 146
    t.update_viewport(40, 24)
    t.compute(2048)
    assert t.results().shape == (24, 40, 3)


@pytest.mark.parametrize("kw", [dict(render_type=RenderType.PNEE),
                                dict(adaptive=True)])
def test_session_pnee_and_adaptive_match_jax(kw):
    """PNEE and adaptive sampling are ported: a session with either on
    its left half renders as the JAX session does (counts equal, per-pixel
    sums by the per-path rule)."""
    kw = dict(kw, max_bounces=4, ray_batch_size=1024, regen_lanes=256,
              total_photons=2000, photon_grid_res=8)
    jkw = dict(kw, render_type=JType(int(kw.get("render_type", RenderType.NORMAL_NEE))))
    j = JSession(32, 32, scene_id=100, left=JSettings(**jkw),
                 right=JSettings(render_type=JType.NO_NEE, max_bounces=4,
                                 ray_batch_size=1024, regen_lanes=256))
    t = Session(32, 32, scene_id=100, left=RenderSettings(**kw),
                right=RenderSettings(render_type=RenderType.NO_NEE, max_bounces=4,
                                     ray_batch_size=1024, regen_lanes=256), device="cpu")
    assert j.compute(6144) == t.compute(6144) > 0
    np.testing.assert_array_equal(np.asarray(j.buffer.count), t.buffer.count.numpy())
    a0, a1 = np.asarray(j.buffer.acc), t.buffer.acc.numpy()
    assert np.isclose(a1, a0, rtol=1e-3, atol=2e-3).all(-1).mean() >= 0.99
    assert t.buffer.count[:, :16].sum() > 0 and j.num_bvh_hits == t.num_bvh_hits


def test_session_mesh_scenes_and_upload_match_jax():
    """Mesh scenes and mesh upload are ported: the bunny slot (scene 2)
    renders without its mesh, ``store_mesh`` rebuilds the scene that uses
    the uploaded mesh (and only that one) as the JAX session does, and a
    malformed upload is rejected."""
    mesh = np.asarray(tscenes.surface_mesh(6), np.float32)
    j = JSession(32, 32, scene_id=2)
    t = Session(32, 32, scene_id=2, device="cpu")
    assert t.scene.num_shapes == 4 and t.prep.cluster is None
    assert not t.store_mesh(3, mesh) and t.scene.num_shapes == 4   # scene 4's mesh
    assert j.store_mesh(1, mesh) and t.store_mesh(1, mesh.reshape(-1, 3))
    assert t.scene.num_shapes == 4 + mesh.shape[0]
    for k in TENSOR_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(j.scene, k)),
                                      getattr(t.scene, k).numpy(), err_msg=k)
    with pytest.raises(ValueError):
        t.store_mesh(1, np.zeros((4, 2), np.float32))


@pytest.mark.parametrize("use_bvh", [None, True, False])
def test_session_prep_matches_jax(use_bvh):
    """``use_bvh``: None clusters the families of >= bvh_min_triangles
    shapes, True every finite family, False none; the dense remainder
    and the cluster tables equal the JAX session's."""
    j = JSession(16, 16, scene_id=4, use_bvh=use_bvh)
    t = Session(16, 16, scene_id=4, use_bvh=use_bvh, device="cpu")
    assert (j.prep.cluster is None) == (t.prep.cluster is None) == (use_bvh is False)
    for k in INDEX_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(j.prep, k)),
                                      getattr(t.prep, k).numpy(), err_msg=k)
    if t.prep.cluster is not None:
        for k in ARRAY_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(j.prep.cluster, k)),
                                          getattr(t.prep.cluster, k).numpy(), err_msg=k)


def test_cluster_session_buffers_match_jax():
    """Scene 4 (the 10k-triangle cloud) renders through both packages'
    flat wavefronts."""
    kw = dict(max_bounces=4, ray_batch_size=1024, regen_lanes=256)
    j = JSession(32, 32, scene_id=4,
                 left=JSettings(render_type=JType.NORMAL_NEE, **kw),
                 right=JSettings(render_type=JType.NO_NEE, **kw))
    t = Session(32, 32, scene_id=4,
                left=RenderSettings(render_type=RenderType.NORMAL_NEE, **kw),
                right=RenderSettings(render_type=RenderType.NO_NEE, **kw), device="cpu")
    assert t.prep.cluster is not None
    assert j.compute(2048) == t.compute(2048)
    np.testing.assert_array_equal(np.asarray(j.buffer.count), t.buffer.count.numpy())
    a0, a1 = np.asarray(j.buffer.acc), t.buffer.acc.numpy()
    assert np.isclose(a1, a0, rtol=1e-3, atol=2e-3).all(-1).mean() >= 0.99
    assert j.num_bvh_hits == t.num_bvh_hits
    assert t.results().max() > 0


def test_render_settings_fields_match_jax():
    """Field names, their order and defaults equal the JAX package's, and
    every JAX field is a keyword the port takes.  ``use_bvh4`` and
    ``debug_view``, read by nothing in either package, are not ported:
    any value but the default raises instead of being ignored."""
    want = [(f.name, f.default) for f in dataclasses.fields(JSettings)]
    assert [(f.name, f.default) for f in dataclasses.fields(RenderSettings)] == want
    for k, v in want:
        assert getattr(RenderSettings(**{k: v}), k) == v
    for kw in ({"use_bvh4": False}, {"debug_view": DebugView.DEPTH}):
        JSettings(**kw)
        with pytest.raises(ValueError, match=next(iter(kw))):
            RenderSettings(**kw)
        with pytest.raises(ValueError):
            RenderSettings().replace(**kw)


@pytest.mark.parametrize("scene_id", [100, 4])
@pytest.mark.parametrize("off", ["use_regen", "early_exit"])
def test_per_pixel_session_matches_jax(scene_id, off, one_thread):
    """With ``use_regen`` or ``early_exit`` off both sessions render one
    sample a picked pixel through ``render_pixels`` (left half uniform,
    right half adaptive): scene 100 on the dense prep, scene 4 (the
    10k-triangle cloud) on its cluster prep."""
    mb, ticks = (6, 4096) if scene_id == 100 else (4, 2048)
    kw = {"max_bounces": mb, "ray_batch_size": 1024, off: False}
    j = JSession(32, 24, scene_id=scene_id,
                 left=JSettings(render_type=JType.NORMAL_NEE, **kw),
                 right=JSettings(render_type=JType.NORMAL_NEE, adaptive=True, **kw))
    t = Session(32, 24, scene_id=scene_id,
                left=RenderSettings(render_type=RenderType.NORMAL_NEE, **kw),
                right=RenderSettings(render_type=RenderType.NORMAL_NEE, adaptive=True, **kw),
                device="cpu")
    assert (t.prep.cluster is not None) == (scene_id == 4)
    assert j.compute(ticks) == t.compute(ticks) == ticks
    np.testing.assert_array_equal(np.asarray(j.buffer.count), t.buffer.count.numpy())
    a0, a1 = np.asarray(j.buffer.acc), t.buffer.acc.numpy()
    assert np.isclose(a1, a0, rtol=1e-3, atol=2e-3).all(-1).mean() >= 0.99
    assert j.num_bvh_hits == t.num_bvh_hits > 0
    assert t.buffer.count[:, :16].sum() > 0 and t.buffer.count[:, 16:].sum() > 0


def _sphere_plane_arrays():
    s = tscenes.sphere_plane(device="cpu")
    return ({k: getattr(s, k).numpy() for k in TENSOR_FIELDS},
            s.num_inf, s.num_shapes, s.num_lights, s.num_plights)


def _cluster_inputs():
    rows = tscenes.triangle_cloud(5).reshape(-1, 9)
    return rows, np.full(5, 2, np.int32), np.arange(5)


def _cluster_arrays():
    cs = tcluster.build_clusters(*_cluster_inputs(), device="cpu")
    return {k: getattr(cs, k).numpy() for k in ARRAY_FIELDS}, cs.families


def _builder():
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, 0.0), 1.0, Material.diffuse(0.5, 0.5, 0.5))
    return b


def _session_tensors(s):
    return (s.buffer, s.camera, s.scene, s.right.photon_grid)


# every public constructor that makes tensors from nothing: called as
# fn(**kw) with kw = {} (the card) or {"device": ...}
CONSTRUCTORS = {
    "museum": lambda **kw: tscenes.museum(**kw),
    "sphere_plane": lambda **kw: tscenes.sphere_plane(**kw),
    "whitted": lambda **kw: tscenes.whitted(**kw),
    "bunny_high": lambda **kw: tscenes.bunny_high(**kw),
    "cloud": lambda **kw: tscenes.cloud(8, **kw),
    "mesh_scene": lambda **kw: tscenes.mesh_scene(tscenes.surface_mesh(3), **kw),
    "select_scene": lambda **kw: tscenes.select_scene(100, **kw),
    "SceneBuilder.build": lambda **kw: _builder().build(**kw),
    "scene_from_numpy": lambda **kw: scene_from_numpy(*_sphere_plane_arrays(), **kw),
    "Camera.create": lambda **kw: tcamera.Camera.create((0.0, 1.0, -2.0), 0.1, 0.2, **kw),
    "camera_from_numpy": lambda **kw: tcamera.camera_from_numpy(
        np.zeros(3, np.float32), np.float32(0.1), np.float32(0.2), **kw),
    "initial_camera": lambda **kw: tcamera.initial_camera(0, **kw),
    "AccumBuffer.create": lambda **kw: accum.AccumBuffer.create(8, 4, **kw),
    "PhotonGrid.create": lambda **kw: photon.PhotonGrid.create(3, (0, 0, 0), (1, 1, 1), 2, **kw),
    "photon_grid_from_numpy": lambda **kw: photon.photon_grid_from_numpy(
        dict(bins=np.ones((8, 3)), lo=np.zeros(3), hi=np.ones(3), num_photons=0), 2, **kw),
    "build_clusters": lambda **kw: tcluster.build_clusters(*_cluster_inputs(), **kw),
    "cluster_from_numpy": lambda **kw: tcluster.cluster_from_numpy(*_cluster_arrays(), **kw),
    "random_pixels": lambda **kw: adaptive.random_pixels(16, 3, 0, 0, 4, 4, **kw),
    "Session": lambda **kw: _session_tensors(Session(8, 8, scene_id=100, **kw)),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_defaults_to_the_card(name):
    """Without a device every public constructor asks for CUDA, which
    raises on a host without a card (it never renders on the CPU); with
    ``device="cpu"`` it builds CPU tensors."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: test_constructor_lands_on_the_card covers it")
    with pytest.raises(RuntimeError, match="CUDA"):
        CONSTRUCTORS[name]()
    got = tensors_of(CONSTRUCTORS[name](device="cpu"))
    assert got and all(t.device.type == "cpu" for t in got)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_lands_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    got = tensors_of(CONSTRUCTORS[name]())
    assert got and all(t.device.type == "cuda" for t in got)


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tsession.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        Session(32, 32, scene_id=100)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsession.resolve_device()
    assert tsession.resolve_device("cpu").type == "cpu"


def test_cli_writes_png(tmp_path):
    from wasm_pathtracer_tpu_torch.runtime import cli
    out = tmp_path / "frame.png"
    cli.main(["--scene", "100", "--width", "128", "--height", "128",
              "--ticks", "4096", "--batch", "2048", "--max-bounces", "4",
              "--device", "cpu", "--out", str(out)])
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_uploads_obj_into_bunny_slot(tmp_path):
    """``--obj`` uploads the mesh as mesh id 1, the bunny slot of scene 2,
    scaled x8 with z flipped as the client loads its bunny."""
    from wasm_pathtracer_tpu_torch.runtime import cli
    mesh = tmp_path / "m.obj"
    mesh.write_text("v -0.1 0 0\nv 0.1 0 0\nv 0 0.2 0\nv 0 0.1 0.1\nf 1 2 3\nf 1 2 4\n")
    out = tmp_path / "bunny.png"
    cli.main(["--scene", "2", "--obj", str(mesh), "--width", "64", "--height", "64",
              "--ticks", "2048", "--batch", "1024", "--max-bounces", "3",
              "--device", "cpu", "--out", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_port_never_loads_jax(tmp_path):
    """Importing the port (its runtime and parallel modules and its
    example too) and rendering a path traced and a Whitted frame through
    it, in a fresh interpreter, leaves JAX unloaded."""
    code = (
        "import sys\n"
        "from wasm_pathtracer_tpu_torch.examples import inverse_render\n"
        "from wasm_pathtracer_tpu_torch.runtime import cli\n"
        "from wasm_pathtracer_tpu_torch.ops import whitted\n"
        "from wasm_pathtracer_tpu_torch.runtime import checkpoint, driver, live\n"
        "from wasm_pathtracer_tpu_torch.parallel import distributed, shard\n"
        f"cli.main(['--scene', '0', '--width', '128', '--height', '128', "
        f"'--ticks', '512', '--batch', '256', '--max-bounces', '3', "
        f"'--device', 'cpu', '--out', r'{tmp_path / 'm.png'}'])\n"
        f"cli.main(['--scene', '101', '--width', '128', '--height', '128', "
        f"'--whitted', '1', '--device', 'cpu', '--out', r'{tmp_path / 'w.png'}'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('wasm_pathtracer_tpu.') or m == 'wasm_pathtracer_tpu')\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "clean" in proc.stdout


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """Without a card the chip script exits non-zero before any result."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the script would run")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
