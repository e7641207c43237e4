"""The port's runtime (camera controller, driver, checkpoints, the CLI's
run-loop flags) against the JAX package's, on the CPU.

Accumulated buffers follow ``test_torch_session.py``'s rule: sample
counts equal, per-pixel radiance sums within rtol 1e-3 / atol 2e-3 on
>= 99% of pixels.  The driver's auto-tune reads the wall clock, so both
packages' drivers run under one fake clock (``time`` patched in each
driver module).
"""

import types

import numpy as np
import pytest
import torch

from wasm_pathtracer_tpu.config import RenderSettings as JSettings
from wasm_pathtracer_tpu.config import RenderType as JType
from wasm_pathtracer_tpu.models.camera import Camera as JCamera
from wasm_pathtracer_tpu.runtime import camera_controller as jcc
from wasm_pathtracer_tpu.runtime import checkpoint as jckpt
from wasm_pathtracer_tpu.runtime import driver as jdriver
from wasm_pathtracer_tpu.runtime.session import Session as JSession
from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models.camera import Camera
from wasm_pathtracer_tpu_torch.models.scene import TENSOR_FIELDS
from wasm_pathtracer_tpu_torch.runtime import camera_controller as tcc
from wasm_pathtracer_tpu_torch.runtime import checkpoint as tckpt
from wasm_pathtracer_tpu_torch.runtime import cli
from wasm_pathtracer_tpu_torch.runtime import driver as tdriver
from wasm_pathtracer_tpu_torch.runtime.session import Session

FAST = dict(max_bounces=3, ray_batch_size=1024, regen_lanes=256)


def _settings(rt=1, **kw):
    kw = dict(FAST, **kw)
    return JSettings(render_type=JType(rt), **kw), RenderSettings(render_type=RenderType(rt), **kw)


def _pair(W=32, H=32, scene_id=100, left=(1,), right=(0,), **kw):
    jl, tl = _settings(*left, **kw)
    jr, tr = _settings(*right, **kw)
    return (JSession(W, H, scene_id=scene_id, left=jl, right=jr),
            Session(W, H, scene_id=scene_id, left=tl, right=tr, device="cpu"))


def _assert_buffers_match(j, t):
    np.testing.assert_array_equal(np.asarray(j.buffer.count), t.buffer.count.numpy())
    a0, a1 = np.asarray(j.buffer.acc), t.buffer.acc.numpy()
    assert np.isclose(a1, a0, rtol=1e-3, atol=2e-3).all(-1).mean() >= 0.99
    assert j.num_bvh_hits == t.num_bvh_hits
    # the sampling-density view: mix_color of each package's scaled error
    np.testing.assert_allclose(t.density, np.asarray(j.density), atol=1e-4)


# ---------------------------------------------------------------------------
# camera controller
# ---------------------------------------------------------------------------

START = ((0.5, 1.0, -2.0), 0.3, -0.7)


def _controllers():
    seen = ([], [])
    return (jcc.CameraController(JCamera.create(*START), on_update=seen[0].append),
            tcc.CameraController(Camera.create(*START, device="cpu"),
                                 on_update=seen[1].append), seen)


def _assert_same_camera(jc, tc):
    np.testing.assert_allclose(tc.location.numpy(), np.asarray(jc.location), atol=1e-6)
    assert tc.rot_x.item() == float(jc.rot_x) and tc.rot_y.item() == float(jc.rot_y)


@pytest.mark.parametrize("key", list(jcc._BINDINGS))
def test_controller_binding_matches_jax(key):
    """Each binding, one tick and then 37, from a rotated camera."""
    assert tcc._BINDINGS == jcc._BINDINGS
    j, t, seen = _controllers()
    for count in (1, 37):
        j.key(key, count)
        t.key(key, count)
        _assert_same_camera(j.camera, t.camera)
    assert len(seen[0]) == len(seen[1]) == 2


def test_controller_sequence_unknown_key_and_silent_set():
    j, t, seen = _controllers()
    for name, count in (("w", 10), ("LEFT", 50), ("nosuchkey", 3), ("pageup", 4),
                        ("down", 25), ("a", 7), ("s", 2)):
        j.key(name, count)
        t.key(name, count)
        _assert_same_camera(j.camera, t.camera)
    assert len(seen[0]) == len(seen[1]) == 6       # the unknown key fires nothing
    t.set_silent(Camera.create((1.0, 2.0, 3.0), 0.0, 0.0, device="cpu"))
    assert len(seen[1]) == 6 and t.camera.location.tolist() == [1.0, 2.0, 3.0]
    t.set(Camera.create((0.0, 0.0, 0.0), 0.0, 0.0, device="cpu"))
    assert len(seen[1]) == 7 and seen[1][-1] is t.camera
    t.key("w", 10)            # forward from the origin at rotation 0: +z
    np.testing.assert_allclose(t.camera.location.numpy(), [0.0, 0.0, 0.3], atol=1e-6)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

# the wall seconds each step takes on the fake clock
STEP_SECONDS = (0.1, 0.025, 0.2, 0.05, 0.08)


@pytest.fixture
def fake_clock(monkeypatch):
    """Both driver modules read one sequence of times: each step's start
    at a whole second, its end ``STEP_SECONDS`` later (cycled)."""
    def clock():
        calls = [0]

        def perf_counter():
            n = calls[0]
            calls[0] += 1
            return float(n // 2) + (STEP_SECONDS[(n // 2) % len(STEP_SECONDS)]
                                    if n % 2 else 0.0)
        return types.SimpleNamespace(perf_counter=perf_counter)
    monkeypatch.setattr(jdriver, "time", clock())
    monkeypatch.setattr(tdriver, "time", clock())


def test_driver_auto_tune_matches_jax(fake_clock):
    j, t = _pair()
    jd, td = jdriver.Driver(j), tdriver.Driver(t)
    assert td.ticks_per_step == tdriver.INITIAL_TICKS == 500
    assert tdriver.TARGET_TICK_SECONDS == jdriver.TARGET_TICK_SECONDS == 0.05
    seq = [td.ticks_per_step]
    for _ in range(5):
        dt = td.step()
        assert jd.step() == dt
        assert td.ticks_per_step == max(1, int(seq[-1] * 0.05 / dt))
        assert jd.ticks_per_step == td.ticks_per_step
        assert jd.total_ticks == td.total_ticks
        seq.append(td.ticks_per_step)
    assert len(set(seq)) > 2
    _assert_buffers_match(j, t)


def test_driver_deferred_updates_match_jax(fake_clock):
    j, t = _pair()
    jd, td = jdriver.Driver(j, target_tick=0.1), tdriver.Driver(t, target_tick=0.1)
    for d in (jd, td):
        d.step()
        d.request_camera((1.0, 2.0, -3.0), 0.1, 0.2)
        d.request_viewport(40, 24)
    # not applied until the next step
    assert t.width == 32 and t.camera.location[0].item() != 1.0
    jd.step()
    td.step()
    assert (t.width, t.height) == (40, 24) and t.results().shape == (24, 40, 3)
    assert t.camera.location.tolist() == [1.0, 2.0, -3.0]
    assert t.camera.rot_x.item() == np.float32(0.1)
    assert jd.total_ticks == td.total_ticks and jd.ticks_per_step == td.ticks_per_step
    _assert_buffers_match(j, t)


def test_driver_pause_via_on_frame(fake_clock):
    frames = []
    _, t = _pair()

    def on_frame(s):
        frames.append(s.results().copy())
        drv.pause()

    drv = tdriver.Driver(t, on_frame=on_frame)
    drv.run(seconds=1e6)            # would not end if the pause failed
    assert len(frames) == 1 and not drv.running
    assert t.buffer.count.sum() > 0          # the accumulation is kept
    drv.run(steps=2)
    assert len(frames) == 2                  # paused again at the first frame


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_in_port(tmp_path):
    _, t = _pair()
    t.compute(2048)
    path = str(tmp_path / "c.npz")
    tckpt.save(path, t)
    _, t2 = _pair()
    tckpt.load(path, t2)
    assert torch.equal(t2.buffer.acc, t.buffer.acc)
    assert torch.equal(t2.buffer.count, t.buffer.count)
    assert t2.left.round == t.left.round and t2.num_bvh_hits == t.num_bvh_hits
    assert torch.equal(t2.camera.location, t.camera.location)
    t2.compute(2048)
    t.compute(2048)
    assert torch.equal(t2.buffer.count, t.buffer.count)
    torch.testing.assert_close(t2.buffer.acc, t.buffer.acc, rtol=0, atol=0)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """A file written by either package loads in the other; both
    sessions then compute the same ticks to the same buffers."""
    j, t = _pair()
    j.update_camera((0.2, 1.1, -2.5), 0.2, 0.05)
    t.update_camera((0.2, 1.1, -2.5), 0.2, 0.05)
    assert j.compute(3072) == t.compute(3072)
    path = str(tmp_path / "c.npz")
    (jckpt if writer == "jax" else tckpt).save(path, j if writer == "jax" else t)
    j2, t2 = _pair()
    jckpt.load(path, j2)
    tckpt.load(path, t2)
    np.testing.assert_array_equal(t2.buffer.acc.numpy(), np.asarray(j2.buffer.acc))
    np.testing.assert_array_equal(t2.camera.location.numpy(), np.asarray(j2.camera.location))
    assert (t2.left.round, t2.right.round) == (j2.left.round, j2.right.round)
    assert j2.compute(2048) == t2.compute(2048)
    _assert_buffers_match(j2, t2)
    assert t2.buffer.count.sum() > t.buffer.count.sum()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_photons_and_adaptive_ledger(tmp_path, writer):
    """PNEE with adaptive sampling on both halves: the photon grid (its
    sampling tables built anew), the rays-traced ledger and the sweep
    position cross packages, and the resumed renders agree."""
    kw = dict(adaptive=True, total_photons=4000, photon_grid_res=8)
    j, t = _pair(left=(2,), right=(2,), **kw)
    assert j.compute(8192) == t.compute(8192)
    assert int(t.left.photon_grid.num_photons) > 0 and t.left._rays_traced > 0
    path = str(tmp_path / "c.npz")
    (jckpt if writer == "jax" else tckpt).save(path, j if writer == "jax" else t)
    j2, t2 = _pair(left=(2,), right=(2,), **kw)
    jckpt.load(path, j2)
    tckpt.load(path, t2)
    for name in ("left", "right"):
        ji, ti = getattr(j2, name), getattr(t2, name)
        assert ti._rays_traced == ji._rays_traced > 0
        assert int(ti._sweep) == int(ji._sweep) and ti._sweep.dtype == torch.int64
        assert ti.num_bvh_hits == ji.num_bvh_hits
        assert ti.photon_grid._tables is None and ti.photon_grid.res == ji.photon_grid.res
        assert int(ti.photon_grid.num_photons) == int(ji.photon_grid.num_photons)
        assert ti.photon_grid.num_photons.dtype == torch.int64
        np.testing.assert_array_equal(ti.photon_grid.bins.numpy(),
                                      np.asarray(ji.photon_grid.bins))
    assert j2.compute(4096) == t2.compute(4096)
    _assert_buffers_match(j2, t2)


def test_checkpoint_without_adaptive_ledger(tmp_path):
    """Files from before the adaptive ledger load; the ledger keeps its
    reset state."""
    j, t = _pair()
    j.compute(2048)
    path = str(tmp_path / "c.npz")
    jckpt.save(path, j)
    z = dict(np.load(path))
    for name in ("left", "right"):
        for k in ("rays_traced", "sweep", "bvh_hits"):
            del z[f"{name}_{k}"]
    old = str(tmp_path / "old.npz")
    np.savez_compressed(old, **z)
    tckpt.load(old, t)
    assert t.left._rays_traced == 0 and t.left._sweep is None and t.num_bvh_hits == 0
    np.testing.assert_array_equal(t.buffer.count.numpy(), np.asarray(j.buffer.count))


def test_checkpoint_switches_scene_and_checks_viewport(tmp_path):
    j, _ = _pair(scene_id=101)
    path = str(tmp_path / "c.npz")
    jckpt.save(path, j)
    _, t = _pair()
    tckpt.load(path, t)
    assert t.scene_id == 101 and t.scene.num_shapes == j.scene.num_shapes
    t_small = Session(16, 16, scene_id=101, device="cpu")
    with pytest.raises(ValueError):
        tckpt.load(path, t_small)


# ---------------------------------------------------------------------------
# session: textures and per-region sample means
# ---------------------------------------------------------------------------

def test_store_texture_then_update_scene_matches_jax():
    tex = np.random.default_rng(4).random((8, 8, 3), dtype=np.float32)
    j, t = _pair()
    assert j.store_texture(0, tex) is False and t.store_texture(0, tex) is False
    assert t.scene_id == 100 and t.scene.textures.shape[0] == 0    # no rebuild yet
    j.update_scene(101)
    t.update_scene(101)
    for k in TENSOR_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(j.scene, k)),
                                      getattr(t.scene, k).numpy(), err_msg=k)
    np.testing.assert_array_equal(t.scene.textures[0].numpy(), tex)


def test_round_samples_matches_jax():
    j, t = _pair(W=40, H=24)
    assert t.left.round_samples() == 0.0
    assert j.compute(5120) == t.compute(5120)
    for name in ("left", "right"):
        got, want = getattr(t, name).round_samples(), getattr(j, name).round_samples()
        assert isinstance(got, float) and got == pytest.approx(want, rel=1e-6) and got > 0


# ---------------------------------------------------------------------------
# the CLI's run-loop flags
# ---------------------------------------------------------------------------

BASE = ["--scene", "100", "--width", "128", "--height", "128", "--batch", "1024",
        "--lanes", "256", "--max-bounces", "3", "--device", "cpu"]


def test_cli_seconds_checkpoint_resume(tmp_path):
    """``--seconds`` runs the driver for a wall-clock budget; the state it
    saves resumes with ``--resume`` and grows by exactly ``--ticks``; the
    JAX package loads the port's file."""
    c1, c2 = str(tmp_path / "c1.npz"), str(tmp_path / "c2.npz")
    cli.main(BASE + ["--seconds", "0.5", "--checkpoint", c1, "--out",
                     str(tmp_path / "a.png")])
    n1 = np.load(c1)["count"].sum()
    assert n1 >= 1024 and (tmp_path / "a.png").read_bytes()[:4] == b"\x89PNG"
    cli.main(BASE + ["--resume", c1, "--ticks", "2048", "--checkpoint", c2,
                     "--out", str(tmp_path / "b.png")])
    z = np.load(c2)
    assert z["count"].sum() == n1 + 2048
    assert int(z["left_round"]) == int(np.load(c1)["left_round"]) + 1
    j, _ = _pair(W=128, H=128)
    jckpt.load(c2, j)
    assert float(np.asarray(j.buffer.count).sum()) == n1 + 2048


def test_cli_ticks_default_is_none():
    args = cli.build_parser().parse_args([])
    assert args.ticks is None and args.seconds == 5.0 and args.device == "cuda"
    assert args.whitted is None and args.checkpoint is None and args.resume is None
