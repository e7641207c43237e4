"""The port's live session and HTTP viewer against the JAX package's, on
the CPU.

The tests of ``tests/test_live.py`` are mirrored: a JAX and a port
:class:`LiveSession` get the same control sequence, driven synchronously
through ``tick()``, and their ``status()`` and buffers are compared after
every tick (counts equal, radiance sums as ``test_torch_session.py``
compares them).  Both drivers read one fake clock (``time`` patched in
each driver module; every step takes exactly the target 0.5 s), so the
auto-tune keeps 500 ticks a step in both.  The HTTP tests bound every
wait: ``urllib`` timeouts, thread joins with a timeout, and ``stop()`` in
a ``finally``.
"""

import json
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from wasm_pathtracer_tpu.config import RenderSettings as JSettings
from wasm_pathtracer_tpu.config import RenderType as JType
from wasm_pathtracer_tpu.models.camera import initial_camera as jinitial_camera
from wasm_pathtracer_tpu.runtime import driver as jdriver
from wasm_pathtracer_tpu.runtime import live as jlive
from wasm_pathtracer_tpu.runtime.session import Session as JSession
from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.runtime import driver as tdriver
from wasm_pathtracer_tpu_torch.runtime import live as tlive
from wasm_pathtracer_tpu_torch.runtime.session import Session

W = H = 32
TARGET = 0.5
FAST = dict(max_bounces=3, ray_batch_size=1024, regen_lanes=256)


def _fake_time():
    """A clock that moves by exactly ``TARGET`` seconds a call."""
    calls = [0]

    def perf_counter():
        calls[0] += 1
        return calls[0] * TARGET
    return types.SimpleNamespace(perf_counter=perf_counter)


def _sessions(w, h, rt=1, **kw):
    kw = dict(FAST, **kw)
    js = JSettings(render_type=JType(rt), **kw)
    ts = RenderSettings(render_type=RenderType(rt), **kw)
    return (JSession(w, h, 100, left=js, right=js),
            Session(w, h, 100, left=ts, right=ts, device="cpu"))


@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdriver, "time", _fake_time())
        mp.setattr(tdriver, "time", _fake_time())
        j, t = _sessions(W, H)
        yield Pair(jlive.LiveSession(j, target_tick=TARGET),
                   tlive.LiveSession(t, target_tick=TARGET))


class Pair:
    """Both live sessions; every call goes to both."""

    def __init__(self, j, t):
        self.j, self.t = j, t

    def __getattr__(self, name):
        def both(*args, **kw):
            jr = getattr(self.j, name)(*args, **kw)
            tr = getattr(self.t, name)(*args, **kw)
            return jr, tr
        return both

    def check(self):
        """status() equal; buffers equal by the session rule."""
        js, ts = self.j.status(), self.t.status()
        # the port's status adds its regenerating-queue iteration count,
        # which the JAX session does not keep
        assert {k: v for k, v in ts.items() if k != "queue_iters"} == js
        assert isinstance(ts["queue_iters"], int) and ts["queue_iters"] >= 0
        jb, tb = self.j.session.buffer, self.t.session.buffer
        np.testing.assert_array_equal(tb.count.numpy(), np.asarray(jb.count))
        a0, a1 = np.asarray(jb.acc), tb.acc.numpy()
        assert np.isclose(a1, a0, rtol=1e-3, atol=2e-3).all(-1).mean() >= 0.99
        return ts

    def step(self, n=1):
        for _ in range(n):
            jr, tr = self.tick()
            assert jr == tr
        return self.check()

    def settings(self, rt):
        kw = dict(FAST)
        self.j.set_settings(JSettings(render_type=JType(rt), **kw),
                            JSettings(render_type=JType(rt), **kw))
        self.t.set_settings(RenderSettings(render_type=RenderType(rt), **kw),
                            RenderSettings(render_type=RenderType(rt), **kw))


def test_tick_renders_and_caches_frames(pair):
    fid0 = pair.t.status()["frame_id"]
    assert fid0 == pair.j.status()["frame_id"] == 1
    st = pair.step()
    assert st["frame_id"] > fid0 and st["total_ticks"] > 0
    assert st["ticks_per_step"] == 500
    assert pair.t.frame_png()[:8] == b"\x89PNG\r\n\x1a\n"


def test_key_moves_camera_next_tick(pair):
    """A key is deferred: the camera changes only after two ticks (the
    controller's update, then the session's)."""
    loc0 = pair.t.session.camera.location.clone()
    pair.key("w", count=10)
    assert torch.equal(pair.t.session.camera.location, loc0)
    pair.step(2)
    loc1 = pair.t.session.camera.location
    np.testing.assert_allclose(loc1.numpy(), np.asarray(pair.j.session.camera.location),
                               atol=1e-6)
    assert loc1[2] > loc0[2]


def test_pause_preserves_accumulation_and_resume_continues(pair):
    pair.step()
    pair.pause()
    st = pair.step()                    # applies the pause
    assert st["paused"]
    img0 = pair.t.session.image().copy()
    assert pair.step()["total_ticks"] == st["total_ticks"]   # a paused beat renders nothing
    assert np.array_equal(pair.t.session.image(), img0)
    pair.resume()
    pair.step()                         # applies the resume
    assert pair.step()["total_ticks"] > st["total_ticks"]


def test_set_settings_mid_run_restarts_accumulation(pair):
    pair.resume()
    pair.step(2)
    pair.settings(0)
    pair.step()
    assert pair.t.session.left.settings.render_type == RenderType.NO_NEE
    assert pair.t.session.right.settings.render_type == RenderType.NO_NEE


def test_set_scene_resets_camera(pair):
    pair.key("w", count=50)
    pair.step(2)
    pair.set_scene(101)
    pair.step()
    cam0 = jinitial_camera(101)
    assert pair.t.session.scene_id == 101
    np.testing.assert_array_equal(pair.t.session.camera.location.numpy(),
                                  np.asarray(cam0.location))
    # the controller was set silently: the next key starts from there
    np.testing.assert_array_equal(pair.t.controller.camera.location.numpy(),
                                  np.asarray(cam0.location))
    pair.set_scene(100)
    pair.step()


def test_set_viewport_resizes(pair):
    pair.set_viewport(16, 16)
    st = pair.step()
    assert (st["width"], st["height"]) == (16, 16)
    assert pair.t.session.results().shape == (16, 16, 3)
    pair.set_viewport(W, H)
    pair.step()


def test_show_sampling_toggle(pair):
    pair.set_show_sampling(True)
    pair.step()
    assert pair.t.show_sampling is True
    pair.set_show_sampling(False)
    pair.step()
    assert pair.t.show_sampling is False


def test_drag_to_pan_reference_clamp(pair):
    """A target smaller than the window stays within it; a larger one
    covers it.  Both packages give the same offsets."""
    assert pair.recenter() == ((240, 240), (240, 240))
    assert pair.pan(-10_000, -10_000)[1] == (0, 0)
    assert pair.pan(10_000, 10_000)[1] == (512 - W, 512 - H)
    pair.recenter()
    assert pair.pan(-3, 7) == ((237, 247), (237, 247))
    assert pair.pan(-3, 7)[1] == (234, 254)
    for live in (pair.j, pair.t):
        live.window_w = live.window_h = 16
    try:
        assert pair.pan(10_000, 10_000)[1] == (0, 0)
        assert pair.pan(-10_000, -10_000) == ((16 - W, 16 - H),) * 2
        assert pair.recenter()[1] == (round((16 - W) / 2), round((16 - H) / 2))
    finally:
        for live in (pair.j, pair.t):
            live.window_w = live.window_h = 512
        pair.recenter()
    pair.check()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as r:
        return r.read(), r.headers.get("Content-Type")


def test_http_endpoints():
    """The port's LiveServer over real HTTP: the page, the frame, status
    and the controls, driven by ticks on this thread."""
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, **dict(FAST, max_bounces=2))
    sess = Session(16, 16, 100, left=st, right=st, device="cpu")
    live = tlive.LiveSession(sess, target_tick=0.01)
    server = tlive.LiveServer(live, port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        body, ctype = _get(base, "/")
        assert b"wasm_pathtracer_tpu" in body and "text/html" in ctype
        live.tick()
        body, ctype = _get(base, "/frame.png")
        assert body[:8] == b"\x89PNG\r\n\x1a\n" and ctype == "image/png"
        status = json.loads(_get(base, "/status")[0])
        assert status["width"] == 16 and status["scene"] == 100
        assert _get(base, "/key?k=w&n=5")[0] == b"ok"
        loc0 = sess.camera.location.clone()
        live.tick()
        live.tick()
        assert not torch.equal(sess.camera.location, loc0)
        _get(base, "/pause")
        live.tick()
        assert live.paused
        _get(base, "/resume")
        live.tick()
        assert not live.paused
        _get(base, "/settings?left=0&right=2&right_adaptive=1")
        live.tick()
        assert sess.left.settings.render_type == RenderType.NO_NEE
        assert sess.right.settings.render_type == RenderType.PNEE
        assert sess.right.settings.adaptive is True
        _get(base, "/sampling?on=1")
        _get(base, "/viewport?w=24&h=20")
        _get(base, "/scene?id=101")
        live.tick()
        status = json.loads(_get(base, "/status")[0])
        assert (status["width"], status["height"], status["scene"]) == (24, 20, 101)
        assert live.show_sampling is True
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base, "/nope")
        assert e.value.code == 404
    finally:
        server.stop()


def test_pan_http_endpoints(pair):
    """/pan and /recenter return the clamped offsets, and /status reports
    them."""
    server = tlive.LiveServer(pair.t, port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        pair.t.recenter()
        assert json.loads(_get(base, "/pan?dx=-10000&dy=5")[0]) == {"x": 0, "y": 245}
        assert json.loads(_get(base, "/recenter")[0]) == {"x": 240, "y": 240}
        status = json.loads(_get(base, "/status")[0])
        assert status["pan_x"] == 240 and status["pan_y"] == 240
        assert b"mousedown" in _get(base, "/")[0]
    finally:
        server.stop()


def test_render_thread_serves_and_stops():
    """The render thread steps on its own while the server answers; pause
    holds the tick count; both threads stop within their timeouts."""
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, **FAST)
    sess = Session(16, 16, 100, left=st, right=st, device="cpu")
    live = tlive.LiveSession(sess, target_tick=0.01)
    server = tlive.LiveServer(live, port=0)
    base = f"http://127.0.0.1:{server.port}"

    def status():
        return json.loads(_get(base, "/status")[0])

    def wait_for(cond, seconds=60.0):
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            s = status()
            if cond(s):
                return s
            time.sleep(0.05)
        raise AssertionError(f"timed out; last status {s}")

    server.start()
    live.start()
    try:
        wait_for(lambda s: s["frame_id"] >= 3)
        _get(base, "/pause")
        s0 = wait_for(lambda s: s["paused"])
        time.sleep(0.3)
        assert status()["total_ticks"] == s0["total_ticks"]
        _get(base, "/resume")
        wait_for(lambda s: s["total_ticks"] > s0["total_ticks"])
        thread = live._thread
        assert thread.is_alive()
    finally:
        live.stop()
        server.stop()
    assert not thread.is_alive() and live._thread is None


def test_main_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tlive.main(["--port", "0"])


@pytest.mark.gpu
def test_live_session_ticks_on_card():
    """Three ticks of a live session on the card: frames cached, ticks
    counted, the kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=4)
    live = tlive.LiveSession(Session(64, 64, 0, left=st, right=st, device="cuda"))
    n0 = sk.fused_nearest.launches
    for _ in range(3):
        live.tick()
    s = live.status()
    assert s["frame_id"] == 4 and s["total_ticks"] > 0
    assert sk.fused_nearest.launches > n0
    assert live.frame_png()[:8] == b"\x89PNG\r\n\x1a\n"
