"""Live interactive session and HTTP viewer (``wasm_pathtracer_tpu.runtime.live``).

- :class:`LiveSession` is the control surface.  A render thread steps a
  :class:`Driver` continuously.  Every control (camera keys, scene and
  settings switches, viewport, pause and resume) is deferred and applied
  by the render thread at the top of its next tick.  The latest frame is
  cached as PNG bytes after each step.
- :class:`LiveServer` is an HTTP server on the standard library serving
  a one-page viewer: the page polls ``/frame.png`` and sends keys and
  controls back as query endpoints.

Only the render thread launches kernels or touches the session's
tensors.  On a CUDA session the kernels are built on the constructing
thread, before :meth:`LiveSession.start`; the HTTP handler threads read
the cached PNG bytes and host integers only.

Usage:
  python -m wasm_pathtracer_tpu_torch.runtime.live --scene 100 --port 8000
(``--device cuda`` is the default; asking for it without a card is an
error.)
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models.camera import initial_camera
from wasm_pathtracer_tpu_torch.runtime.camera_controller import CameraController
from wasm_pathtracer_tpu_torch.runtime.driver import Driver
from wasm_pathtracer_tpu_torch.runtime.session import Session
from wasm_pathtracer_tpu_torch.utils.png import encode_png


class LiveSession:
    """Driver, camera controller and frame cache behind a control queue.

    Every session mutation runs on the render thread; a control call
    enqueues it and returns at once.
    """

    def __init__(self, session: Session, target_tick: float = 0.05):
        self.session = session
        if session.device.type == "cuda":
            from wasm_pathtracer_tpu_torch.ops import _build
            _build.library()
        self.driver = Driver(session, on_frame=self._capture,
                             target_tick=target_tick)
        self.controller = CameraController(
            session.camera, on_update=self._on_camera)
        self.paused = False
        self.show_sampling = False
        # drag-to-pan: the render target's offset within the fixed
        # on-screen window.  View state only (the session is not
        # touched), so it changes at once, under the lock.
        self.window_w = 512
        self.window_h = 512
        self.pan_x = 0
        self.pan_y = 0
        self._pending = []                 # deferred control closures
        self._lock = threading.Lock()
        self._frame_png: bytes = b""
        self._frame_id = 0
        self._alive = False
        self._thread: threading.Thread | None = None
        self._capture(session)

    # -- render thread ------------------------------------------------
    def start(self):
        self._alive = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._alive = False
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def _loop(self):
        while self._alive:
            self.tick()

    def tick(self):
        """One render step (or an idle beat while paused) after the
        pending controls.  Public so that a caller can drive the loop
        synchronously."""
        with self._lock:
            pending, self._pending = self._pending, []
        for fn in pending:
            fn(self.session)
        if self.paused:
            # a pause keeps the accumulation
            time.sleep(0.02)
            return 0.0
        return self.driver.step()

    def _capture(self, session: Session):
        png = encode_png(session.results(show_sampling=self.show_sampling))
        with self._lock:
            self._frame_png = png
            self._frame_id += 1

    # -- frames ---------------------------------------------------------
    def frame_png(self) -> bytes:
        with self._lock:
            return self._frame_png

    # -- controls (all deferred to the next tick) -----------------------
    def _defer(self, fn):
        with self._lock:
            self._pending.append(fn)

    def _on_camera(self, cam):
        self._defer(lambda s: s.update_camera(
            tuple(cam.location.cpu().tolist()), float(cam.rot_x), float(cam.rot_y)))

    def key(self, name: str, count: int = 1):
        """Camera key (WASD, arrows, pageup, pagedown).  Deferred: a
        handler thread must not change the controller while the render
        thread reads it (concurrent keys would lose updates)."""
        self._defer(lambda s: self.controller.key(name, count))

    def pause(self):
        self._defer(lambda s: setattr(self, "paused", True))

    def resume(self):
        # the pending controls run even while paused, so a resume always
        # takes effect at the next tick
        self._defer(lambda s: setattr(self, "paused", False))

    def set_scene(self, scene_id: int):
        def apply(s: Session):
            s.update_scene(scene_id)
            cam = initial_camera(scene_id, s.device)
            s.camera = cam
            self.controller.set_silent(cam)
        self._defer(apply)

    def set_settings(self, left: RenderSettings, right: RenderSettings):
        """Switch the estimators mid-run; the render starts over."""
        self._defer(lambda s: s.update_settings(left, right))

    def set_viewport(self, width: int, height: int):
        def apply(s: Session):
            s.update_viewport(width, height)
            # a resized target must stay inside the window
            with self._lock:
                self._reclamp_locked()
        self._defer(apply)

    # -- drag-to-pan ------------------------------------------------------
    def _reclamp_locked(self):
        """A target smaller than the window stays within the window; a
        larger one must cover it (no background past an edge)."""
        tw, th = self.session.width, self.session.height
        if tw < self.window_w:
            self.pan_x = min(max(self.pan_x, 0), self.window_w - tw)
        else:
            self.pan_x = min(max(self.pan_x, self.window_w - tw), 0)
        if th < self.window_h:
            self.pan_y = min(max(self.pan_y, 0), self.window_h - th)
        else:
            self.pan_y = min(max(self.pan_y, self.window_h - th), 0)

    def pan(self, dx: int, dy: int) -> tuple[int, int]:
        """Drag the render target by (dx, dy) inside the window,
        reclamped; returns the new offsets."""
        with self._lock:
            self.pan_x += int(dx)
            self.pan_y += int(dy)
            self._reclamp_locked()
            return self.pan_x, self.pan_y

    def recenter(self) -> tuple[int, int]:
        """Centre the target in the window."""
        with self._lock:
            self.pan_x = round((self.window_w - self.session.width) / 2)
            self.pan_y = round((self.window_h - self.session.height) / 2)
            return self.pan_x, self.pan_y

    def set_show_sampling(self, flag: bool):
        self._defer(lambda s: setattr(self, "show_sampling", bool(flag)))

    def status(self) -> dict:
        """Host-side state only (safe from any thread)."""
        return dict(paused=self.paused,
                    total_ticks=self.driver.total_ticks,
                    ticks_per_step=self.driver.ticks_per_step,
                    frame_id=self._frame_id,
                    width=self.session.width, height=self.session.height,
                    scene=self.session.scene_id,
                    bvh_visits=self.session.num_bvh_hits,
                    queue_iters=self.session.num_queue_iters,
                    pan_x=self.pan_x, pan_y=self.pan_y)


_PAGE = """<!doctype html><html><head><title>wasm_pathtracer_tpu_torch</title>
<style>body{background:#111;color:#ccc;font-family:monospace}
img{image-rendering:pixelated;position:absolute;left:0;top:0}
#win{position:relative;overflow:hidden;width:512px;height:512px;
border:1px solid #444;background:#3e3e3e;cursor:grab}</style></head><body>
<h3>wasm_pathtracer_tpu_torch &mdash; live</h3>
<div id=win><img id=v draggable=false></div>
<button onclick="fetch('/pause')">pause</button>
<button onclick="fetch('/resume')">resume</button>
<button onclick="pan('/recenter')">recenter</button>
scene:<select id=sc onchange="fetch('/scene?id='+this.value)">
<option value=0>museum</option><option value=2>bunny</option>
<option value=3>cloud100</option><option value=4>cloud10k</option>
<option value=5>cloud100k</option>
<option value=100 selected>sphere+plane</option>
<option value=101>whitted</option></select>
left:<select id=lt onchange="st()"><option value=0>NoNEE</option>
<option value=1 selected>NEE</option><option value=2>PNEE</option></select>
right:<select id=rt onchange="st()"><option value=0>NoNEE</option>
<option value=1 selected>NEE</option><option value=2>PNEE</option></select>
<label><input id=ra type=checkbox onchange="st()">right adaptive</label>
<span id=stat></span>
<script>
function st(){fetch('/settings?left='+lt.value+'&right='+rt.value+
  '&right_adaptive='+(ra.checked?1:0))}
// drag-to-pan (reference CanvasElement, render_target.ts:63-149):
// deltas accumulate client-side and drain through ONE in-flight
// request at a time — per-mousemove fetches would race (out-of-order
// responses apply stale offsets) and flood the server
async function pan(url){const r=await(await fetch(url)).json();
  v.style.left=r.x+'px';v.style.top=r.y+'px'}
let down=false,pdx=0,pdy=0,panning=false;
async function flushPan(){if(panning)return;panning=true;
  try{while(pdx||pdy){const dx=pdx,dy=pdy;pdx=0;pdy=0;
    await pan('/pan?dx='+dx+'&dy='+dy)}}finally{panning=false}}
win.addEventListener('mousedown',e=>{down=true;e.preventDefault()});
document.addEventListener('mouseup',()=>{down=false});
document.addEventListener('mousemove',e=>{
  if(down&&(e.buttons&1)){pdx+=e.movementX;pdy+=e.movementY;flushPan()}});
const KEYS={w:'w',a:'a',s:'s',d:'d',ArrowLeft:'left',ArrowRight:'right',
  ArrowUp:'up',ArrowDown:'down',PageUp:'pageup',PageDown:'pagedown'};
document.addEventListener('keydown',e=>{const k=KEYS[e.key];
  if(k){fetch('/key?k='+k+'&n=10');e.preventDefault()}});
setInterval(()=>{v.src='/frame.png?'+Date.now()},250);
setInterval(async()=>{const r=await(await fetch('/status')).json();
  stat.textContent=' ticks:'+r.total_ticks+(r.paused?' [paused]':'')},1000);
</script></body></html>"""

class LiveServer:
    """HTTP front end over a :class:`LiveSession`."""

    def __init__(self, live: LiveSession, host: str = "127.0.0.1",
                 port: int = 8000):
        self.live = live
        live_ref = live

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # quiet
                pass

            def _ok(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                p = u.path
                if p == "/":
                    return self._ok(_PAGE.encode(), "text/html")
                if p == "/frame.png":
                    return self._ok(live_ref.frame_png(), "image/png")
                if p == "/status":
                    return self._ok(json.dumps(live_ref.status()).encode(),
                                    "application/json")
                if p == "/pan":
                    x, y = live_ref.pan(int(q.get("dx", 0)),
                                        int(q.get("dy", 0)))
                    return self._ok(json.dumps({"x": x, "y": y}).encode(),
                                    "application/json")
                if p == "/recenter":
                    x, y = live_ref.recenter()
                    return self._ok(json.dumps({"x": x, "y": y}).encode(),
                                    "application/json")
                if p == "/key":
                    live_ref.key(q.get("k", ""), int(q.get("n", 1)))
                elif p == "/pause":
                    live_ref.pause()
                elif p == "/resume":
                    live_ref.resume()
                elif p == "/scene":
                    live_ref.set_scene(int(q.get("id", 0)))
                elif p == "/viewport":
                    live_ref.set_viewport(int(q["w"]), int(q["h"]))
                elif p == "/sampling":
                    live_ref.set_show_sampling(q.get("on", "1") == "1")
                elif p == "/settings":
                    def rs(key, akey):
                        return RenderSettings(
                            render_type=RenderType(int(q.get(key, 1))),
                            adaptive=q.get(akey, "0") == "1")
                    live_ref.set_settings(rs("left", "left_adaptive"),
                                          rs("right", "right_adaptive"))
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                return self._ok(b"ok", "text/plain")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", type=int, default=100)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-bounces", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (default cuda)")
    args = p.parse_args(argv)

    st = RenderSettings(render_type=RenderType.NORMAL_NEE,
                        max_bounces=args.max_bounces)
    sess = Session(args.width, args.height, args.scene, left=st, right=st,
                   device=args.device)
    live = LiveSession(sess)
    server = LiveServer(live, port=args.port)
    server.start()
    live.start()
    print(f"live viewer on http://127.0.0.1:{server.port}/ "
          f"(WASD + arrows to move, scene/estimator switch in the page)")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        live.stop()
        server.stop()


if __name__ == "__main__":
    main()
