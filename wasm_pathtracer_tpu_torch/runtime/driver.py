"""Progressive render driver (``wasm_pathtracer_tpu.runtime.driver``).

Keeps computing ticks, auto-tuning the batch so that each step takes
about 50 ms of wall time, with pause and deferred camera and viewport
updates (applied at the top of the next step).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from wasm_pathtracer_tpu_torch.runtime.session import Session

TARGET_TICK_SECONDS = 0.05
INITIAL_TICKS = 500


class Driver:
    def __init__(self, session: Session,
                 on_frame: Optional[Callable] = None,
                 target_tick: float = TARGET_TICK_SECONDS):
        self.session = session
        self.on_frame = on_frame
        self.target_tick = target_tick
        self.ticks_per_step = INITIAL_TICKS
        self.running = False
        self.total_ticks = 0
        self._pending_camera = None
        self._pending_viewport = None

    # deferred control updates, applied at the top of the next step
    def request_camera(self, location, rot_x, rot_y):
        self._pending_camera = (location, rot_x, rot_y)

    def request_viewport(self, width, height):
        self._pending_viewport = (width, height)

    def _apply_pending(self):
        if self._pending_viewport is not None:
            self.session.update_viewport(*self._pending_viewport)
            self._pending_viewport = None
        if self._pending_camera is not None:
            self.session.update_camera(*self._pending_camera)
            self._pending_camera = None

    def step(self) -> float:
        """One tick batch; returns the wall seconds it took.

        ``Session.compute`` ends in one host read of the cost counters,
        which waits for the device, so the time includes the batch's
        device work without a sync of its own.
        """
        self._apply_pending()
        t0 = time.perf_counter()
        traced = self.session.compute(self.ticks_per_step)
        dt = time.perf_counter() - t0
        self.total_ticks += traced
        # rescale the batch toward the wall-clock target
        if dt > 0:
            self.ticks_per_step = max(
                1, int(self.ticks_per_step * self.target_tick / dt))
        if self.on_frame is not None:
            self.on_frame(self.session)
        return dt

    def run(self, seconds: float | None = None, steps: int | None = None):
        """Run until paused, or for a wall-time or step budget."""
        self.running = True
        t_end = None if seconds is None else time.perf_counter() + seconds
        n = 0
        while self.running:
            self.step()
            n += 1
            if steps is not None and n >= steps:
                break
            if t_end is not None and time.perf_counter() >= t_end:
                break

    def pause(self):
        # the accumulation is kept across a pause
        self.running = False
