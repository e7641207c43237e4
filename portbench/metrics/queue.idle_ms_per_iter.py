"""Milliseconds a queue loop iteration leaves the device idle: the time
inside the port's ``wpt/queue`` spans of the profiled frames in which no
device operation ran (device trace and spans on the profiler's one
clock), over the ``wpt/queue.iter`` spans (program span)."""

from portbench import spans


def read(obs):
    sp = spans.spans_of(obs.profile)
    n = len(spans.select(sp, "queue.iter"))
    idle = spans.idle_ms_inside(obs.profile, spans.select(sp, "queue"))
    return idle / n if n and idle is not None else None
