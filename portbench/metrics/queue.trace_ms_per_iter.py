"""Host milliseconds a queue loop iteration spends in scene queries: the
kernels' traces and shadow rays: the port's ``wpt/trace`` spans inside
its ``wpt/queue.iter`` spans in the profiled frames, summed, over the
iterations (program span)."""

from portbench import spans


def read(obs):
    sp = spans.spans_of(obs.profile)
    n = len(spans.select(sp, "queue.iter"))
    part = spans.select(sp, "trace", inside="queue.iter")
    return spans.total_ms(part) / n if n and part else None
