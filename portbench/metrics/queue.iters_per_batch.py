"""Queue loop iterations per batch in the profiled frames: the port's
``wpt/queue.iter`` spans over its ``wpt/queue`` spans, one a batch
(program span)."""

from portbench import spans


def read(obs):
    sp = spans.spans_of(obs.profile)
    n, batches = len(spans.select(sp, "queue.iter")), len(spans.select(sp, "queue"))
    return n / batches if n and batches else None
