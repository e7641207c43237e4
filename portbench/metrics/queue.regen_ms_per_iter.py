"""Host milliseconds a queue loop iteration spends in regeneration: the
splat of finished paths, the claim and the new primary rays: the port's
``wpt/regen`` spans inside its ``wpt/queue.iter`` spans in the profiled
frames, summed, over the iterations (program span)."""

from portbench import spans


def read(obs):
    sp = spans.spans_of(obs.profile)
    n = len(spans.select(sp, "queue.iter"))
    part = spans.select(sp, "regen", inside="queue.iter")
    return spans.total_ms(part) / n if n and part else None
