"""Host milliseconds a queue loop iteration spends in shading: the
estimator step (pcg3d draws, BSDF, the NEE pick) and the NEE resolve:
the port's ``wpt/shade`` spans inside its ``wpt/queue.iter`` spans in
the profiled frames, summed, over the iterations (program span)."""

from portbench import spans


def read(obs):
    sp = spans.spans_of(obs.profile)
    n = len(spans.select(sp, "queue.iter"))
    part = spans.select(sp, "shade", inside="queue.iter")
    return spans.total_ms(part) / n if n and part else None
