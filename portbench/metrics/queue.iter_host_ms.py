"""Host milliseconds of one queue loop iteration: the mean duration of the
port's ``wpt/queue.iter`` spans in the profiled frames, the loop's host
read of ``alive.any()`` left out (program span)."""

from portbench import spans


def read(obs):
    its = spans.select(spans.spans_of(obs.profile), "queue.iter")
    return spans.total_ms(its) / len(its) if its else None
