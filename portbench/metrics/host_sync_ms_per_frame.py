"""Host milliseconds a frame spends in its reads of device values: the
summed duration of the port's ``wpt/sync.<site>`` spans in the profiled
frames over the frames (program span)."""

from portbench import spans


def read(obs):
    reads = spans.select(spans.spans_of(obs.profile), "sync.")
    return spans.total_ms(reads) / obs.profile.units if reads else None
