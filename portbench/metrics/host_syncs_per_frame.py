"""Host reads of a device value a frame: the port's ``wpt/sync.<site>``
spans in the profiled frames over the frames (program span)."""

from portbench import spans


def read(obs):
    reads = spans.select(spans.spans_of(obs.profile), "sync.")
    return len(reads) / obs.profile.units if reads else None
