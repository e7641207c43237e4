"""Host milliseconds of a train step's forward (the leaves put into the
scene and the loss rendered): the port's ``wpt/train.forward`` spans in
the profiled steps over the steps (program span)."""

from portbench import spans


def read(obs):
    fwd = spans.select(spans.spans_of(obs.profile), "train.forward")
    return spans.total_ms(fwd) / obs.profile.units if fwd else None
