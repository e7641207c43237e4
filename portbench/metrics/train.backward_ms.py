"""Host milliseconds of a train step's backward (``torch.autograd.grad``,
the checkpointed bounces traced again): the port's
``wpt/train.backward`` spans in the profiled steps over the steps
(program span)."""

from portbench import spans


def read(obs):
    bwd = spans.select(spans.spans_of(obs.profile), "train.backward")
    return spans.total_ms(bwd) / obs.profile.units if bwd else None
