"""Milliseconds of ``Session.results()`` a frame: the port's
``wpt/session.results`` spans in the profiled frames over the frames
(program span)."""

from portbench import spans


def read(obs):
    res = spans.select(spans.spans_of(obs.profile), "session.results")
    return spans.total_ms(res) / obs.profile.units if res else None
