"""Host milliseconds of a batch's pixel pick (``adaptive.pick_pixels`` or
``random_pixels``): the port's ``wpt/session.pick`` spans over its
``wpt/session.batch`` spans in the profiled frames (program span)."""

from portbench import spans


def read(obs):
    sp = spans.spans_of(obs.profile)
    batches = len(spans.select(sp, "session.batch"))
    picks = spans.select(sp, "session.pick")
    return spans.total_ms(picks) / batches if batches and picks else None
