"""Milliseconds of ``Session.results()`` (the uint8 frame on the host),
the median over the window's frames (host clock)."""

import statistics


def read(obs):
    r = obs.host.get("readout_s")
    return 1e3 * statistics.median(r) if r else None
