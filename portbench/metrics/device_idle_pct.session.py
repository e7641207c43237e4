"""Share of a session's profiled frames in which the device ran nothing:
100 x (1 - device busy seconds / wall seconds), from ``torch.profiler``
over the frames after the window (device trace)."""

from portbench import harness


def read(obs):
    return harness.idle_pct(obs.profile)
