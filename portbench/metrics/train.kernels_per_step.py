"""Device kernels per train step in the profiled steps (device trace;
copies and fills left out)."""

from portbench import harness


def read(obs):
    p = obs.profile
    n = 0 if p is None else harness.device_kernels(p)
    return n / p.units if n and p.units else None
