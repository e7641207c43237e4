"""Device kernels per queue iteration in the profiled frames: the trace's
kernels (copies and fills left out) over the launches of the
configuration's ``iteration_kernel`` in the same frames (device trace)."""

from portbench import harness


def read(obs):
    p = obs.profile
    if p is None:
        return None
    n = p.launched.get(obs.config.get("iteration_kernel"), 0)
    k = harness.device_kernels(p)
    return k / n if n and k else None
