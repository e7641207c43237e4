"""Share of the profiled frames' queue iterations whose regeneration took
the port's regen kernel: the trace's device operations whose name holds
``wpt_regen_kernel`` over the launches of the configuration's
``iteration_kernel`` in the same frames (device trace).  1.0 when every
iteration regenerated in one launch; 0 for a program that regenerates in
eager ops."""

KERNEL = "wpt_regen_kernel"


def read(obs):
    p = obs.profile
    if p is None:
        return None
    n = p.launched.get(obs.config.get("iteration_kernel"), 0)
    if not n:
        return None
    return sum(1 for name, _, _ in p.device_ops if KERNEL in name) / n
