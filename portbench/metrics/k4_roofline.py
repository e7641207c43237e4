"""K4 (probe_kernels.probe_pair): share of its roofline over sampled calls of the profiled
frames, 100 x the calls' summed bound (``portbench.workcount.k4_bound``,
counted from each call's own inputs) over the same calls' summed device
time (device trace)."""

from portbench import harness, workcount


def read(obs):
    return harness.roofline_pct(obs.profile, "probe_pair", "probe_kernel", workcount.k4_bound)
