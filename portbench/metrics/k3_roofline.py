"""K3 (probe_kernels.select_scan): share of its roofline over sampled calls of the profiled
frames, 100 x the calls' summed bound (``portbench.workcount.k3_bound``,
counted from each call's own inputs) over the same calls' summed device
time (device trace)."""

from portbench import harness, workcount


def read(obs):
    return harness.roofline_pct(obs.profile, "select_scan", "select_kernel", workcount.k3_bound)
