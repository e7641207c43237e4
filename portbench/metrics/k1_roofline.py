"""K1 (scene_kernels.fused_nearest): share of its roofline over sampled calls of the profiled
frames, 100 x the calls' summed bound (``portbench.workcount.k1_bound``,
counted from each call's own inputs) over the same calls' summed device
time (device trace)."""

from portbench import harness, workcount


def read(obs):
    return harness.roofline_pct(obs.profile, "fused_nearest", "fused_nearest_kernel", workcount.k1_bound)
