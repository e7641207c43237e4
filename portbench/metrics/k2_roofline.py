"""K2 (scene_kernels.fused_occluded): share of its roofline over sampled calls of the profiled
frames, 100 x the calls' summed bound (``portbench.workcount.k2_bound``,
counted from each call's own inputs) over the same calls' summed device
time (device trace)."""

from portbench import harness, workcount


def read(obs):
    return harness.roofline_pct(obs.profile, "fused_occluded", "fused_occluded_kernel", workcount.k2_bound)
