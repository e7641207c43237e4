"""Device milliseconds of the all-reduces per profiled frame on rank 0:
the NCCL all-reduce kernels' (``ncclDevKernel_AllReduce*``) time in the
slice over its frames (device trace).  A kernel's time includes its wait
for the slowest rank to arrive."""

from portbench import shardwork


def read(obs):
    t = shardwork.allreduce_s(obs.profile)
    return 1e3 * t / obs.profile.units if t else None
