"""The all-reduces' bus bandwidth as a share of one card's NVLink
bandwidth: bytes all-reduced in the profiled slice (``RayMesh``'s host
count) x 2 (n - 1) / n over the all-reduce kernels' device time
(``shard.allreduce_ms_per_frame``'s), over the links' bandwidth read on
the card (``portbench/workcount/h100_nvlink.json``) (device trace).

The kernels' time includes each all-reduce's wait for the slowest rank
to arrive, and rank 0 traces the fewest paths, so it waits at every
batch: the figure reads the links' use and the ranks' arrival skew
together, and stays below what the links alone would give."""

from portbench import shardwork


def read(obs):
    t = shardwork.allreduce_s(obs.profile)
    n = obs.counters.get("ranks", 0)
    b = obs.counters.get("slice_bytes_all_reduced", 0)
    link = shardwork.link_bytes_per_s()
    if not t or n < 2 or not b or not link:
        return None
    return 100.0 * b * 2 * (n - 1) / n / t / link
