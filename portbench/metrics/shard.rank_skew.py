"""Balance of the ranks: the largest rank's queue-loop iterations in the
window (``Session.num_queue_iters``, gathered to rank 0) over the mean
of all ranks' (program counter).  1.0 when every shard took as many
iterations."""


def read(obs):
    iters = obs.counters.get("rank_queue_iters")
    if not iters or len(iters) < 2 or sum(iters) <= 0:
        return None
    return max(iters) / (sum(iters) / len(iters))
