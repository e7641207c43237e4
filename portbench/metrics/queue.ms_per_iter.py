"""Host milliseconds per queue iteration: the host time of the window's
``Session.compute`` calls over the iterations counted as in
``session.iters_per_batch`` (host clock; it holds the session's
per-batch work too)."""


def read(obs):
    n = obs.counters["launches"].get(obs.config.get("iteration_kernel"), 0)
    return 1e3 * sum(obs.host["compute_s"]) / n if n else None
