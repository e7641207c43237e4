"""Queue iterations per batch in the window: launches of the kernel that
runs once per loop iteration (the configuration's ``iteration_kernel``:
K1 on a dense scene, K3 on a clustered one) over the batches written
(program counters)."""


def read(obs):
    n = obs.counters["launches"].get(obs.config.get("iteration_kernel"), 0)
    b = obs.counters.get("batches", 0)
    return n / b if n and b else None
