"""Device memory of one train step: ``torch.cuda.max_memory_allocated()``
over one step after ``reset_peak_memory_stats()``, in GiB (program
counter)."""


def read(obs):
    b = obs.host.get("step_peak_bytes")
    return None if b is None else b / 2 ** 30
