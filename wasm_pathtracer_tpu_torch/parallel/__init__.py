"""Training over the scene's differentiable leaves (``wasm_pathtracer_tpu.parallel``).

One process on one device for now; the pixel-partitioned rendering and
the gradient all-reduce over a ``torch.distributed`` group come with the
sharding slice."""

from wasm_pathtracer_tpu_torch.parallel.shard import make_train_step  # noqa: F401
