"""Pixel-partition rendering and training over a ``torch.distributed``
group (``wasm_pathtracer_tpu.parallel``)."""

from wasm_pathtracer_tpu_torch.parallel.shard import (  # noqa: F401
    make_ray_mesh,
    render_image_sharded,
    render_queue_sharded,
    render_queue_flat_sharded,
    make_train_step,
)
