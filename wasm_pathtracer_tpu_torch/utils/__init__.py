from wasm_pathtracer_tpu_torch.utils import vecmath  # noqa: F401
