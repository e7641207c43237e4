"""Runnable demonstrations of the port (``python -m
wasm_pathtracer_tpu_torch.examples.<name>``)."""
