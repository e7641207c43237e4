"""wasm_pathtracer_tpu_torch — the path tracer on PyTorch and CUDA.

The PyTorch/CUDA counterpart of ``wasm_pathtracer_tpu``: the same
scene model, counter-based RNG streams and regenerating wavefront, with
the two scene kernels of the forward render path (nearest hit and
any-hit shadow query) written in CUDA C++ for Hopper (``csrc/``).
Every module mirrors the JAX module of the same name; plain tensor code
runs eagerly, and a kernel wrapper takes its plain PyTorch version only
for tensors that lie on the CPU.

Layout
------
- ``config``   — render settings (estimator, bounce cap, lanes).
- ``models``   — scene tables, built-in scenes, camera.
- ``ops``      — intersection math, the CUDA scene kernels and their
                 plain versions, tracing, the integrator, accumulation,
                 the edge-aware warps of the gradient path.
- ``parallel`` — the inverse-rendering train step.
- ``runtime``  — session API and CLI.
- ``utils``    — vec math, pcg3d RNG, PNG writer.

This package imports ``torch`` and never ``jax``.
"""

from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType

__version__ = "0.1.0"

__all__ = ["RenderSettings", "RenderType", "__version__"]
