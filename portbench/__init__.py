"""The benchmark of the PyTorch/CUDA port (``wasm_pathtracer_tpu_torch``)
on one NVIDIA H100.  Run a cell with::

    python3 -m portbench.run --workload museum.session --seed 1 --seconds 51 --trace 0

``BENCHMARK.json`` at the repository's root names the cells and metrics.
"""
