"""Compute: intersection math, the CUDA kernels (scene, cluster, sweep,
shade, regen) and their plain versions, tracing, the integrator with its
one regenerating-queue loop, accumulation and pixel selection.
``_build`` compiles the CUDA sources at first use, never at import."""
