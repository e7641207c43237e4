"""Compute: intersection math, the CUDA scene kernels and their plain
versions, tracing, the integrator, accumulation and pixel selection.
``_build`` compiles the CUDA sources at first use, never at import."""
