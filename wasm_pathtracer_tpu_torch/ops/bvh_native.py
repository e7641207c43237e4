"""ctypes loader for the native C++ BVH builder
(``wasm_pathtracer_tpu.ops.bvh_native``).

The builder is the repository's host C++ source ``csrc/bvh_builder.cpp``
(binned-SAH BVH2 and the 2->4 collapse; no GPU code).  It is compiled
with ``g++`` at first use into ``build/bvh/<hash>/`` beside the package,
keyed by a hash of the source, the flags and the host (``-march=native``
code may not run on another machine), and never into the source's own
directory.  Every failure raises, so callers can fall back
to the NumPy builder (``ops.bvh.build_bvh2``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import platform
import subprocess
import tempfile

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "csrc" / "bvh_builder.cpp"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "bvh"
# the flags the JAX package builds the same source with: the same
# compiler output gives the same leaf order, hence the same clusters
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]


def _lib_path() -> pathlib.Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS + [platform.node(), platform.machine()]).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libbvh.so"


@functools.cache
def _load() -> ctypes.CDLL:
    lib = _lib_path()
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        try:
            subprocess.run(["g++", *FLAGS, "-o", tmp, str(SOURCE)],
                           check=True, capture_output=True)
            os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    L = ctypes.CDLL(str(lib))
    L.bvh_build.restype = ctypes.c_int64
    L.bvh_build.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    return L


def build(lo: np.ndarray, hi: np.ndarray, num_bins: int = 16):
    """Binned-SAH BVH over (N, 3) primitive AABBs.

    Returns (bounds4 (M, 4, 6) f32, child4 (M, 4) int32, order (N,)
    int64): the 4-wide node arrays and the leaf-contiguous permutation
    of the input primitive ids.
    """
    L = _load()
    n = lo.shape[0]
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    if hi.shape != lo.shape or lo.shape != (n, 3):
        raise ValueError(f"lo {lo.shape} and hi {hi.shape} must both be (N, 3)")
    max_nodes = max(2 * n, 16)
    bounds4 = np.zeros((max_nodes, 4, 6), np.float32)
    child4 = np.full((max_nodes, 4), -1, np.int32)
    order = np.zeros((n,), np.int64)
    m = L.bvh_build(lo.ctypes.data, hi.ctypes.data, n, num_bins,
                    bounds4.ctypes.data, child4.ctypes.data, order.ctypes.data,
                    max_nodes)
    if m < 0:
        raise RuntimeError(f"bvh_build failed: {m}")
    return bounds4[:m].copy(), child4[:m].copy(), order
