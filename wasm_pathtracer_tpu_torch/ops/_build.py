"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

``csrc/*.cu`` compile into one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds).  The library goes to
``build/kernels/<hash>/`` beside the package, keyed by a hash of every
source, and is built at first use.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC.parent.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # tables, 6 family counts, o, d, R, t_out, fam_out, slot_out, stream
    "wpt_fused_nearest": [_P] + [_I] * 6 + [_P, _P, _I, _P, _P, _P, _P],
    # tables, 6 family counts, o, d, dist, excl, R, occ_out, stream
    "wpt_fused_occluded": [_P] + [_I] * 6 + [_P, _P, _P, _P, _I, _P, _P],
    # aabbs, C, o, d, skip_e, skip_c, R, ent_out, cid_out, stream
    "wpt_select": [_P, _I, _P, _P, _P, _P, _I, _P, _P, _P],
    # ... as wpt_select, then dense tables, 6 family counts, dense sids,
    # t_out, sid_out, stream
    "wpt_select_scan": [_P, _I, _P, _P, _P, _P, _I, _P, _P, _P] + [_I] * 6
                       + [_P, _P, _P, _P],
    # table, C, G, o, d, cidx, n_rounds, R, t_out, sid_out, stream
    "wpt_probe": [_P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P],
    # table, C, G, o, d, cidx, R, dist_out, stream
    "wpt_probe_blocks": [_P, _I, _I, _P, _P, _P, _I, _P, _P],
    # tris, T, o, d, R, packed scratch, t_out, slot_out, stream
    "wpt_dense_tri_nearest": [_P, _I, _P, _P, _I, _P, _P, _P, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the scene kernels")


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the sources if no library for their hash exists yet;
    return the library's path.  Each ``.cu`` compiles in its own ``nvcc``
    process, all started together, then one link.  The compiler's report
    (registers, shared memory, spills per kernel) is kept beside the
    library as ``ptxas.txt``."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "libwpt_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = pathlib.Path(tempfile.mkdtemp(dir=out_dir))
    try:
        procs = []
        for cu in sorted(CSRC.glob("*.cu")):
            obj = work / (cu.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", "-I", str(CSRC),
                   "-o", str(obj), str(cu)]
            procs.append((cu.name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        # wait for every compile before looking at any result
        errs = [proc.communicate()[1] for _, _, proc in procs]
        report = []
        for (name, _, proc), err in zip(procs, errs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):\n{err}")
            report.append(f"== {name}\n{err}")
        tmp = work / "lib.so"
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *(str(obj) for _, obj, _ in procs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        (out_dir / "ptxas.txt").write_text("\n".join(report))
        os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, with argument types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
