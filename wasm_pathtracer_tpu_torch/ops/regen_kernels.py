"""One kernel for a queue iteration's regeneration (``regen.regen``).

:func:`fused_regen` launches ``wpt_regen_kernel`` (``csrc/regen_kernels.cu``),
which does all of ``regen.regen``'s work for one lane per thread, on
either route, and writes the lanes' registers in place: the paths that
end, their adds to the frame, the lane-order claims, the claim cursor and
each claimed path's jitter and primary ray.  Claims, ray ids and rays
are bit-equal to the eager code on the card; the frame's float sums are
taken by atomics, so in another order, as ``index_add_`` already does.

Its plain version is ``regen.regen``, which runs where the lanes are not
on the card.  Regeneration never carries a gradient, so nothing else
decides.  The wrapper counts its launches in ``fused_regen.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from wasm_pathtracer_tpu_torch.ops import regen as rg

_M32 = 0xFFFFFFFF
# lanes a block takes (64 to 512 ran within 10% of each other on the H100)
TILE = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong


class _Args(ctypes.Structure):
    """``RegenArgs`` of ``csrc/regen_kernels.cu``, field for field."""

    _fields_ = [(name, _P) for name in (
        "pixq", "acc", "cnt", "cam", "was", "resolve", "shade", "pend", "cont_prev",
        "cont_shade", "o_sh", "d_sh", "o", "d", "tp", "col", "absorb", "alive", "hdb",
        "bounce", "pid", "rid", "k_lane", "issued", "tr_o", "tr_d", "shadow", "need_scan",
        "tiles", "ticket")] + [(name, _L) for name in ("S", "K", "HW", "rid_base")] + [
        (name, _I) for name in ("n", "width", "max_bounces", "flat", "tile")] + [
        ("seed", ctypes.c_uint32)] + [(name, _F) for name in (
            "inv_w", "inv_h", "aspect", "screen_z")]


def _register(ln: rg.Lanes, name: str, dtype, shape):
    """``ln.<name>``, which the kernel writes in place: it must be
    contiguous, of ``dtype`` and ``shape``."""
    x = getattr(ln, name)
    if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"{name}: {x.dtype} {tuple(x.shape)}, expected a contiguous "
                         f"{dtype} {shape}")
    return x


def _input(x, dtype, shape, name):
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    return x.to(dtype).contiguous()


def fused_regen(q: rg.Queue, ln: rg.Lanes, was=None, fin: rg.Finalize | None = None):
    """``regen.regen(q, ln, was, fin)`` in one launch where the lanes lie on
    the card, the eager code elsewhere.  On the card ``ln``'s registers are
    written in place, so each must be contiguous and of its dtype."""
    if not ln.o.is_cuda:
        rg.regen(q, ln, was, fin)
        return
    if isinstance(q.seed, torch.Tensor):
        raise TypeError("fused_regen takes the seed as a host integer, not a tensor")
    from wasm_pathtracer_tpu_torch.ops import _build
    lib = _build.library()
    with torch.cuda.device(ln.o.device):
        _launch(lib, torch.cuda.current_stream(ln.o.device).cuda_stream, q, ln, was, fin)
    fused_regen.launches += 1


fused_regen.launches = 0


def _launch(lib, stream, q, ln, was, fin):
    """Check and lay out the operands and launch ``wpt_regen_kernel``
    (through the C entry point ``wpt_regen`` of ``lib``) on ``stream``."""
    dev = ln.o.device
    B = ln.pid.shape[0]
    f32, i64, b8 = torch.float32, torch.int64, torch.bool
    flat = fin is not None
    regs = {"o": (f32, (B, 3)), "d": (f32, (B, 3)), "tp": (f32, (B, 3)),
            "col": (f32, (B, 3)), "absorb": (f32, (B, 3)), "alive": (b8, (B,)),
            "hdb": (b8, (B,)), "bounce": (i64, (B,)), "pid": (i64, (B,)),
            "rid": (i64, (B,)), "k_lane": (i64, (B,)), "issued": (i64, ())}
    if flat:
        regs.update(tr_o=(f32, (B, 3)), tr_d=(f32, (B, 3)), shadow=(b8, (B,)),
                    need_scan=(b8, (B,)))
    out = {name: _register(ln, name, dt, shape) for name, (dt, shape) in regs.items()}
    # each lane reads all of its row before it writes it, so an input may
    # share memory with a register, but no two registers may
    ptrs = [x.data_ptr() for x in out.values()]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError("fused_regen: two registers share memory")
    keep = []   # converted inputs live until the launch is queued

    def inp(x, dtype, shape, name):
        x = _input(x, dtype, shape, name)
        keep.append(x)
        return x.data_ptr()

    HW = q.acc.shape[0] - 1
    if q.acc.dtype != f32 or not q.acc.is_contiguous() or q.cnt.dtype != torch.int32 \
            or not q.cnt.is_contiguous():
        raise ValueError("fused_regen: the frame must be contiguous float32 sums and "
                         "int32 counts")
    if was is None and not flat:
        raise ValueError("fused_regen: render_queue's route needs was")
    if flat:
        fins = [inp(getattr(fin, k), b8, (B,), k)
                for k in ("resolve", "shade", "pend", "cont_prev", "cont_shade")]
        fins += [inp(fin.o_sh, f32, (B, 3), "o_sh"), inp(fin.d_sh, f32, (B, 3), "d_sh")]
        was_p = None
    else:
        fins = [None] * 7
        was_p = inp(was, b8, (B,), "was")
    # the loop's own scratch: its launches follow each other on one stream
    if q.scratch is None or q.scratch.device != dev or q.scratch.numel() < 1 + -(-B // TILE):
        raise ValueError("fused_regen: the queue was not set up on the lanes' card "
                         "(regen.start)")
    pixq = _input(q.pixq_pad, i64, (q.S + B,), "pixq_pad")
    W, H = np.float32(q.width), np.float32(q.height)
    args = _Args(
        pixq.data_ptr(), q.acc.data_ptr(), q.cnt.data_ptr(), inp(q.cam, f32, (7,), "cam"),
        was_p, *fins,
        *(out[k].data_ptr() for k in ("o", "d", "tp", "col", "absorb", "alive", "hdb",
                                      "bounce", "pid", "rid", "k_lane", "issued")),
        *((out[k].data_ptr() for k in ("tr_o", "tr_d", "shadow", "need_scan")) if flat
          else [None] * 4),
        q.scratch[1:].data_ptr(), q.scratch.data_ptr(),
        q.S, q.K, HW, int(q.rid_base), B, q.width, q.settings.max_bounces, int(flat), TILE,
        int(q.seed) & _M32,
        float(np.float32(1.0) / W), float(np.float32(1.0) / H), float(W / H),
        q.settings.screen_z)
    rc = lib.wpt_regen(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"fused_regen: CUDA error {rc} at launch")
