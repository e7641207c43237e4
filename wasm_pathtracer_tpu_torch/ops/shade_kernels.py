"""One kernel for a bounce's shading (``integrator._shade_core``).

:func:`fused_shade` launches ``wpt_shade_kernel`` (``csrc/shade_kernels.cu``),
which does all of ``_shade_core``'s forward work for one lane per thread
and writes the new carry ``(o, d, throughput, color, alive, hdb, absorb)``
and the pending NEE query (``need``, ``p_from``, ``p_to``, ``light_sid``,
``contrib``) in one pass.  Its rounding follows the eager chain op by op
and its pcg3d draws are bit-exact, so a path branches as under the eager
code on the card.

Its plain version is ``integrator._shade_eager``, the eager ops, which
stay the autograd path: :func:`takes_kernel`, the one place that
decides, says when ``_shade_core`` launches the kernel instead (CUDA
tensors, no edge-aware NEE, nothing to differentiate).  On CPU tensors
the wrapper runs the eager code.  The wrapper counts its launches in
``fused_shade.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType

_M32 = 0xFFFFFFFF

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class _Args(ctypes.Structure):
    """``ShadeArgs`` of ``csrc/shade_kernels.cu``, field for field."""

    _fields_ = [(name, _P) for name in (
        "rows", "atlas", "background", "lights", "cdf", "norm", "grid_lo", "grid_hi",
        "o", "d", "tp", "col", "absorb", "t", "alive", "hdb", "hit", "sid", "ray_id",
        "slot0", "o_out", "d_out", "tp_out", "col_out", "absorb_out", "p_from", "p_to",
        "contrib", "alive_out", "hdb_out", "need", "light_sid")] + [
        ("slot_base", ctypes.c_longlong)] + [(name, _I) for name in (
            "n", "n_tex", "tex_h", "tex_w", "n_lights", "grid_res", "grid_l", "nee",
            "debug_photons", "emis_once")] + [
        ("seed", ctypes.c_uint32)] + [(name, _F) for name in (
            "eps", "rr_min", "rr_max", "inv_light_chance")]


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def takes_kernel(settings: RenderSettings, operands) -> bool:
    """Whether ``_shade_core`` launches the kernel for a call with these
    ``operands`` (the call's float tensors: the rays, the carry, the hit
    distances and the scene's tables).  It does when they lie on the card,
    edge-aware NEE is off and no operand needs a gradient; the eager code
    runs otherwise."""
    if not _on_card(operands[0]) or settings.edge_aware_nee:
        return False
    return not (torch.is_grad_enabled() and any(x.requires_grad for x in operands))


def _ptr(x):
    return None if x is None else x.data_ptr()


def _lane(x, dtype, shape, name):
    if x.dtype != dtype:
        x = x.to(dtype)
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    return x.contiguous()


def _table(x, name):
    if x.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {x.dtype}, expected torch.float32")
    return x.contiguous()


def fused_shade(scene, settings: RenderSettings, light_tab, o, d, throughput, color,
                alive, hdb, absorb, slot0, ray_id, seed, t, sid, hit, packed_rows,
                photon_grid=None):
    """``integrator._shade_core`` in one launch, for a call that
    :func:`takes_kernel` gives it: same arguments (``slot0`` an integer or
    a per-lane integer tensor, ``seed`` a host integer, ``packed_rows``
    ``trace.pack_hit_rows(scene)``) and the same ``(carry', shadow_req)``.
    On CPU tensors it runs the eager code."""
    from wasm_pathtracer_tpu_torch.ops import integrator as itg
    if o.device.type == "cpu":
        return itg._shade_eager(scene, settings, light_tab, o, d, throughput, color, alive,
                                hdb, absorb, slot0, ray_id, seed, t, sid, hit,
                                packed_rows=packed_rows, photon_grid=photon_grid)
    if isinstance(seed, torch.Tensor):
        raise TypeError("fused_shade takes the seed as a host integer, not a tensor")
    from wasm_pathtracer_tpu_torch.ops import _build
    lib = _build.library()
    with torch.cuda.device(o.device):
        out = _launch(lib, torch.cuda.current_stream(o.device).cuda_stream, scene, settings,
                      light_tab, o, d, throughput, color, alive, hdb, absorb, slot0, ray_id,
                      seed, t, sid, hit, packed_rows, photon_grid)
    fused_shade.launches += 1
    return out


fused_shade.launches = 0


def _launch(lib, stream, scene, settings, light_tab, o, d, throughput, color, alive, hdb,
            absorb, slot0, ray_id, seed, t, sid, hit, packed_rows, photon_grid):
    """Check and lay out the operands, allocate the outputs and launch
    ``wpt_shade_kernel`` (through the C entry point ``wpt_shade`` of
    ``lib``) on ``stream``."""
    dev = o.device
    R = o.shape[0]
    f32 = torch.float32
    o = _lane(o, f32, (R, 3), "o")
    d = _lane(d, f32, (R, 3), "d")
    throughput = _lane(throughput, f32, (R, 3), "throughput")
    color = _lane(color, f32, (R, 3), "color")
    absorb = _lane(absorb, f32, (R, 3), "absorb")
    t = _lane(t, f32, (R,), "t")
    alive = _lane(alive, torch.bool, (R,), "alive")
    hdb = _lane(hdb, torch.bool, (R,), "hdb")
    hit = _lane(hit, torch.bool, (R,), "hit")
    sid = _lane(sid, torch.int64, (R,), "sid")
    ray_id = _lane(ray_id, torch.int64, (R,), "ray_id")
    if isinstance(slot0, torch.Tensor):
        slot0 = _lane(slot0, torch.int64, (R,), "slot0")
        slot_base = 0
    else:
        slot_base, slot0 = int(slot0), None
    rows = _table(packed_rows, "packed_rows")
    atlas = _table(scene.textures, "textures")
    background = _table(scene.background, "background")
    lpack, n_lights = light_tab
    lpack = _table(lpack, "light table")

    nee = 0
    if settings.has_nee and scene.num_lights > 0:
        nee = 2 if settings.render_type == RenderType.PNEE and photon_grid is not None else 1
    cdf = norm = lo = hi = None
    res = grid_l = 0
    if nee == 2:
        cdf, norm, _ = photon_grid.tables()
        cdf, norm = _table(cdf, "cdf"), _table(norm, "norm")
        lo, hi = _table(photon_grid.lo, "grid lo"), _table(photon_grid.hi, "grid hi")
        res, grid_l = int(photon_grid.res), int(cdf.shape[1])
    wants_req = nee != 0 and not settings.is_debug_photons

    out = torch.empty((8 if wants_req else 5, R, 3), dtype=f32, device=dev).unbind(0)
    flags = torch.empty((3 if wants_req else 2, R), dtype=torch.bool, device=dev).unbind(0)
    light_sid = torch.empty((R,), dtype=torch.int64, device=dev) if wants_req else None
    req = out[5:] if wants_req else (None, None, None)

    K, th, tw = (int(s) for s in atlas.shape[:3])
    args = _Args(
        rows.data_ptr(), atlas.data_ptr() if K else None, background.data_ptr(),
        lpack.data_ptr(), _ptr(cdf), _ptr(norm), _ptr(lo), _ptr(hi),
        o.data_ptr(), d.data_ptr(), throughput.data_ptr(), color.data_ptr(),
        absorb.data_ptr(), t.data_ptr(), alive.data_ptr(), hdb.data_ptr(), hit.data_ptr(),
        sid.data_ptr(), ray_id.data_ptr(), _ptr(slot0),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), out[3].data_ptr(),
        out[4].data_ptr(), _ptr(req[0]), _ptr(req[1]), _ptr(req[2]),
        flags[0].data_ptr(), flags[1].data_ptr(),
        flags[2].data_ptr() if wants_req else None, _ptr(light_sid),
        slot_base, R, K, th, tw, int(n_lights), res, grid_l, nee,
        int(settings.is_debug_photons), int(settings.is_debug_photons or settings.has_nee),
        int(seed) & _M32,
        settings.epsilon, settings.rr_clamp_min, settings.rr_clamp_max,
        _inv_scalar(max(1.0 / n_lights, 1e-12)))
    rc = lib.wpt_shade(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"fused_shade: CUDA error {rc} at launch")
    carry = (out[0], out[1], out[2], out[3], flags[0], flags[1], out[4])
    if not wants_req:
        return carry, None
    return carry, dict(need=flags[2], p_from=req[0], p_to=req[1], light_sid=light_sid,
                       contrib=req[2])


def _inv_scalar(x: float) -> float:
    """The factor by which ATen divides a float32 tensor by the host
    scalar ``x`` on the card: the float32 reciprocal of float32(x)."""
    return float(np.float32(1.0) / np.float32(x))

