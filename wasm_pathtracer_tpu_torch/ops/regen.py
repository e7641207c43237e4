"""Regeneration in the persistent wavefronts (``integrator.render_queue``,
``wavefront.render_queue_flat``): what a lane does when its path ends.

A path that ends adds its radiance to the frame, and its lane claims the
next queue slot while it has lane-ring capacity left, draws the new
path's in-pixel jitter and starts its primary ray.  The rule is the JAX
package's: finished lanes claim the next contiguous queue slots in lane
order (``cumsum`` ranks), at most ``K`` paths a lane, and path ``i``'s
random stream is keyed by ``ray_id = rid_base + i`` (its queue index),
so per-path radiance is a pure function of (queue, seed).

:func:`start` sets a loop up: the queue, the frame and the first rays.
:func:`regen` is one iteration's regeneration as eager PyTorch ops, for
both routes: the CPU form and the plain version of the regen kernel,
which the loops reach through ``regen_kernels.fused_regen``.
"""

from __future__ import annotations

import dataclasses

import torch

from wasm_pathtracer_tpu_torch.config import RenderSettings
from wasm_pathtracer_tpu_torch.models.camera import Camera, primary_rays
from wasm_pathtracer_tpu_torch.utils import rng as rnglib

# the RNG slot of a primary ray's pixel jitter
SLOT_JITTER = 0x7FFF0000


@dataclasses.dataclass(frozen=True)
class Queue:
    """What a loop's regeneration reads and never rebinds.  ``acc`` and
    ``cnt`` are the frame (row ``HW`` collects the lanes that finish
    nothing); ``pixq_pad`` is the queue padded with ``B`` entries of the
    drop sentinel ``HW``, which a claim past the end reads.  ``cam`` and
    ``scratch`` are the regen kernel's on the card, None elsewhere:
    :func:`camera_operand`, and zeros for the kernel's ticket counter and
    a status word for each tile of at least 32 lanes."""

    pixq_pad: torch.Tensor      # (S + B,) int64 pixel ids
    acc: torch.Tensor           # (HW + 1, 3) float32 colour sums
    cnt: torch.Tensor           # (HW + 1,) int32 sample counts
    S: int
    K: int                      # lane-ring capacity: paths a lane may finish
    width: int
    height: int
    seed: int
    rid_base: int
    settings: RenderSettings
    camera: Camera
    cam: torch.Tensor | None
    scratch: torch.Tensor | None


@dataclasses.dataclass
class Lanes:
    """The lanes' registers that regeneration reads or writes.  ``alive``
    is the flat route's ``live``; ``tr_o`` .. ``need_scan`` are that
    route's trace registers and stay None on ``render_queue``'s."""

    o: torch.Tensor             # (B, 3) float32 path ray
    d: torch.Tensor
    tp: torch.Tensor            # (B, 3) float32 throughput
    col: torch.Tensor           # (B, 3) float32 radiance
    alive: torch.Tensor         # (B,) bool
    hdb: torch.Tensor           # (B,) bool: had a diffuse bounce
    absorb: torch.Tensor        # (B, 3) float32 medium
    bounce: torch.Tensor        # (B,) int64
    pid: torch.Tensor           # (B,) int64 pixel of the path
    rid: torch.Tensor           # (B,) int64 ray id (RNG key)
    k_lane: torch.Tensor        # (B,) int64 paths the lane finished
    issued: torch.Tensor        # () int64 claim cursor
    tr_o: torch.Tensor | None = None
    tr_d: torch.Tensor | None = None
    shadow: torch.Tensor | None = None
    need_scan: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class Finalize:
    """The flat route's FINALIZE inputs (each (B,) bool but the rays):
    which lanes resolved a shadow query, shaded a primary hit or left a
    query pending, whether the path goes on after the resolved query
    (``cont_prev``) or after this shading (``cont_shade``), and the
    pending query's ray, ``(B, 3)`` each."""

    resolve: torch.Tensor
    shade: torch.Tensor
    pend: torch.Tensor
    cont_prev: torch.Tensor
    cont_shade: torch.Tensor
    o_sh: torch.Tensor
    d_sh: torch.Tensor


def camera_operand(camera: Camera, device) -> torch.Tensor:
    """(7,) float32 on ``device``: the camera's location, then the cosine
    and sine of ``rot_x`` and of ``rot_y``, by the ops ``vecmath.rot_x``
    and ``rot_y`` run, on the camera's own device, so that the regen
    kernel rotates by the float32 values the eager code does."""
    trig = torch.stack([torch.cos(camera.rot_x), torch.sin(camera.rot_x),
                        torch.cos(camera.rot_y), torch.sin(camera.rot_y)])
    return torch.cat([camera.location.reshape(3), trig]).to(device=device,
                                                            dtype=torch.float32)


def ray_of(q: Queue, pid, sidx):
    """Primary rays of queue entries ``sidx`` at pixels ``pid``:
    (ray id, o, d), the jitter drawn at ``SLOT_JITTER``."""
    rid = (q.rid_base + sidx) & 0xFFFFFFFF
    jx, jy, _ = rnglib.uniform3(q.seed, rid, SLOT_JITTER)
    o, d = primary_rays(q.camera, pid % q.width, pid // q.width, jx, jy,
                        q.width, q.height, q.settings.screen_z)
    return rid, o.contiguous(), d.contiguous()


def start(pix_queue, n_lanes: int, width: int, height: int, seed, rid_base,
          settings: RenderSettings, camera: Camera, acc, cnt):
    """``(Queue, Lanes)`` of a loop over the int64 queue ``pix_queue``
    (S >= 1) on ``n_lanes`` lanes: lane ``i < S`` starts queue entry
    ``i``, the others start dead."""
    dev = pix_queue.device
    S, B, HW = pix_queue.shape[0], n_lanes, width * height
    # lane-ring capacity of the JAX version: bounds how many paths one
    # lane may record, and so which lanes may claim
    K = -(-S // B)
    K += max(2, K // 2)
    pixq_pad = torch.cat([pix_queue, torch.full((B,), HW, dtype=torch.int64, device=dev)])
    cam = scratch = None
    if dev.type == "cuda":
        cam = camera_operand(camera, dev)
        scratch = torch.zeros((1 + -(-B // 32),), dtype=torch.int64, device=dev)
    q = Queue(pixq_pad, acc, cnt, S, K, width, height, seed, rid_base, settings, camera, cam,
              scratch)
    lanes = torch.arange(B, dtype=torch.int64, device=dev)
    pid = pix_queue[torch.clamp(lanes, max=S - 1)]
    rid, o, d = ray_of(q, pid, lanes)
    f32 = torch.float32
    ln = Lanes(o=o, d=d, tp=torch.ones((B, 3), dtype=f32, device=dev),
               col=torch.zeros((B, 3), dtype=f32, device=dev), alive=lanes < S,
               hdb=torch.zeros((B,), dtype=torch.bool, device=dev),
               absorb=torch.zeros((B, 3), dtype=f32, device=dev),
               bounce=torch.zeros((B,), dtype=torch.int64, device=dev), pid=pid, rid=rid,
               k_lane=torch.zeros((B,), dtype=torch.int64, device=dev),
               issued=torch.tensor(min(B, S), dtype=torch.int64, device=dev))
    return q, ln


def regen(q: Queue, ln: Lanes, was=None, fin: Finalize | None = None):
    """One iteration's regeneration as eager ops, rebinding ``ln``'s fields.

    On ``render_queue``'s route (``fin`` None) a path is done when its lane
    was alive before this bounce (``was``) and died in it or reached the
    bounce cap.  On the flat route the bounce is complete when its shadow
    query resolved or it left none, and the path ends unless it goes on
    (``fin``); the next traced ray is then the pending shadow query, else
    a new primary ray, else the path's next bounce.

    Ended paths add to the frame; ended lanes with capacity left claim
    the next queue slots in lane order and adopt a fresh path there.
    """
    S, B, HW = q.S, ln.pid.shape[0], q.acc.shape[0] - 1
    if fin is None:
        # a path is done when it died this step or hit the bounce cap
        end = was & (~ln.alive | (ln.bounce >= q.settings.max_bounces))
        ln.alive = ln.alive & ~end
    else:
        # FINALIZE: the bounce is complete (shadow resolved or none)
        done = fin.resolve | (fin.shade & ~fin.pend)
        cont = done & torch.where(ln.shadow, fin.cont_prev, fin.cont_shade)
        end = done & ~cont

    # add finished paths to the frame
    dst = torch.where(end, ln.pid, HW)
    q.acc.index_add_(0, dst, ln.col)
    q.cnt.index_add_(0, dst, end.to(torch.int32))
    ln.k_lane = ln.k_lane + end

    # regenerate: finished lanes with capacity left claim the next queue
    # slots in lane order
    claimable = end & (ln.k_lane < q.K)
    ranks = torch.cumsum(claimable, 0) - 1
    sidx = ln.issued + ranks
    can = claimable & (sidx < S)
    # the JAX version's dynamic slice of B entries at the claim cursor,
    # then a rank-indexed pick, as one gather
    pick = torch.clamp(ln.issued, max=S) + torch.clamp(ranks, 0, B - 1)
    pid_n = torch.clamp(q.pixq_pad[pick], max=HW)
    rid_n, o_n, d_n = ray_of(q, pid_n, sidx)
    ln.issued = torch.clamp(ln.issued + ranks[-1] + 1, max=S)

    can3 = can[:, None]
    if fin is not None:
        # next traced ray: shadow query > new primary > next bounce
        pend3, cont3 = fin.pend[:, None], cont[:, None]
        ln.tr_o = torch.where(pend3, fin.o_sh, torch.where(
            can3, o_n, torch.where(cont3, ln.o, ln.tr_o))).contiguous()
        ln.tr_d = torch.where(pend3, fin.d_sh, torch.where(
            can3, d_n, torch.where(cont3, ln.d, ln.tr_d))).contiguous()
        start_ = fin.pend | can | cont
        ln.shadow = torch.where(start_, fin.pend, ln.shadow)
        ln.need_scan = start_
        ln.alive = (ln.alive & ~end) | can
    else:
        ln.alive = ln.alive | can
    ln.o = torch.where(can3, o_n, ln.o)
    ln.d = torch.where(can3, d_n, ln.d)
    ln.tp = torch.where(can3, 1.0, ln.tp)
    ln.col = torch.where(can3, 0.0, ln.col)
    ln.hdb = ln.hdb & ~can
    ln.absorb = torch.where(can3, 0.0, ln.absorb)
    ln.bounce = torch.where(can, 0, ln.bounce)
    ln.pid = torch.where(can, pid_n, ln.pid)
    ln.rid = torch.where(can, rid_n, ln.rid)
