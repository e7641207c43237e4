"""The session cells' reference: what a session's halves should have
produced in a frame, worked out again from the run's inputs.

A session (the port's ``runtime/session.py``) splits the viewport into a
left and a right half, each with its own estimator.  Each frame traces
one batch a half: a round seed folded from the session seed and the
half's round, pixels picked uniformly or by the variance-guided
allocator, then one path per pick, through the regenerating queue (path
``i`` keyed by ``rid_base + i``) or the per-pixel route (a path keyed by
its pixel).  A PNEE half first spends rounds on photons, so its render
rounds start after its emission rounds.

What the reference takes from the program: the inputs of the run (the
session seed, the configuration) and, for an adaptive half past its
bootstrap, the buffer and sweep position that the pick reads, which
carry every earlier frame; the accumulation of one frame into that
buffer is checked by itself (:func:`accumulation_gap`), and so is the
sweep position (:func:`sweep_gap`).  It works out again the photon grid,
every pick, and the radiance of a sample of the paths.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import adaptive as ad
from portbench.reference import integrator as itg
from portbench.reference import photon as ph
from portbench.reference import rng as rnglib
from portbench.reference.camera import initial_camera
from portbench.reference.precision import QUANT, quantize_scene
from portbench.reference.scene import build_scene

RID_RIGHT = 0x40000000
EMIT_ROUND0 = 0x50000000


def fold_seed(seed: int, round_: int) -> int:
    x, _, _ = rnglib._pcg3d(int(seed) & 0xFFFFFFFF, int(round_) & 0xFFFFFFFF, 0x9E3779B9)
    return x


@dataclasses.dataclass
class Half:
    x0: int
    width: int
    height: int
    settings: dict      # render_type, adaptive, max_bounces, ...
    rid_base: int
    grid: ph.PhotonGrid | None = None
    emit_rounds: int = 0


def half_layout(config: dict) -> list:
    """(x0, width, key, rid_base) of the left and the right half."""
    lw = config["width"] // 2
    return [(0, lw, "left", 0), (lw, config["width"] - lw, "right", RID_RIGHT)]


def in_bootstrap(settings: dict, width: int, height: int, batch_index: int) -> bool:
    """Whether a half's ``batch_index``-th render batch is one of its
    adaptive bootstrap's uniform sweeps."""
    traced = batch_index * settings["ray_batch_size"]
    return traced / max(width * height, 1) < settings["adaptive_bootstrap_spp"]


class SessionReference:
    """The reference of one session configuration, in ``precision``."""

    def __init__(self, config: dict, session_seed: int, device, precision: str = "float32"):
        self.quant = QUANT[precision]
        self.W, self.H = config["width"], config["height"]
        self.seed = session_seed
        self.device = device
        self.scene = quantize_scene(build_scene(config["scene_id"], device), self.quant)
        self.camera = initial_camera(config["scene_id"], device)
        self.halves = []
        for x0, w, key, rid in half_layout(config):
            st = dict(config["settings"], **config[key])
            self.halves.append(Half(x0, w, self.H, st, rid))
        for h in self.halves:
            if h.settings["render_type"] == 2:
                self._emit(h)

    def _emit(self, h: Half):
        st = h.settings
        grid = ph.create(self.scene, st["photon_grid_res"])
        r = 0
        while grid.num_photons < st["total_photons"]:
            ph.emit_photons(grid, self.scene, st["epsilon"],
                            fold_seed(self.seed, EMIT_ROUND0 + r), st["ray_batch_size"],
                            self.quant)
            r += 1
        h.grid, h.emit_rounds = grid, r

    def round_seed(self, half: int, batch_index: int) -> int:
        """The seed of a half's ``batch_index``-th render batch."""
        return fold_seed(self.seed, self.halves[half].emit_rounds + batch_index)

    def bootstrap(self, half: int, batch_index: int) -> bool:
        h = self.halves[half]
        return in_bootstrap(h.settings, h.width, h.height, batch_index)

    def sweep_start(self, half: int, batch_index: int) -> int:
        """The sweep position a bootstrap batch starts from."""
        h = self.halves[half]
        return (batch_index * h.settings["ray_batch_size"]) % (h.width * h.height)

    def picks(self, half: int, batch_index: int, pick_state=None):
        """(px, py, the sweep position after the pick) of the batch (the
        position is None for uniform picks).  An adaptive half past its
        bootstrap reads ``pick_state`` = (acc, count, sweep_pos), the
        program's buffer and sweep position when it picked."""
        h = self.halves[half]
        st = h.settings
        batch, seed = st["ray_batch_size"], self.round_seed(half, batch_index)
        if not st["adaptive"]:
            return (*ad.random_pixels(batch, seed, h.x0, 0, h.width, h.height, self.device),
                    None)
        boot = self.bootstrap(half, batch_index)
        if boot:
            acc = torch.zeros((self.H, self.W, 3), device=self.device)
            count = torch.zeros((self.H, self.W), device=self.device)
            sweep = self.sweep_start(half, batch_index)
        else:
            acc, count, sweep = pick_state
        return ad.pick_pixels(acc, count, batch, seed, boot, st["adaptive_spp_scale"],
                              h.x0, 0, h.width, h.height, sweep)

    def queue_radiance(self, half: int, batch_index: int, pix, qidx):
        """Radiance of the regenerating queue's paths ``qidx`` (pixel ids
        ``pix[qidx]``)."""
        h = self.halves[half]
        return itg.queue_paths(self.scene, h.settings, self.camera, pix[qidx], qidx,
                               self.W, self.H, self.round_seed(half, batch_index),
                               h.rid_base, h.grid, self.quant)

    def pixel_radiance(self, half: int, batch_index: int, px, py):
        """One per-pixel-route sample for each pixel (px, py)."""
        h = self.halves[half]
        return itg.render_pixels(self.scene, h.settings, self.camera, px, py, self.W,
                                 self.H, self.round_seed(half, batch_index), h.grid,
                                 self.quant)


def sweep_gap(ref: SessionReference, half: int, chain: list) -> int:
    """Steps of an adaptive half's sweep that break its rule, over the
    window's picks ``chain`` = [(batch index, position read, position
    returned)] in order.  The position a pick reads is the one the last
    pick returned; a bootstrap pick reads and returns the position that
    the batch count gives; a later pick advances it by its sweep slots,
    at least 1 and at most a batch (exactly: at the checked pick, by
    :meth:`SessionReference.picks`).  So the first position past the
    bootstrap follows from the batch count too."""
    h = ref.halves[half]
    batch, hw = h.settings["ray_batch_size"], h.width * h.height
    bad = 0
    for k, (b, pos, new) in enumerate(chain):
        if k and (b != chain[k - 1][0] + 1 or pos != chain[k - 1][2]):
            bad += 1
        if ref.bootstrap(half, b):
            bad += int(pos != ref.sweep_start(half, b) or new != (pos + batch) % hw)
        elif not 1 <= (new - pos) % hw <= batch:
            bad += 1
    return bad


def sample_queue(pix, n: int, gen: torch.Generator):
    """(queue indices, pixel ids) of every path whose pixel is one of
    those of ``n`` queue entries drawn with ``gen``."""
    q = torch.randperm(pix.shape[0], generator=gen)[:n].to(pix.device)
    px_set = torch.unique(pix[q])
    qidx = torch.nonzero(torch.isin(pix, px_set)).squeeze(1)
    return qidx, px_set


def mismatch(prog, ref, rtol: float, atol: float):
    """(R,) bool: rows whose largest channel gap exceeds
    ``atol + rtol * max |ref|``."""
    gap = (prog - ref).abs().amax(-1)
    return ~(gap <= atol + rtol * ref.abs().amax(-1))


def bins_gap(prog_bins, ref_bins) -> float:
    """Relative L1 gap of two photon histograms, over the deposited mass
    of the reference's (bins start at 1)."""
    return float((prog_bins - ref_bins).abs().sum() / torch.clamp((ref_bins - 1).abs().sum(),
                                                                   min=1e-12))


def accumulation_gap(before, sums, after, rtol: float = 1e-5):
    """Pixels of ``after`` (acc (H, W, 3), count (H, W)) that are not
    ``before`` plus the frame's ``sums`` [(acc (H*W, 3), count (H*W,))]
    within ``rtol`` of their magnitude (counts exactly)."""
    acc, cnt = before[0].clone(), before[1].clone()
    H, W = cnt.shape
    for a, c in sums:
        acc += a.reshape(H, W, 3)
        cnt += c.reshape(H, W).to(cnt.dtype)
    bad_acc = ((after[0] - acc).abs() > rtol * torch.clamp(after[0].abs(), min=1.0)).any(-1)
    return int((bad_acc | (after[1] != cnt)).sum())


def readout_gap(after, frame_u8: np.ndarray) -> int:
    """Bytes of the program's frame that differ from the tone-mapped
    clamped mean of the buffer it was read from."""
    ref = ad.tonemap_u8(ad.clamped_image(*after).cpu().numpy())
    return int((ref != frame_u8).sum())
