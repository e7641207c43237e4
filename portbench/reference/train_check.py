"""The train cell's reference: the inverse-rendering steps of the port's
``parallel/shard.py::make_train_step`` (one member, plain SGD) worked out
again in plain PyTorch.

A step renders one sample a pixel of the whole frame, keyed by the
pixel, takes the loss ``sum((col - target)^2) / (W * H)``, its gradients
in the descent leaves (albedo, emission, camera location and rotations)
by autograd through the lockstep estimator, and applies ``leaf - lr *
grad``, then clamps albedo to [0, 1] and emission to >= 0.  The
reference renders the target, the perturbed start and each step from the
configuration and the seeds alone; it renders in blocks of pixels and
sums the blocks' losses and gradients.
"""

from __future__ import annotations

import torch

from portbench.reference import integrator as itg
from portbench.reference.camera import Camera, initial_camera
from portbench.reference.precision import QUANT, quantize_scene
from portbench.reference.scene import MatKind, build_scene

SEED_STRIDE = 0x9E3779B9


def sample_seed(seed: int, k: int) -> int:
    return (seed + ((k * SEED_STRIDE) & 0xFFFFFFFF)) & 0xFFFFFFFF


class TrainReference:
    def __init__(self, config: dict, traffic: dict, device, precision: str = "float32",
                 fault: str | None = None):
        """``fault`` plants one of the faults the check must catch:
        ``half_the_batch`` (the second half of the pixels left out, the
        mean taken over the rest) or ``answer_altered`` (the loss, and so
        its gradients, 5% high)."""
        self.fault = fault
        self.quant = QUANT[precision]
        self.W, self.H = config["width"], config["height"]
        self.device = device
        self.scene = quantize_scene(build_scene(config["scene_id"], device), self.quant)
        self.camera = initial_camera(config["scene_id"], device)
        self.settings = dict(config["settings"], render_type=traffic["render_type"],
                             max_bounces=traffic["max_bounces"])
        self.lr = traffic["lr"]
        if traffic["spp"] != 1:
            raise ValueError("the reference takes the one-sample squared error (spp 1)")
        self.block = traffic["reference_block_pixels"]
        self.shift = traffic["albedo_shift"]
        self.leaves = (("albedo", "emission") if traffic["train_materials"] else ()) + \
            (("location", "rot_x", "rot_y") if traffic["train_camera"] else ())

    def _pixels(self):
        pix = torch.arange(self.W * self.H, device=self.device)
        return pix % self.W, pix // self.W

    def target(self, seed: int, spp: int):
        """(H, W, 3) mean of ``spp`` samples a pixel of the true scene."""
        px, py = self._pixels()
        acc = torch.zeros((px.shape[0], 3), device=self.device)
        with torch.no_grad():
            for s in range(spp):
                for b in range(0, px.shape[0], self.block):
                    acc[b:b + self.block] += itg.render_pixels(
                        self.scene, self.settings, self.camera, px[b:b + self.block],
                        py[b:b + self.block], self.W, self.H, sample_seed(seed, s),
                        quant=self.quant)
        return (acc / spp).reshape(self.H, self.W, 3)

    def start(self) -> dict:
        """The descent's start: diffuse albedos shifted and clamped, and
        every leaf's value."""
        sc = self.scene
        diffuse = (sc.mat_kind == int(MatKind.DIFFUSE))[:, None]
        shift = torch.tensor([self.shift], dtype=torch.float32, device=self.device)
        return {"albedo": torch.clamp(sc.albedo + torch.where(diffuse, shift, 0.0), 0, 1),
                "emission": sc.emission.clone(),
                "location": self.camera.location.clone(),
                "rot_x": self.camera.rot_x.clone(), "rot_y": self.camera.rot_y.clone()}

    def _with(self, values: dict):
        """(scene, camera, leaves): the values put in, the descent
        leaves requiring grad."""
        lv = {k: v.detach().clone().requires_grad_(k in self.leaves)
              for k, v in values.items()}
        scene = self.scene.replace(albedo=lv["albedo"], emission=lv["emission"])
        return scene, Camera(lv["location"], lv["rot_x"], lv["rot_y"]), lv

    def loss_and_grads(self, leaves: dict, target, seed: int):
        """(loss, {leaf: gradient}) of one step's render."""
        px, py = self._pixels()
        t = target.reshape(-1, 3)
        scale = 1.0 / (self.W * self.H)
        if self.fault == "half_the_batch":
            px, py, scale = px[:px.shape[0] // 2], py[:py.shape[0] // 2], 2.0 * scale
        elif self.fault == "answer_altered":
            scale = 1.05 * scale
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        grads = {k: torch.zeros_like(leaves[k]) for k in self.leaves}
        for b in range(0, px.shape[0], self.block):
            scene, cam, lv = self._with(leaves)
            col = itg.render_pixels(scene, self.settings, cam, px[b:b + self.block],
                                    py[b:b + self.block], self.W, self.H, seed,
                                    quant=self.quant)
            loss = torch.sum((col - t[b:b + self.block]) ** 2) * scale
            g = torch.autograd.grad(loss, [lv[k] for k in self.leaves], allow_unused=True)
            for k, gk in zip(self.leaves, g):
                if gk is not None:
                    grads[k] += gk
            total += loss.detach().double()
        return float(total), grads

    def step(self, leaves: dict, target, seed: int):
        """(loss, new leaves) of one SGD step."""
        loss, g = self.loss_and_grads(leaves, target, seed)
        new = dict(leaves)
        new.update({k: leaves[k] - self.lr * g[k] for k in self.leaves})
        if "albedo" in self.leaves:
            new["albedo"] = torch.clamp(new["albedo"], 0.0, 1.0)
            new["emission"] = torch.clamp(new["emission"], min=0.0)
        return loss, {k: v.detach() for k, v in new.items()}


def norms(d: dict) -> dict:
    return {k: float(torch.linalg.norm(v.double().reshape(-1))) for k, v in d.items()}


def moved_leaves(ref_grad: dict, floor_share: float = 1e-3) -> list:
    """The leaves whose reference gradient norm is at least
    ``floor_share`` of the median leaf's: the others are nought to
    rounding, and only round-off moves them."""
    import statistics
    rn = norms(ref_grad)
    med = statistics.median(rn.values())
    return [k for k in rn if rn[k] >= floor_share * med]


def worst_leaf_gap(prog: dict, ref: dict, counted: list) -> float:
    """The largest gap, over the ``counted`` leaves, between the two
    sides' norms of a leaf, over the larger of the reference's norm of
    that leaf and of the median counted leaf."""
    import statistics
    rn, pn = norms(ref), norms(prog)
    med = statistics.median(rn[k] for k in counted)
    return max((abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in counted), default=0.0)
