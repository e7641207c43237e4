"""The inverse-rendering train step (``wasm_pathtracer_tpu.parallel.shard.make_train_step``).

Render the scene, compare with a target image, and descend on the
scene's material leaves, the camera pose and the area lights' geometry
rows.  One process on one device: the JAX version's ``mesh`` argument
and its ``psum`` of the gradients (the identity on one device) are left
out until the sharding slice brings a ``torch.distributed`` group.

Which shape a ray hits and whether a shadow ray is occluded are
constants of the gradient (``ops.integrator``); the kernels decide them
on detached rays and tables.  The tables are gathered from the shape
table (``trace.refresh_tables``), so a step that moves a light has them
gathered anew before the next render; a prep whose tables cannot follow
(a BVH, lights baked into a cluster structure) or whose trace is not
differentiable is refused, with the JAX package's messages.
"""

from __future__ import annotations

from typing import Callable

import torch

from wasm_pathtracer_tpu_torch.config import RenderSettings
from wasm_pathtracer_tpu_torch.models.camera import Camera
from wasm_pathtracer_tpu_torch.ops import integrator, trace

_M32 = 0xFFFFFFFF
# seed offset of the k-th sample of a step (the JAX version's)
_SEED_STRIDE = 0x9E3779B9


def _check_prep(prep: trace.ScenePrep, train_lights: bool, train_camera: bool,
                edge_aware_screen: bool):
    if edge_aware_screen and (prep.cluster is not None or prep.has_bvh
                              or prep.use_pallas):
        raise ValueError("edge_aware_screen=True requires the dense "
                         "differentiable trace path (no BVH/cluster/"
                         "fused/Pallas prep)")
    if train_lights and prep.has_bvh:
        # a BVH holds its own copy of the triangles: a moved light would
        # be traced where the BVH has it
        raise ValueError("train_lights=True requires a dense or "
                         "cluster ScenePrep (no attached BVH)")
    if train_lights and prep.cluster is not None \
            and prep.cluster.has_baked_lights:
        raise ValueError(
            "train_lights=True with a cluster prep requires the lights "
            "OUT of the baked tables — rebuild with "
            "bvh.attach_clusters(..., exclude_lights=True)")
    if train_camera and prep.cluster is not None:
        # cluster hits keep a detached distance (as in the JAX package,
        # whose cluster walk has no reverse-mode rule), so a pose
        # gradient would miss every cluster hit
        raise ValueError("train_camera=True requires a dense ScenePrep "
                         "(the cluster traversal while_loop is not "
                         "reverse-differentiable); pass "
                         "train_camera=False for mesh-scale light/"
                         "material training")
    if (train_camera or train_lights) and (prep.use_pallas or prep.has_bvh):
        # the dense triangle sweep (a Pallas kernel without a VJP in the
        # JAX package) and the BVH walk give their triangle hits a
        # detached distance, so geometry gradients would miss them
        raise ValueError("train_camera=True or train_lights=True requires "
                         "a prep whose triangles the scene kernels trace "
                         "(no use_pallas dense sweep, no BVH): neither is "
                         "differentiable")


class TrainStep:
    """``(loss, scene, camera) = step(scene, camera, target, seed)``:
    one descent step (see :func:`make_train_step`).

    ``optimizer`` is the optimizer built at the first step, if any.
    """

    def __init__(self, prep, settings, width, height, lr, spp, train_lights,
                 train_materials, train_camera, optimizer, photon_grid,
                 edge_aware_screen):
        self._prep = prep
        self.settings = settings
        self.width, self.height = width, height
        self.lr = lr
        self.spp = spp
        self.train_lights = train_lights
        self.train_materials = train_materials
        self.train_camera = train_camera
        self.photon_grid = photon_grid
        self._make_optimizer = optimizer
        self.optimizer = None
        self._params = None
        self._render = integrator.render_pixels
        if edge_aware_screen:
            from wasm_pathtracer_tpu_torch.ops import edges
            self._render = edges.render_pixels_edgeaware

    def _values(self, scene, camera) -> dict:
        """The descent leaves' current values, by name."""
        v = {}
        if self.train_materials:
            v["albedo"] = scene.albedo
            v["emission"] = scene.emission
        if self.train_lights:
            v["light_rows"] = scene.params[scene.light_shape.long()]
        if self.train_camera:
            v["location"] = camera.location
            v["rot_x"] = camera.rot_x
            v["rot_y"] = camera.rot_y
        return {k: x.detach() for k, x in v.items()}

    def _with(self, scene, camera, leaves):
        """``scene`` and ``camera`` with the given leaves put in."""
        if self.train_materials:
            scene = scene.with_materials(albedo=leaves["albedo"],
                                         emission=leaves["emission"])
        if self.train_lights:
            scene = scene.with_light_rows(leaves["light_rows"])
        if self.train_camera:
            camera = Camera(leaves["location"], leaves["rot_x"], leaves["rot_y"])
        return scene, camera

    def _loss(self, prep, scene, camera, target, seed):
        """The step's loss, summed over pixels and channels over the
        pixel count: a plain squared error with one sample, the
        two-sample cross estimator with two or more (A and B averaged
        over the two halves of the samples; E[(A - t)(B - t)] is the
        squared bias, free of the estimator's variance)."""
        W, H = self.width, self.height
        pix = torch.arange(W * H, device=scene.device)
        t = target.reshape(-1, 3).to(scene.device)
        cols = []
        for k in range(self.spp):
            col, _ = self._render(prep, scene, self.settings, camera, pix % W,
                                  pix // W, W, H,
                                  (seed + ((k * _SEED_STRIDE) & _M32)) & _M32,
                                  photon_grid=self.photon_grid)
            cols.append(col)
        if self.spp >= 2:
            nA = self.spp // 2
            colA = sum(cols[:nA]) / nA
            colB = sum(cols[nA:]) / (self.spp - nA)
            err = (colA - t) * (colB - t)
        else:
            err = (cols[0] - t) ** 2
        return torch.sum(err) * (1.0 / (W * H))

    def __call__(self, scene, camera, target, seed):
        prep = self._prep
        if self.train_lights:
            # the kernels trace the lights from the tables: gather them
            # from the scene this step renders
            prep = trace.refresh_tables(prep, scene)
        values = self._values(scene, camera)
        if self._make_optimizer is None:
            leaves = {k: x.clone().requires_grad_(True) for k, x in values.items()}
        else:
            if self.optimizer is None:
                self._params = {k: x.clone().requires_grad_(True)
                                for k, x in values.items()}
                self.optimizer = self._make_optimizer(list(self._params.values()))
            leaves = self._params
            with torch.no_grad():
                for k, x in values.items():
                    leaves[k].copy_(x)
        frozen_camera = Camera(camera.location.detach(), camera.rot_x.detach(),
                               camera.rot_y.detach())
        sc, cam = self._with(scene.detach(), frozen_camera, leaves)
        loss = self._loss(prep, sc, cam, target, seed)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        with torch.no_grad():
            if self._make_optimizer is None:
                new = {k: leaves[k] - self.lr * g for k, g in zip(names, grads)}
            else:
                for k, g in zip(names, grads):
                    leaves[k].grad = g
                self.optimizer.step()
                self.optimizer.zero_grad(set_to_none=True)
                new = {k: leaves[k].detach().clone() for k in names}
            if self.train_materials:
                new["albedo"] = torch.clamp(new["albedo"], 0.0, 1.0)
                new["emission"] = torch.clamp(new["emission"], min=0.0)
        scene, camera = self._with(scene.detach(), frozen_camera, new)
        return loss.detach(), scene, camera


def make_train_step(prep: trace.ScenePrep, settings: RenderSettings,
                    width: int, height: int, lr: float = 0.05, spp: int = 1,
                    train_lights: bool = False, train_materials: bool = True,
                    train_camera: bool = True, optimizer=None, photon_grid=None,
                    edge_aware_screen: bool = False) -> Callable:
    """Build the inverse-rendering train step:
    ``(loss, scene, camera) = step(scene, camera, target, seed)`` for a
    (height, width, 3) ``target`` and an integer ``seed``.

    ``train_materials`` / ``train_camera`` / ``train_lights`` select the
    descent leaves: albedo and emission, the camera's location and
    rotations, the area lights' (L, 9) geometry rows.  After the update
    albedo is clamped to [0, 1] and emission to >= 0.  With ``spp >= 2``
    the loss is the two-sample cross estimator (``TrainStep._loss``).

    ``optimizer``: None for plain SGD at ``lr``, or a factory
    ``params -> torch.optim.Optimizer`` called once, at the first step,
    with the leaf tensors; the step keeps the optimizer and its state
    (the JAX version threads an optax state through the call instead).

    ``photon_grid`` trains under PNEE (its selection pdf is detached);
    ``edge_aware_screen`` renders through
    ``ops.edges.render_pixels_edgeaware`` (needs a dense prep).
    """
    _check_prep(prep, train_lights, train_camera, edge_aware_screen)
    return TrainStep(prep, settings, width, height, lr, spp, train_lights,
                     train_materials, train_camera, optimizer, photon_grid,
                     edge_aware_screen)
