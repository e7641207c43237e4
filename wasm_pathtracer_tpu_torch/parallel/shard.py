"""Pixel-partition rendering and training over a ``torch.distributed``
group (``wasm_pathtracer_tpu.parallel.shard``).

The JAX version runs one program over a 1-D device mesh (axis ``rays``)
under ``shard_map``.  Here each rank is a process with one device, and
the ranks are joined by a process group: NCCL for CUDA tensors, gloo for
CPU tensors.  The scene, its prep and any photon grid are replicated:
every rank builds the same ones from the same inputs, and nothing is
broadcast.  Each rank traces a contiguous shard of the queue or of the
pixels.  A path's random stream is keyed by its global queue index (or
its pixel id), so every path's radiance is the same whatever the number
of ranks; only the order in which a pixel's samples are summed may
change.  The only collectives are the sums of the frame sums and of the
gradients, called after the render or after ``torch.autograd.grad``,
outside autograd.

Without an initialised process group a mesh has one member and makes no
collective: a sum over one member is the identity.

In the train step, which shape a ray hits and whether a shadow ray is
occluded are constants of the gradient (``ops.integrator``); the kernels
decide them on detached rays and tables.  The tables are gathered from
the shape table (``trace.refresh_tables``), so a step that moves a light
has them gathered anew before the next render; a prep whose tables
cannot follow (a BVH, lights baked into a cluster structure) or whose
trace is not differentiable is refused, with the JAX package's messages.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch
import torch.distributed as dist

from wasm_pathtracer_tpu_torch.config import RenderSettings
from wasm_pathtracer_tpu_torch.models.camera import Camera
from wasm_pathtracer_tpu_torch.ops import integrator, trace, wavefront
from wasm_pathtracer_tpu_torch.utils.device import resolve_device
from wasm_pathtracer_tpu_torch.utils.spans import span

_M32 = 0xFFFFFFFF
# seed offset of the k-th sample of an image or a train step (the JAX
# version's)
_SEED_STRIDE = 0x9E3779B9
# the backend a collective on a tensor of each device type needs
_BACKEND_OF = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """The ``rays`` axis as this process sees it.

    ``group`` is the ``ProcessGroup`` the collectives run over, or None
    for the one-member mesh; ``size`` is its member count (the JAX mesh's
    ``devices.size``), ``rank`` this process's index in it, and
    ``device`` the device this rank renders on.
    """

    group: object
    rank: int
    size: int
    device: torch.device
    # host tally behind ``bytes_all_reduced``; a mesh is frozen, its count is not
    _tally: dict = dataclasses.field(default_factory=lambda: {"bytes": 0},
                                     compare=False, repr=False)

    @property
    def bytes_all_reduced(self) -> int:
        """Bytes this member has handed to all-reduces so far (a host
        count; the one-member mesh makes none)."""
        return self._tally["bytes"]

    def _check_backend(self, t: torch.Tensor):
        want = _BACKEND_OF.get(t.device.type)
        name = str(dist.get_backend(self.group))
        # a group made without a backend serves each device type by its
        # own, named as "cpu:gloo,cuda:nccl"
        have = dict(p.split(":") for p in name.split(",")).get(t.device.type) \
            if ":" in name else name
        if have != want:
            raise ValueError(f"a collective on {t.device.type} tensors needs a "
                             f"{want} group; this mesh's group is {name}")

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the members, in place; returns ``t``."""
        if self.group is not None:
            self._check_backend(t)
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
            self._tally["bytes"] += t.numel() * t.element_size()
        return t

    def all_gather(self, t: torch.Tensor) -> list:
        """Every member's ``t`` (one shape on all), in rank order."""
        if self.group is None:
            return [t]
        self._check_backend(t)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return parts


def _default_device() -> torch.device:
    resolve_device()
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None
                        else torch.cuda.current_device())


def make_ray_mesh(group=None, device=None) -> RayMesh:
    """The mesh of ``group`` (the default group if None), or the
    one-member mesh when ``torch.distributed`` is not initialised.

    ``device`` defaults to ``cuda:<LOCAL_RANK>`` (without ``LOCAL_RANK``
    the current CUDA device, 0 unless :func:`distributed.initialize` set
    it) and raises without a card; pass ``"cpu"`` to render on the CPU
    over gloo.
    """
    dev = _default_device() if device is None else resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        if group is not None:
            raise ValueError("a process group needs torch.distributed initialised")
        return RayMesh(None, 0, 1, dev)
    group = dist.group.WORLD if group is None else group
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not a member of the group")
    return RayMesh(group, rank, dist.get_world_size(group), dev)


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _pixel_shard(mesh: RayMesh, width: int, height: int):
    """(px, py, pix) of this rank's contiguous shard of the pixels, padded
    to a multiple of ``8 * size``; the pad rows (pix >= width * height)
    trace the last pixel again."""
    shard = _pad_to(width * height, mesh.size * 8) // mesh.size
    pix = torch.arange(mesh.rank * shard, (mesh.rank + 1) * shard, device=mesh.device)
    return (torch.clamp(pix % width, max=width - 1),
            torch.clamp(pix // width, max=height - 1), pix)


def _sample_seed(seed, k: int):
    return (seed + ((k * _SEED_STRIDE) & _M32)) & _M32


def render_image_sharded(mesh: RayMesh, prep: trace.ScenePrep, scene,
                         settings: RenderSettings, camera: Camera,
                         width: int, height: int, seed, spp: int = 1):
    """A full frame, (height, width, 3), with the pixels sharded over the
    mesh: each rank renders its shard ``spp`` times and the shards are
    gathered to every rank.  Per-pixel streams do not depend on the rank
    count, so the frame does not either."""
    px, py, _ = _pixel_shard(mesh, width, height)
    acc = torch.zeros((px.shape[0], 3), dtype=torch.float32, device=mesh.device)
    for s in range(spp):
        col, _ = integrator.render_pixels(prep, scene, settings, camera, px, py,
                                          width, height, _sample_seed(seed, s))
        acc = acc + col
    acc = acc / spp
    img = torch.cat(mesh.all_gather(acc))
    return img[:width * height].reshape(height, width, 3)


def _queue_sharded(renderer, mesh: RayMesh, prep: trace.ScenePrep, scene,
                   settings: RenderSettings, camera: Camera, pix_queue,
                   width: int, height: int, seed, lanes_per_device: int,
                   rid_base: int, photon_grid=None, exact_lanes: bool = False,
                   iters_out=None):
    """Each rank runs ``renderer`` over its contiguous shard of the queue;
    the frame sums, counts and cost are summed over the mesh, inside one
    ``shard.all_reduce`` span (args: the bytes summed, the ranks).

    The queue is padded to a multiple of the member count with the pixel
    id ``width * height``, which the loops drop.  Path ``i`` of rank
    ``r``'s shard is keyed by ``rid_base + r * shard + i``, its global
    queue index.
    """
    HW = width * height
    S = pix_queue.shape[0]
    pixq = pix_queue.to(device=mesh.device, dtype=torch.int64)
    pad = _pad_to(max(S, 1), mesh.size) - S
    pixq = torch.cat([pixq, torch.full((pad,), HW, dtype=torch.int64,
                                       device=mesh.device)])
    shard = pixq.shape[0] // mesh.size
    # the JAX version's one-sided clamp: an iteration costs about the full
    # lane width whatever the live lanes, so a shard narrower than the
    # lanes would pay its drain tail at every rank count
    lanes = lanes_per_device if exact_lanes else min(lanes_per_device,
                                                     max(1024, shard // 32))
    acc, cnt, lane_cost = renderer(
        prep, scene, settings, camera, pixq[mesh.rank * shard:(mesh.rank + 1) * shard],
        width, height, seed, lanes, photon_grid=photon_grid,
        rid_base=(rid_base + mesh.rank * shard) & _M32, iters_out=iters_out)
    cost = lane_cost.to(torch.float32).sum().reshape(1)
    summed = (acc, cnt, cost)
    with span("shard.all_reduce", {"bytes": sum(t.numel() * t.element_size()
                                                 for t in summed),
                                   "ranks": mesh.size}):
        for t in summed:
            mesh.all_reduce(t)
    return acc, cnt, cost[0]


def render_queue_sharded(mesh: RayMesh, prep: trace.ScenePrep, scene,
                         settings: RenderSettings, camera: Camera,
                         pix_queue, width: int, height: int, seed,
                         lanes_per_device: int, rid_base: int = 0,
                         photon_grid=None, exact_lanes: bool = False,
                         iters_out=None):
    """``integrator.render_queue`` over the queue sharded on the mesh: the
    renderer of dense (non-clustered) scenes.

    ``lanes_per_device`` is clamped to a 32nd of the shard (at least
    1,024) unless ``exact_lanes``, with which a caller that sized its
    lanes to its shard (``runtime.session``) keeps them.  ``iters_out``:
    this rank's loop iterations are appended to it.

    Returns (color_sum (H*W, 3), n_samples (H*W,) int32, cost () float32),
    the same on every rank.
    """
    return _queue_sharded(integrator.render_queue, mesh, prep, scene, settings,
                          camera, pix_queue, width, height, seed, lanes_per_device,
                          rid_base, photon_grid, exact_lanes, iters_out)


def render_queue_flat_sharded(mesh: RayMesh, prep: trace.ScenePrep, scene,
                              settings: RenderSettings, camera: Camera,
                              pix_queue, width: int, height: int, seed,
                              lanes_per_device: int, rid_base: int = 0,
                              photon_grid=None, exact_lanes: bool = False,
                              iters_out=None):
    """``wavefront.render_queue_flat`` over the queue sharded on the mesh:
    the renderer of cluster scenes (meshes, clouds); needs
    ``prep.cluster``.  Arguments and returns as
    :func:`render_queue_sharded`."""
    return _queue_sharded(wavefront.render_queue_flat, mesh, prep, scene, settings,
                          camera, pix_queue, width, height, seed, lanes_per_device,
                          rid_base, photon_grid, exact_lanes, iters_out)


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

    def __init__(self, mesh, prep, settings, width, height, lr, spp, train_lights,
                 train_materials, train_camera, optimizer, photon_grid,
                 edge_aware_screen):
        self.mesh = mesh
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
        self._px, self._py, pix = _pixel_shard(mesh, width, height)
        self._valid = (pix < width * height).to(torch.float32)[:, None]
        self._rows = (mesh.rank * pix.shape[0], (mesh.rank + 1) * pix.shape[0])

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
        """This rank's share of the step's loss: summed over its pixels
        (pad rows masked) and channels, over the frame's pixel count, so
        the sum over the ranks is the loss and its gradient.  A plain
        squared error with one sample, the two-sample cross estimator with
        two or more (A and B averaged over the two halves of the samples;
        E[(A - t)(B - t)] is the squared bias, free of the estimator's
        variance)."""
        W, H = self.width, self.height
        lo, hi = self._rows
        t = target.reshape(-1, 3).to(self.mesh.device)
        t = torch.cat([t, t.new_zeros((max(hi - W * H, 0), 3))])[lo:hi]
        cols = []
        for k in range(self.spp):
            col, _ = self._render(prep, scene, self.settings, camera, self._px,
                                  self._py, W, H, _sample_seed(seed, k),
                                  photon_grid=self.photon_grid)
            cols.append(col)
        if self.spp >= 2:
            nA = self.spp // 2
            colA = sum(cols[:nA]) / nA
            colB = sum(cols[nA:]) / (self.spp - nA)
            err = (colA - t) * (colB - t)
        else:
            err = (cols[0] - t) ** 2
        return torch.sum(self._valid * err) * (1.0 / (W * H))

    def _all_reduce(self, tensors):
        """``tensors`` summed over the mesh, in one collective."""
        if self.mesh.group is None:
            return list(tensors)
        flat = self.mesh.all_reduce(torch.cat([x.reshape(-1) for x in tensors]))
        return [x.reshape(t.shape) for x, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]

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
        with span("train.forward"):
            sc, cam = self._with(scene.detach(), frozen_camera, leaves)
            loss = self._loss(prep, sc, cam, target, seed)
        names = list(leaves)
        with span("train.backward"):
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        # every rank applies the same update to the same summed gradients,
        # so the leaves stay equal across ranks without a broadcast
        *grads, loss = self._all_reduce(list(grads) + [loss.detach()])
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
        return loss, scene, camera


def make_train_step(mesh: RayMesh, prep: trace.ScenePrep, settings: RenderSettings,
                    width: int, height: int, lr: float = 0.05, spp: int = 1,
                    train_lights: bool = False, train_materials: bool = True,
                    train_camera: bool = True, optimizer=None, photon_grid=None,
                    edge_aware_screen: bool = False) -> Callable:
    """Build the inverse-rendering train step:
    ``(loss, scene, camera) = step(scene, camera, target, seed)`` for a
    (height, width, 3) ``target`` and an integer ``seed``, with the pixels
    sharded over ``mesh`` (:func:`make_ray_mesh`).  Each rank renders its
    shard; the loss and the leaves' gradients are summed over the mesh and
    every rank applies the same update.

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
    ``ops.edges.render_pixels_edgeaware`` (needs a dense prep).  Every
    bounce up to ``max_bounces`` runs (``early_exit=False``, as in the
    JAX version), so a step reads nothing back before its backward.
    """
    _check_prep(prep, train_lights, train_camera, edge_aware_screen)
    settings = settings.replace(early_exit=False)
    return TrainStep(mesh, prep, settings, width, height, lr, spp, train_lights,
                     train_materials, train_camera, optimizer, photon_grid,
                     edge_aware_screen)
