"""Render configuration (the fields of ``wasm_pathtracer_tpu.config`` that
the port reads).

The JAX package's ``config`` module is itself free of JAX, but the port
must run where no file of the JAX package is importable, so it carries
its own copy.  Names, defaults and enum values are the JAX package's,
so the same settings describe the same render in both packages.

The JAX package's ``early_exit`` is left out.  It chooses between a
``while_loop`` that ends once every path is dead and a ``scan`` that
reverse-mode differentiation needs.  The port's lockstep loop
(``ops.integrator.trace_paths``) breaks on the host when no path is
alive; a Python loop with ``break`` is reverse-differentiable in
PyTorch, and the bounces it skips add nothing, so one form serves both.
"""

from __future__ import annotations

import dataclasses
import enum


class RenderType(enum.IntEnum):
    """Estimator selection (values match the JAX package's)."""

    NO_NEE = 0      # brute-force path tracing, light found by BSDF sampling
    NORMAL_NEE = 1  # next-event estimation with uniform light selection
    PNEE = 2        # photon-guided NEE (grid CDF light selection)


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static configuration for a render instance."""

    render_type: RenderType = RenderType.NORMAL_NEE
    # bounce cap of a path (Russian roulette ends most paths earlier)
    max_bounces: int = 16
    # epsilon bias for shadow/bounce ray origins
    epsilon: float = 2e-4
    # recompute each bounce in the backward pass (torch.utils.checkpoint)
    # instead of keeping its intermediates: about twice the bounce work
    # for memory that no longer grows with max_bounces
    checkpoint_bounces: bool = True
    # Russian roulette keep-chance clamp
    rr_clamp_min: float = 0.1
    rr_clamp_max: float = 0.9
    # edge-aware NEE gradients (ops.edges.nee_warp): a value-preserving
    # warp of the light-sample uniforms, so light-geometry gradients
    # carry the shadow boundary's flux; each NEE sample adds
    # edge_nee_aux clearance probes of the occluders within
    # edge_nee_radius in uniform space.  A gradient switch: the forward
    # drivers (render_queue, the flat wavefront) refuse it
    edge_aware_nee: bool = False
    edge_nee_aux: int = 6
    edge_nee_radius: float = 0.12
    # photon preprocess budget of a PNEE instance, and how many photons
    # one compute tick buys
    total_photons: int = 300_000
    photons_per_tick: int = 32
    # cells per axis of the photon grid
    photon_grid_res: int = 32
    # the grid spans the scene's padded finite AABB, or with
    # photon_grid_fit_scene off the fixed +-photon_world_size box
    photon_world_size: float = 1024.0
    photon_grid_fit_scene: bool = True
    # variance-guided pixel allocation; the first rounds are a uniform
    # sweep until every pixel has adaptive_bootstrap_spp samples, then
    # each pixel's weight is ceil(1 + scaled_error * adaptive_spp_scale)
    adaptive: bool = False
    adaptive_bootstrap_spp: int = 4
    adaptive_spp_scale: float = 32.0
    # virtual screen plane at z = +0.8 in camera space
    screen_z: float = 0.8
    # paths per session step (the session's pixel queue length)
    ray_batch_size: int = 32768
    # wavefront width of render_queue; the session caps it at
    # max(1024, ray_batch_size // 4), as the JAX session does
    regen_lanes: int = 16384
    # binned-SAH bins of the BVH build that orders the cluster structure
    bvh_num_bins: int = 16
    # a finite primitive family joins the cluster structure from this
    # many shapes on; smaller families stay in the dense scene kernels
    bvh_min_triangles: int = 512
    # flattened cluster traversal (ops.wavefront.render_queue_flat);
    # None = auto: whenever the scene has a cluster structure
    use_flat_wavefront: bool | None = None
    # light-selection debug render: NEE adds the sampled light's
    # unshadowed, unweighted intensity
    is_debug_photons: bool = False

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)

    @property
    def has_nee(self) -> bool:
        return self.render_type in (RenderType.NORMAL_NEE, RenderType.PNEE)
