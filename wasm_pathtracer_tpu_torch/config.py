"""Render configuration (``wasm_pathtracer_tpu.config``).

The JAX package's ``config`` module is itself free of JAX, but the port
must run where no file of the JAX package is importable, so it carries
its own copy.  Field names, their order, defaults and enum values are
the JAX package's, so the same settings describe the same render in
both packages.  ``use_bvh4`` and ``debug_view``, which nothing reads in
the JAX package either, take only their defaults: any other value raises
``ValueError`` rather than rendering the normal image without a word.
"""

from __future__ import annotations

import dataclasses
import enum


class RenderType(enum.IntEnum):
    """Estimator selection (values match the JAX package's)."""

    NO_NEE = 0      # brute-force path tracing, light found by BSDF sampling
    NORMAL_NEE = 1  # next-event estimation with uniform light selection
    PNEE = 2        # photon-guided NEE (grid CDF light selection)


class DebugView(enum.IntEnum):
    """False-colour debug outputs (values match the JAX package's)."""

    NONE = 0
    SAMPLING_DENSITY = 1
    PHOTON_LIGHTS = 2
    DEPTH = 3
    BVH_COST = 4


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static configuration for a render instance."""

    render_type: RenderType = RenderType.NORMAL_NEE
    # bounce cap of a path (Russian roulette ends most paths earlier)
    max_bounces: int = 16
    # the lockstep bounce loop (ops.integrator.trace_paths) stops once no
    # path of the batch is alive, a host read after every bounce; False
    # runs every bounce up to max_bounces without a read (a bounce with
    # no live path changes nothing).  The session's regenerating queue
    # needs it, as in the JAX package
    early_exit: bool = True
    # recompute each bounce in the backward pass (torch.utils.checkpoint)
    # instead of keeping its intermediates: about twice the bounce work
    # for memory that no longer grows with max_bounces
    checkpoint_bounces: bool = True
    # epsilon bias for shadow/bounce ray origins
    epsilon: float = 2e-4
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
    # binned-SAH bins of the BVH build that orders the cluster structure
    bvh_num_bins: int = 16
    # only the default: the port has one traversal
    use_bvh4: bool = True
    # a finite primitive family joins the cluster structure from this
    # many shapes on; smaller families stay in the dense scene kernels
    bvh_min_triangles: int = 512
    # paths per session step (the session's pixel queue length)
    ray_batch_size: int = 32768
    # the session renders a batch through the regenerating queue
    # (render_queue, or the flat wavefront on a cluster prep) when this
    # and early_exit are set, else one sample a picked pixel through
    # integrator.render_pixels
    use_regen: bool = True
    # wavefront width of render_queue; the session caps it at
    # max(1024, ray_batch_size // 4), as the JAX session does
    regen_lanes: int = 16384
    # flattened cluster traversal (ops.wavefront.render_queue_flat);
    # None = auto: whenever the scene has a cluster structure
    use_flat_wavefront: bool | None = None
    # only the default: the CLI renders the debug views (--debug-view,
    # --show-sampling)
    debug_view: DebugView = DebugView.NONE
    # light-selection debug render: NEE adds the sampled light's
    # unshadowed, unweighted intensity
    is_debug_photons: bool = False

    def __post_init__(self):
        if not self.use_bvh4:
            raise ValueError("use_bvh4=False is not ported: the port has one traversal")
        if self.debug_view != DebugView.NONE:
            raise ValueError(f"debug_view={self.debug_view!r} is not ported as a setting; "
                             "the CLI renders the debug views (--debug-view, --show-sampling)")

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)

    @property
    def has_nee(self) -> bool:
        return self.render_type in (RenderType.NORMAL_NEE, RenderType.PNEE)
