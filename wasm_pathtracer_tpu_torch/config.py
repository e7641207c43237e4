"""Render configuration (the fields of ``wasm_pathtracer_tpu.config`` that
the port reads).

The JAX package's ``config`` module is itself free of JAX, but the port
must run where no file of the JAX package is importable, so it carries
its own copy.  Names, defaults and enum values are the JAX package's,
so the same settings describe the same render in both packages.  The
fields of paths not ported yet (photon NEE, adaptive sampling,
edge-aware NEE) are kept only so that asking for them raises
``NotImplementedError`` instead of rendering something else.
"""

from __future__ import annotations

import dataclasses
import enum


class RenderType(enum.IntEnum):
    """Estimator selection (values match the JAX package's)."""

    NO_NEE = 0      # brute-force path tracing, light found by BSDF sampling
    NORMAL_NEE = 1  # next-event estimation with uniform light selection
    PNEE = 2        # photon-guided NEE (not ported yet)


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static configuration for a render instance."""

    render_type: RenderType = RenderType.NORMAL_NEE
    # bounce cap of a path (Russian roulette ends most paths earlier)
    max_bounces: int = 16
    # epsilon bias for shadow/bounce ray origins
    epsilon: float = 2e-4
    # Russian roulette keep-chance clamp
    rr_clamp_min: float = 0.1
    rr_clamp_max: float = 0.9
    # not ported yet: asking for them raises
    edge_aware_nee: bool = False
    adaptive: bool = False
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

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)

    @property
    def has_nee(self) -> bool:
        return self.render_type in (RenderType.NORMAL_NEE, RenderType.PNEE)
