"""Scene tracing: nearest hit, shadow rays, hit shading info
(``wasm_pathtracer_tpu.ops.trace``).

The dense families of a scene go through the whole-scene kernels of
``ops.scene_kernels``: :func:`trace_scene` through the nearest-hit
kernel and :func:`shadow_ray` through the any-hit kernel.  A prep with a
cluster structure (``ops.bvh.attach_clusters``) merges the clusters'
nearest hit after the dense one (``ops.cluster.trace_clusters``), and
its shadow rays are nearest-hit traces plus the occlusion comparison.
The kernel wrappers take their plain PyTorch versions for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from wasm_pathtracer_tpu_torch.models.scene import PrimType, SceneData
from wasm_pathtracer_tpu_torch.ops import cluster as cl
from wasm_pathtracer_tpu_torch.ops import intersect as isx
from wasm_pathtracer_tpu_torch.ops import scene_kernels
from wasm_pathtracer_tpu_torch.utils import vecmath as vm


@dataclasses.dataclass(frozen=True)
class ScenePrep:
    """Per-scene index sets into the unified shape table, and the
    kernels' family tables gathered once from it.

    ``code_of`` maps a shape id to its kernel code (``fam << 20 | slot``);
    ``sid_of_slot[fam_offset[fam] + slot]`` maps a kernel (fam, slot)
    back to a shape id.  All are int64 except ``code_of`` (int32).
    ``cluster`` is the cluster structure over the shapes that left the
    index sets, or None.
    """

    idx_plane: torch.Tensor
    idx_sphere: torch.Tensor
    idx_triangle: torch.Tensor
    idx_torus: torch.Tensor
    idx_aarect: torch.Tensor
    idx_square: torch.Tensor
    code_of: torch.Tensor
    sid_of_slot: torch.Tensor
    fam_offset: torch.Tensor
    tables: scene_kernels.SceneTables
    cluster: cl.ClusterSet | None = None


# ScenePrep's index sets, in family (PrimType) order
INDEX_FIELDS = ("idx_plane", "idx_sphere", "idx_triangle", "idx_torus",
                "idx_aarect", "idx_square")


def prepare(scene: SceneData) -> ScenePrep:
    """Host-side split of the shape table into per-family index sets.
    Call it again after changing the scene: the tables are a copy."""
    ptype = scene.ptype.cpu().numpy()
    return prepare_from_sets(scene, [np.nonzero(ptype == int(t))[0]
                                     for t in PrimType])


def prepare_from_sets(scene: SceneData, index_sets, cluster=None) -> ScenePrep:
    """A prep whose dense families are the six given shape-id sets (in
    family order), with ``cluster`` attached."""
    dev = scene.device
    sets = [torch.as_tensor(np.asarray(s), dtype=torch.int64, device=dev)
            for s in index_sets]
    sizes = [int(s.shape[0]) for s in sets]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return ScenePrep(
        *sets,
        code_of=scene_kernels.shape_codes(sets, scene.num_shapes, dev),
        # one pad entry: a miss (fam -1, slot 0) then indexes safely even
        # in a scene without shapes
        sid_of_slot=torch.cat(sets + [torch.zeros(1, dtype=torch.int64,
                                                  device=dev)]),
        fam_offset=torch.as_tensor(offsets, dtype=torch.int64, device=dev),
        tables=scene_kernels.build_tables(sets, scene.params),
        cluster=cluster,
    )


def trace_scene(prep: ScenePrep, scene: SceneData, o, d):
    """Nearest hit for a ray batch.

    Returns ``(t, shape_id, hit_mask, cost)`` — ``cost`` counts
    primitive tests per ray.
    """
    t, sid, hit, cost = scene_kernels.trace_scene_fused(prep, scene, o, d)
    if prep.cluster is None:
        return t, sid, hit, cost
    t_cl, sid_cl, rounds = cl.trace_clusters(prep.cluster, o, d, t)
    better = sid_cl >= 0
    sid = torch.where(better, sid_cl, sid)
    hit = torch.isfinite(t_cl)
    return t_cl, sid, hit, cost + rounds * prep.cluster.group


def shadow_ray(prep: ScenePrep, scene: SceneData, p, point_on_light,
               light_sid, epsilon: float = isx.EPSILON):
    """Occlusion test; the target light shape itself does not occlude.
    Returns (occluded mask, cost).  Without clusters this is the any-hit
    kernel; with them, a nearest-hit trace and the comparison."""
    to_l = point_on_light - p
    dir_len = vm.length(to_l)
    d = to_l / dir_len[..., None]
    o = p + d * epsilon
    if prep.cluster is None:
        return scene_kernels.occluded_fused(prep, scene, o, d, dir_len, light_sid)
    t, sid, hit, cost = trace_scene(prep, scene, o, d)
    return hit & (t < dir_len) & (sid != light_sid), cost


# ---------------------------------------------------------------------------
# Hit shading info, evaluated only for the winning shape of each ray
# ---------------------------------------------------------------------------

def pack_hit_rows(scene: SceneData):
    """One (N, 24) f32 row per shape: params 0:9, albedo 9:12,
    emission 12:15, mat_extra 15:20, ptype 20, mat_kind 21, tex_id 22,
    pad 23 (int columns are exact in f32).  Loop callers build it once
    and pass it to :func:`hit_info`."""
    f32 = torch.float32
    return torch.cat(
        [scene.params, scene.albedo, scene.emission, scene.mat_extra,
         scene.ptype[:, None].to(f32),
         scene.mat_kind[:, None].to(f32),
         scene.tex_id[:, None].to(f32),
         torch.zeros((scene.params.shape[0], 1), dtype=f32,
                     device=scene.device)], dim=1)


def hit_info(scene: SceneData, o, d, t, sid, packed=None):
    """Normals, entering flags and material rows for hits.  Returns a
    dict with n, is_entering, kind, albedo, emission, extra."""
    if packed is None:
        packed = pack_hit_rows(scene)
    return hit_info_from_row(scene, o, d, t, packed[sid])


def hit_info_from_row(scene: SceneData, o, d, t, prow):
    """:func:`hit_info` on an already-resolved (R, 24) hit row."""
    rows = prow[:, 0:9]
    pt = prow[:, 20].to(torch.int32)             # (R,)

    n_pl, e_pl = isx.plane_normal(d, rows[:, 3:6])
    n_sp, e_sp = isx.sphere_normal(o, d, t, rows[:, 0:3], rows[:, 3])
    n_tr, e_tr = isx.triangle_normal(d, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])
    n_to, e_to = isx.torus_normal(o, d, t, rows[:, 0:3], rows[:, 3], rows[:, 4])
    n_aa, e_aa = isx.aarect_normal(o, d, t, rows[:, 0:3], rows[:, 3:6])
    n_sq, e_sq = isx.square_normal(d)

    # PrimType values are 0..5 in this order
    n = n_pl
    ent = torch.ones_like(e_pl)
    for k, (nk, ek) in enumerate(((n_pl, e_pl), (n_sp, e_sp), (n_tr, e_tr),
                                  (n_to, e_to), (n_aa, e_aa), (n_sq, e_sq))):
        is_k = pt == k
        if k:
            n = torch.where(is_k[..., None], nk, n)
        ent = torch.where(is_k, ek, ent)

    albedo = prow[:, 9:12]
    tex = prow[:, 22].to(torch.int32)
    if scene.textures.shape[0] > 0:
        u, v = _hit_uv(pt, rows, o, d, t, n)
        albedo = torch.where((tex >= 0)[..., None],
                             _texture_lookup(scene.textures, tex, u, v), albedo)

    return dict(
        n=n,
        is_entering=ent,
        kind=prow[:, 21].to(torch.int32),
        albedo=albedo,
        emission=prow[:, 12:15],
        extra=prow[:, 15:20],
    )


def _hit_uv(pt, rows, o, d, t, n):
    """UV coordinates for textured primitives (sphere and square; other
    types read (0, 0))."""
    p = o + d * t[..., None]
    u_sp = 0.5 + torch.atan2(n[..., 2], n[..., 0]) / (2.0 * math.pi)
    v_sp = 0.5 - torch.asin(torch.clamp(n[..., 1], -1.0, 1.0)) / math.pi
    size = torch.clamp(rows[:, 3], min=1e-12)
    u_sq = (p[..., 0] - rows[:, 0]) / size + 0.5
    v_sq = (p[..., 2] - rows[:, 2]) / size + 0.5
    is_sq = pt == int(PrimType.SQUARE)
    is_sp = pt == int(PrimType.SPHERE)
    u = torch.where(is_sq, u_sq, torch.where(is_sp, u_sp, 0.0))
    v = torch.where(is_sq, v_sq, torch.where(is_sp, v_sp, 0.0))
    return u, v


def _texture_lookup(atlas, tex, u, v):
    """Nearest-neighbour wrap-around lookup."""
    K, th, tw, _ = atlas.shape
    k = torch.clamp(tex, 0, K - 1).long()
    x = torch.remainder((u * tw).to(torch.int32), tw).long()
    y = torch.remainder((v * th).to(torch.int32), th).long()
    return atlas[k, y, x]
