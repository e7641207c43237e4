"""Scene tracing: nearest hit, shadow rays, hit shading info
(``wasm_pathtracer_tpu.ops.trace``).

The dense families of a scene go through the whole-scene kernels of
``ops.scene_kernels``: :func:`trace_scene` through the nearest-hit
kernel and :func:`shadow_ray` through the any-hit kernel.  The triangle
family has two more routes, chosen per prep: the dense sweep kernel
(``prepare(scene, use_pallas=True)``, ``ops.traverse_kernels``) and the
4-wide BVH walk (``ops.bvh.attach_bvh``, ``ops.traverse``).  A prep with
a cluster structure (``ops.bvh.attach_clusters``) merges the clusters'
nearest hit after the others (``ops.cluster.trace_clusters``).  With any
of these three the shadow rays are nearest-hit traces plus the occlusion
comparison.  The kernel wrappers take their plain PyTorch versions for
CPU tensors.
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

    ``use_pallas`` (the JAX package's name for the flag) sends the
    triangle family through the dense sweep kernel, and the four
    ``bvh_*`` tables (``ops.bvh.attach_bvh``) through the BVH walk;
    ``use_pallas`` wins where both are set.  Either withdraws the
    triangles from ``tables``, ``code_of`` and ``sid_of_slot`` (the JAX
    package reaches these routes only with its fused kernel off; here
    the scene kernels keep the five other families).  ``tri_rows`` is
    the sweep's (T, 9) table in ``idx_triangle`` order.
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
    use_pallas: bool = False
    tri_rows: torch.Tensor | None = None
    bvh_bounds: torch.Tensor | None = None      # (M, 4, 6) f32 child AABBs
    bvh_children: torch.Tensor | None = None    # (M, 4) int64 (neg = leaf)
    bvh_prim_index: torch.Tensor | None = None  # (T,) int64 leaf -> shape id
    bvh_tri_rows: torch.Tensor | None = None    # (T, 9) f32 leaf-order verts

    @property
    def has_bvh(self) -> bool:
        return self.bvh_bounds is not None


# ScenePrep's index sets, in family (PrimType) order
INDEX_FIELDS = ("idx_plane", "idx_sphere", "idx_triangle", "idx_torus",
                "idx_aarect", "idx_square")


def prepare(scene: SceneData, use_pallas: bool = False) -> ScenePrep:
    """Host-side split of the shape table into per-family index sets.
    Call it again after changing the scene: the tables are a copy.
    ``use_pallas`` routes the triangles through the dense sweep kernel."""
    ptype = scene.ptype.cpu().numpy()
    return prepare_from_sets(scene, [np.nonzero(ptype == int(t))[0]
                                     for t in PrimType], use_pallas=use_pallas)


def _kernel_sets(sets, withdraw_triangles: bool) -> list:
    """The scene kernels' six index sets: without the triangles when the
    dense sweep or the BVH traces them."""
    ksets = list(sets)
    if withdraw_triangles:
        ksets[int(PrimType.TRIANGLE)] = sets[0][:0]
    return ksets


def prepare_from_sets(scene: SceneData, index_sets, cluster=None,
                      use_pallas: bool = False, bvh: dict | None = None) -> ScenePrep:
    """A prep whose dense families are the six given shape-id sets (in
    family order), with ``cluster`` attached.  ``bvh`` holds the arrays
    ``bvh_bounds``, ``bvh_children``, ``bvh_prim_index`` and
    ``bvh_tri_rows`` of a 4-wide BVH over the triangle set
    (``ops.bvh.attach_bvh``)."""
    dev = scene.device
    sets = [torch.as_tensor(s if isinstance(s, torch.Tensor) else np.asarray(s),
                            dtype=torch.int64, device=dev) for s in index_sets]
    ksets = _kernel_sets(sets, use_pallas or bvh is not None)
    sizes = [int(s.shape[0]) for s in ksets]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])

    def table(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(dev)

    bvh_fields = {} if bvh is None else dict(
        bvh_bounds=table(bvh["bvh_bounds"], np.float32),
        bvh_children=table(bvh["bvh_children"], np.int64),
        bvh_prim_index=table(bvh["bvh_prim_index"], np.int64),
        bvh_tri_rows=table(bvh["bvh_tri_rows"], np.float32))
    return ScenePrep(
        *sets,
        code_of=scene_kernels.shape_codes(ksets, scene.num_shapes, dev),
        # one pad entry: a miss (fam -1, slot 0) then indexes safely even
        # in a scene without shapes
        sid_of_slot=torch.cat(ksets + [torch.zeros(1, dtype=torch.int64,
                                                   device=dev)]),
        fam_offset=torch.as_tensor(offsets, dtype=torch.int64, device=dev),
        tables=scene_kernels.build_tables(ksets, scene.params),
        cluster=cluster,
        use_pallas=use_pallas,
        tri_rows=(scene.params[sets[int(PrimType.TRIANGLE)]][:, :9].contiguous()
                  if use_pallas else None),
        **bvh_fields,
    )


def bvh_from_numpy(prep: ScenePrep, scene: SceneData, arrays: dict,
                   use_pallas: bool = False) -> ScenePrep:
    """``prep`` with a 4-wide BVH attached from arrays keyed
    ``bvh_bounds``, ``bvh_children``, ``bvh_prim_index`` and
    ``bvh_tri_rows``: the host build's (``ops.bvh.attach_bvh``), or the
    JAX package's prep read field by field with ``np.asarray``, so that
    both packages walk identical nodes."""
    return prepare_from_sets(scene, [getattr(prep, a) for a in INDEX_FIELDS],
                             cluster=prep.cluster, use_pallas=use_pallas, bvh=arrays)


def trace_scene(prep: ScenePrep, scene: SceneData, o, d):
    """Nearest hit for a ray batch.

    Returns ``(t, shape_id, hit_mask, cost)`` — ``cost`` counts
    primitive and node tests per ray.

    Order, as in the JAX package: the scene kernel over the dense
    families; then the triangles by the dense sweep (``use_pallas``) or
    by the BVH walk pruned by the best hit so far, folded in with a
    strict ``<``; then the clusters.

    On an autograd path (grad mode on, and the rays or ``scene.params``
    requiring grad) this discrete trace runs without autograd on
    detached rays, so the kernels see only plain tensors, and
    :func:`winner_t` re-evaluates the winners' distances.
    """
    if not _needs_grad(scene, o, d):
        return _trace_discrete(prep, scene, o, d)
    with torch.no_grad():
        t, sid, hit, cost = _trace_discrete(prep, scene, o.detach(), d.detach())
    return winner_t(prep, scene, o, d, t, sid), sid, hit, cost


def polls_host(prep: ScenePrep) -> bool:
    """Whether :func:`trace_scene` on ``prep`` may read the device from
    the host: the cluster trace polls its lockstep rounds and the BVH
    walk its stacks."""
    return prep.cluster is not None or (prep.has_bvh and not prep.use_pallas)


def _trace_discrete(prep: ScenePrep, scene: SceneData, o, d):
    """:func:`trace_scene` without the re-evaluation."""
    t, sid, hit, cost = scene_kernels.trace_scene_fused(prep, scene, o, d)
    n_tri = prep.idx_triangle.shape[0]
    if n_tri and (prep.use_pallas or prep.has_bvh):
        if prep.use_pallas:
            from wasm_pathtracer_tpu_torch.ops import traverse_kernels
            t_tri, slot = traverse_kernels.dense_tri_nearest(
                prep.tri_rows, o.contiguous(), d.contiguous())
            sid_tri = prep.idx_triangle[torch.clamp(slot.long(), 0, n_tri - 1)]
            sid_tri = torch.where(torch.isfinite(t_tri), sid_tri, -1)
            cost = cost + n_tri
        else:
            from wasm_pathtracer_tpu_torch.ops import traverse
            t_tri, sid_tri, visits = traverse.trace_bvh4(
                prep.bvh_bounds, prep.bvh_children, prep.bvh_prim_index,
                prep.bvh_tri_rows, o, d, t)
            cost = cost + visits
        better = t_tri < t
        t = torch.where(better, t_tri, t)
        sid = torch.where(better, sid_tri, sid)
        hit = torch.isfinite(t)
    if prep.cluster is None:
        return t, sid, hit, cost
    t_cl, sid_cl, rounds = cl.trace_clusters(prep.cluster, o, d, t)
    better = sid_cl >= 0
    sid = torch.where(better, sid_cl, sid)
    hit = torch.isfinite(t_cl)
    return t_cl, sid, hit, cost + rounds * prep.cluster.group


# ---------------------------------------------------------------------------
# The differentiable route: discrete choices from the kernels, the
# winner's distance re-evaluated under autograd
# ---------------------------------------------------------------------------

# the per-ray distance formula of each family, in PrimType order
_WINNER_T = (isx.plane_t, isx.sphere_t, isx.triangle_t, isx.torus_t,
             isx.aarect_t, isx.square_t)


def _needs_grad(scene: SceneData, *xs) -> bool:
    """Whether a trace of rays ``xs`` through ``scene`` is on an
    autograd path: grad mode is on and the rays or the shape table
    require grad."""
    return torch.is_grad_enabled() and (
        scene.params.requires_grad or any(x.requires_grad for x in xs))


def winner_t(prep: ScenePrep, scene: SceneData, o, d, t, sid):
    """Each ray's hit distance re-evaluated from its winning shape's row
    with the family's own formula (``ops.intersect.*_t``), under
    autograd.

    ``t``, ``sid`` are a discrete trace's (:func:`trace_scene` on
    detached rays).  Shapes the scene kernels trace get a distance that
    is differentiable in ``o``, ``d`` and ``scene.params`` and equals
    ``t`` where the discrete trace ran the plain versions.  The rest
    keep the detached ``t``: misses (+inf), cluster hits (detached in
    the JAX package too) and the triangles of a dense-sweep or BVH prep
    (the train step refuses those for geometry).  A re-evaluation that
    comes out non-finite where the kernel hit also keeps ``t``.
    Families are evaluated on their own rays only, so no masked lane
    can send a non-finite value into the backward pass.
    """
    sid_c = torch.clamp(sid, min=0)
    dense = (sid >= 0) & (prep.code_of[sid_c] >= 0)
    ptype = scene.ptype[sid_c]
    out = t
    for fam, formula in enumerate(_WINNER_T):
        if not prep.tables.counts[fam]:
            continue
        idx = torch.nonzero(dense & (ptype == fam)).squeeze(1)
        if idx.numel():
            out = out.index_put((idx,), formula(o[idx], d[idx],
                                                scene.params[sid_c[idx]]))
    return torch.where(torch.isfinite(out), out, t)


def refresh_tables(prep: ScenePrep, scene: SceneData) -> ScenePrep:
    """``prep`` with the scene kernels' family tables (and the dense
    sweep's rows) gathered anew from ``scene``'s current, detached shape
    table.  The tables are a copy taken at :func:`prepare`; after a step
    moves geometry (a light), the kernels would trace the old one."""
    params = scene.params.detach()
    sets = _kernel_sets([getattr(prep, a) for a in INDEX_FIELDS],
                        prep.use_pallas or prep.has_bvh)
    tri_rows = None
    if prep.use_pallas:
        tri_rows = params[prep.idx_triangle][:, :9].contiguous()
    return dataclasses.replace(prep, tables=scene_kernels.build_tables(sets, params),
                               tri_rows=tri_rows)


def shadow_ray(prep: ScenePrep, scene: SceneData, p, point_on_light,
               light_sid, epsilon: float = isx.EPSILON):
    """Occlusion test; the target light shape itself does not occlude.
    Returns (occluded mask, cost).  This is the any-hit kernel when the
    scene kernels hold every shape; with clusters, the dense sweep or a
    BVH it is a nearest-hit trace and the comparison."""
    to_l = point_on_light - p
    dir_len = vm.length(to_l)
    d = to_l / dir_len[..., None]
    o = p + d * epsilon
    if prep.cluster is None and not (prep.use_pallas or prep.has_bvh):
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
