"""The probe kernels' own arithmetic (K4, K5 and K7 on the cluster set's
staged triangle table) in plain PyTorch, ``probe_*_staged``, against the
plain versions and against the JAX package's Pallas kernels in interpret
mode (``probe_pair_raw``, ``probe_blocks_min``, ``probe_blocks``).

The rules are those of the staged dense sweep's tests
(``tests/test_torch_traverse.py``, ``STAGED_CASES``):

- hits agree on > 99.9% of rays (of the (R, G) entries for K7), t within
  rtol 1e-5 / atol 1e-4 where both hit; on the mixed set rtol = atol =
  1e-4, the mixed-family tolerance of ``tests/test_torch_probe_kernels.py``
  (the Pallas sphere test rounds a grazing ray's quadratic otherwise than
  the block test the twin shares with the plain version);
- a shape id may differ only on a tie: the plain version's own distance
  to the slot the twin chose equals the reference t within that
  tolerance (rays aimed at shared edges and vertices hit two or more
  triangles at the same t, and rounding picks among them);
- translated_1e3, everything moved 1e3 out: the staged offsets
  k_i = slack - a_i . m_i cancel, a coordinate's ulp (6.1e-5) is three
  times the edge slack, so up to 0.5% of rays may flip, and t is held to
  atol 2e-3 (32 ulp of a coordinate).

The CUDA kernels run only on a GPU: the ``gpu``-marked cases hold them
against the staged twin and the plain version there and skip here.  On
the card nvcc contracts the sphere quadratic and the torus march to fused
multiply-adds, so a grazing slot may be hit by the kernel and missed by
the other side (K7's entries agree in that on > 99.9%, the rule of
``chip_smoke.py``'s phase 16): a ray whose cluster holds such a slot is
held to the hit rule only.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_probe_kernels import _case, _rays
from wasm_pathtracer_tpu.models import scenes as jscenes
from wasm_pathtracer_tpu.ops import cluster as jcl
from wasm_pathtracer_tpu.ops import probe_pallas as jpp
from wasm_pathtracer_tpu_torch.ops import cluster as tcl
from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
from wasm_pathtracer_tpu_torch.ops import traverse_kernels as tk

TRI = 2


@dataclasses.dataclass(frozen=True)
class Rule:
    hit_rate: float
    rtol: float
    atol: float


TRIANGLES = Rule(0.999, 1e-5, 1e-4)
MIXED = Rule(0.999, 1e-4, 1e-4)
FAR = Rule(0.995, 0.0, 2e-3)


def _tri_set(rows, group=128):
    """(JAX cluster set, port cluster set) of (T, 9) triangle rows in
    their given order."""
    T = rows.shape[0]
    cj = jcl.build_clusters(rows, np.full(T, TRI, np.int32), np.arange(T), group=group)
    return cj, tcl.cluster_from_numpy(
        {k: np.asarray(getattr(cj, k)) for k in tcl.ARRAY_FIELDS}, cj.families, device="cpu")


def _aimed_rays(n, seed, shift=0.0):
    """Rays from in front of the triangle cloud into its volume."""
    r = np.random.default_rng(seed)
    o = r.uniform(-3, 3, (n, 3))
    o[:, 2] -= 4.0
    d = r.uniform([-2.5, -2.5, 0], [3, 3, 5.5], (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (o + shift).astype(np.float32), d.astype(np.float32)


def _edge_rays(tris, n, seed):
    """Rays from outside a (T, 3, 3) mesh at points of its edges, every
    third one at a vertex: each target lies on two or more triangles."""
    r = np.random.default_rng(seed)
    i, k = r.integers(0, tris.shape[0], n), r.integers(0, 3, n)
    a, b = tris[i, k], tris[i, (k + 1) % 3]
    w = r.random((n, 1))
    w[::3] = 0.0
    target = a * (1 - w) + b * w
    o = target * r.uniform(2.0, 3.0, (n, 1)) + 0.3 * r.normal(size=(n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _cloud(shift=0.0):
    return jscenes.triangle_cloud(700, seed=5).reshape(-1, 9).astype(np.float32) \
        + np.float32(shift)


def _one_triangle():
    """One triangle in a cluster of 128: 127 padding slots."""
    return _tri_set(np.array([[-2, -2, 3, 2, -2, 3, 0, 2, 3]], np.float32))


def _prep_set(name):
    _, pj, pt = _case(name)
    return pj.cluster, pt.cluster


# name -> (cluster sets, rays(n, seed), rule)
CASES = {
    "mesh": (lambda: _prep_set("mesh"), _rays, TRIANGLES),
    "mixed": (lambda: _prep_set("mixed"), _rays, MIXED),
    "one_triangle": (_one_triangle, _rays, TRIANGLES),
    "mesh_edges": (lambda: _tri_set(jscenes.surface_mesh(14).reshape(-1, 9)),
                   lambda n, seed: _edge_rays(jscenes.surface_mesh(14), n, seed),
                   TRIANGLES),
    "translated_1e3": (lambda: _tri_set(_cloud(1e3)),
                       lambda n, seed: _aimed_rays(n, seed, 1e3), FAR),
}
KERNELS = ("pair", "min", "blocks")


@functools.cache
def _inputs(name, n):
    """(JAX set, port set, o, d, c1, c2): each ray's first and second
    cluster by entry, every fourth ray two other clusters."""
    make_sets, make_rays, _ = CASES[name]
    cj, cs = make_sets()
    o, d = make_rays(n, 9)
    C = cs.num_clusters
    fresh = (torch.full((n,), -torch.inf), torch.full((n,), -1, dtype=torch.int32))
    sel = pk.select_blocks_reference(cs, torch.from_numpy(o), torch.from_numpy(d), *fresh)
    other = np.arange(n) % 4 == 3
    c1 = np.where(other, np.arange(n) * 13 % C, sel[1].numpy()).astype(np.int32)
    c2 = np.where(other, (c1 * 7 + 3) % C, sel[3].numpy()).astype(np.int32)
    return cj, cs, o, d, c1, c2


def _assert_round_close(cs, o, d, cidx, ref, got, rule, min_hits=8, flipped=None):
    """One round's (t, sid) against a reference's under ``rule``; rays
    marked ``flipped`` (a slot that one side hits and the other misses)
    are held to the hit rule only."""
    t0, s0 = (np.asarray(x) for x in ref)
    t1, s1 = (np.asarray(x) for x in got)
    h0, h1 = np.isfinite(t0), np.isfinite(t1)
    assert (h0 == h1).mean() > rule.hit_rate
    both = h0 & h1 & (True if flipped is None else ~flipped)
    np.testing.assert_allclose(t1[both], t0[both], rtol=rule.rtol, atol=rule.atol)
    assert (s1[~h1] == -1).all()
    idx = np.nonzero(both & (s1 != s0))[0]
    if idx.size:
        # a differing id is a tie: the plain distance to the chosen slot is t
        t_slots = pk.probe_blocks_reference(
            cs, *(torch.from_numpy(x[idx]) for x in (o, d, cidx))).numpy()
        grid = cs.slot_to_sid.view(cs.num_clusters, cs.group)[cidx[idx]].numpy()
        mine = t_slots[np.arange(idx.size), (grid == s1[idx, None]).argmax(1)]
        np.testing.assert_allclose(mine, t0[idx], rtol=rule.rtol, atol=rule.atol)
    assert both.sum() >= min_hits


def _assert_blocks_close(ref, got, rule, min_hits=8):
    ref, got = np.asarray(ref), np.asarray(got)
    assert got.shape == ref.shape
    f0, f1 = np.isfinite(ref), np.isfinite(got)
    both = f0 & f1
    assert (f0 == f1).mean() > rule.hit_rate
    np.testing.assert_allclose(got[both], ref[both], rtol=rule.rtol, atol=rule.atol)
    assert both.sum() >= min_hits


def _check(kernel, cs, o, d, c1, c2, ref, got, rule, min_hits=8, flipped=(None, None)):
    """``got`` against ``ref`` for ``kernel``, numpy arrays; ``cs`` on
    the CPU; ``flipped`` per round as ``_assert_round_close`` takes it."""
    if kernel == "blocks":
        _assert_blocks_close(ref, got, rule, min_hits)
        return
    rounds = ((c1, 0), (c2, 2)) if kernel == "pair" else ((c1, 0),)
    for (cidx, k), flip in zip(rounds, flipped):
        _assert_round_close(cs, o, d, cidx, ref[k:k + 2], got[k:k + 2], rule, min_hits,
                            flip)


def _run(fn, kernel, cs, o, d, c1, c2):
    """``fn`` ('reference' or 'staged') of ``kernel`` as numpy arrays."""
    name = {"pair": "probe_pair", "min": "probe_min", "blocks": "probe_blocks"}[kernel]
    args = [torch.from_numpy(x) for x in (o, d, c1, c2)]
    out = getattr(pk, f"{name}_{fn}")(cs, *(args if kernel == "pair" else args[:3]))
    return out.numpy() if kernel == "blocks" else [x.numpy() for x in out]


@pytest.mark.parametrize("name", list(CASES))
def test_staged_table_is_staged_rows(name):
    """Each triangle slot holds ``staged_rows`` of its vertices, row q of
    the slots together; every other slot is zero, and a padding slot is
    never hit."""
    _, cs = CASES[name][0]()
    C, G = cs.num_clusters, cs.group
    assert cs.staged.shape == (C, 4, G, 4) and cs.staged.dtype == torch.float32
    assert cs.staged.is_contiguous()
    rows = cs.staged.transpose(1, 2).reshape(C * G, 16)
    tri = cs.btype.reshape(-1) == TRI
    assert torch.equal(rows[tri], tk.staged_rows(cs.blocks.reshape(-1, 9)[tri]))
    assert not rows[~tri].any()
    n = 256
    o, d = (torch.from_numpy(x) for x in CASES[name][1](n, 4))
    for c in range(C):
        pad = cs.btype[c] < 0
        t = pk.probe_blocks_staged(cs, o, d, torch.full((n,), c, dtype=torch.int32))
        assert torch.isinf(t[:, pad]).all()
    if name == "one_triangle":
        assert C == 1 and int(tri.sum()) == 1


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("name", list(CASES))
def test_probe_staged_matches_plain(name, kernel):
    _, cs, o, d, c1, c2 = _inputs(name, 4096)
    rule = CASES[name][2]
    ref = _run("reference", kernel, cs, o, d, c1, c2)
    got = _run("staged", kernel, cs, o, d, c1, c2)
    _check(kernel, cs, o, d, c1, c2, ref, got, rule)


def _pallas(kernel, cj, o, d, c1, c2):
    """The Pallas kernel of ``kernel`` in interpret mode, as numpy."""
    o, d, c1, c2 = (jnp.asarray(x) for x in (o, d, c1, c2))
    table = jpp.pack_table(cj)
    with pltpu.force_tpu_interpret_mode():
        if kernel == "blocks":
            return np.asarray(jpp.probe_blocks(cj, table, o, d, c1))
        if kernel == "min":
            return [np.asarray(x) for x in jpp.probe_blocks_min(cj, table, o, d, c1)]
        rows = jpp.probe_pair_raw(cj, table, o, d, c1, c2)
    return [np.asarray(x) for row in rows
            for x in (row[:, 0], np.asarray(row[:, 1]).astype(np.int32))]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("name", list(CASES))
def test_probe_staged_matches_pallas(name, kernel):
    cj, cs, o, d, c1, c2 = _inputs(name, 256)
    ref = _pallas(kernel, cj, o, d, c1, c2)
    got = _run("staged", kernel, cs, o, d, c1, c2)
    _check(kernel, cs, o, d, c1, c2, ref, got, CASES[name][2])


def test_replace_keeps_staged_table():
    """``dataclasses.replace(cs, unreduced_probe=True)`` carries the staged
    table, and the lockstep trace with the unreduced probe equals the
    reduced one bit for bit."""
    _, cs, o, d, _, _ = _inputs("mesh", 512)
    cs7 = dataclasses.replace(cs, unreduced_probe=True)
    assert cs7.unreduced_probe and cs7.staged is cs.staged and cs7.table is cs.table
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t_init = torch.full((o.shape[0],), torch.inf)
    ref = tcl.trace_clusters(cs, o, d, t_init)
    out = tcl.trace_clusters(cs7, o, d, t_init)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert int((ref[1] >= 0).sum()) > 50


# ---------------------------------------------------------------------------
# The CUDA kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _gpu_set(shape, device):
    """(cluster set on ``device``, rays, rule) of a ``gpu`` case."""
    def tris(rows, group=128):
        T = rows.shape[0]
        return tcl.build_clusters(rows, np.full(T, TRI, np.int32), np.arange(T),
                                  group=group, device=device)

    if shape == "three_rays":
        return _case("mesh", device)[2].cluster, _rays(3, 2), TRIANGLES
    if shape == "ragged_rays":
        return _case("mesh", device)[2].cluster, _rays(4096 + 37, 3), TRIANGLES
    if shape == "group77":
        return tris(_cloud(), group=77), _aimed_rays(4096 + 37, 4), TRIANGLES
    if shape == "one_cluster":
        return tris(_cloud()[:100]), _aimed_rays(4096 + 37, 5), TRIANGLES
    return _case("mixed", device)[2].cluster, _rays(4096 + 37, 6), MIXED


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", ["three_rays", "ragged_rays", "group77", "one_cluster",
                                   "mixed"])
def test_cuda_probe_matches_staged_on_gpu(cuda_device, shape, kernel):
    """K4, K5 and K7 against the staged twin and the plain version, on the
    card: G = 128 and 77, C = 1, 3 rays and a ragged ray count, triangles
    only and every family, under the module's rules; a ray whose cluster
    holds a slot that the kernel hits and the other side misses (or the
    reverse) is held to the hit rule only.  K7's minimum over G equals
    K5's t bit for bit."""
    cs, (o, d), rule = _gpu_set(shape, cuda_device)
    n, C = o.shape[0], cs.num_clusters
    assert shape != "one_cluster" or C == 1
    assert shape != "group77" or cs.group == 77
    o, d = (torch.from_numpy(x).to(cuda_device) for x in (o, d))
    fresh = (torch.full((n,), -torch.inf, device=cuda_device),
             torch.full((n,), -1, dtype=torch.int32, device=cuda_device))
    sel = pk.select_blocks_reference(cs, o, d, *fresh)
    spread = torch.arange(n, device=cuda_device, dtype=torch.int32) * 13 % C
    c1 = torch.where(torch.arange(n, device=cuda_device) % 4 == 3, spread, sel[1])
    c1 = c1.to(torch.int32).contiguous()
    c2 = torch.where(torch.isfinite(sel[2]), sel[3], (c1 * 7 + 3) % C).to(torch.int32)
    c2 = c2.contiguous()
    name = {"pair": "probe_pair", "min": "probe_min", "blocks": "probe_blocks"}[kernel]
    args = (cs, o, d, c1, c2) if kernel == "pair" else (cs, o, d, c1)
    got = getattr(pk, name)(*args)
    torch.cuda.synchronize()
    cs_cpu = dataclasses.replace(cs, **{f.name: getattr(cs, f.name).cpu()
                                        for f in dataclasses.fields(cs)
                                        if isinstance(getattr(cs, f.name), torch.Tensor)})
    host = [x.cpu().numpy() for x in (o, d, c1, c2)]

    def numpy(out):
        return out.cpu().numpy() if kernel == "blocks" else [x.cpu().numpy() for x in out]

    for fn in ("staged", "reference"):
        ref = getattr(pk, f"{name}_{fn}")(*args)
        # a grazing sphere, torus or box edge may be hit on one side and
        # missed on the other (K7's entries agree in that on > 99.9%): a
        # ray with such a slot may take another t
        flipped = []
        for cidx in (c1, c2)[:2 if kernel == "pair" else 1]:
            flip = (torch.isfinite(pk.probe_blocks(cs, o, d, cidx))
                    != torch.isfinite(getattr(pk, f"probe_blocks_{fn}")(cs, o, d, cidx)))
            assert flip.float().mean() < 1e-3
            flipped.append(flip.any(dim=1).cpu().numpy())
        _check(kernel, cs_cpu, *host, numpy(ref), numpy(got), rule,
               min_hits=8 if n > 3 else 0, flipped=flipped + [None])
    if kernel == "blocks":
        t5 = pk.probe_min(cs, o, d, c1)[0]
        assert torch.equal(got.amin(dim=1), t5)
