"""Regeneration (``ops/regen.py``): one iteration's claims and new paths,
on both routes, against a per-lane Python walk of the claim rule, on the
CPU.

The rule (the JAX package's): a lane whose path ends adds the path to
the frame and counts it; walking the lanes in order, each ended lane with
fewer than ``K`` finished paths takes the next queue entry while the
queue lasts; the cursor moves past every such lane, up to ``S``.  A lane
that takes entry ``s`` starts pixel ``queue[s]`` with ray id ``rid_base +
s`` and the primary ray ``primary_rays`` gives it.  The flat route's
FINALIZE decides which bounces are complete and picks the next traced
ray: the pending shadow query, else the new path, else the next bounce.

Also on the CPU: ``regen_kernels.fused_regen`` runs the eager code on
CPU tensors without counting a launch, the queue loops regenerate
through it once an iteration, and the benchmark's
``queue.regen_launch_share`` reads hand-built profiles.  The kernel
itself is held against this code in ``test_torch_regen_kernel.py`` (on
the card).

This file imports no JAX.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
from wasm_pathtracer_tpu_torch.models import scenes
from wasm_pathtracer_tpu_torch.models.camera import Camera, primary_rays
from wasm_pathtracer_tpu_torch.ops import integrator, trace
from wasm_pathtracer_tpu_torch.ops import regen as rg
from wasm_pathtracer_tpu_torch.ops import regen_kernels as rgk
from wasm_pathtracer_tpu_torch.utils import rng as rnglib

REPO = pathlib.Path(__file__).resolve().parents[1]
W, H, B = 8, 6, 24
CAM = Camera.create((0.5, 1.0, -3.0), 0.3, -0.2, device="cpu")
SETTINGS = RenderSettings(max_bounces=4)


def _lanes(S, seed, flat):
    """(Queue, Lanes) on a queue of S random pixels, the registers drawn
    at random as a loop might hold them mid-frame."""
    g = torch.Generator().manual_seed(seed)
    pix = torch.randint(0, W * H, (S,), generator=g)
    acc = torch.zeros((W * H + 1, 3))
    cnt = torch.zeros((W * H + 1,), dtype=torch.int32)
    q, ln = rg.start(pix, B, W, H, 0xC0FFEE + seed, 1000 + seed, SETTINGS, CAM, acc, cnt)

    def flags(p):
        return torch.rand((B,), generator=g) < p

    ln.tp = torch.rand((B, 3), generator=g)
    ln.col = torch.rand((B, 3), generator=g)
    ln.absorb = torch.rand((B, 3), generator=g)
    ln.hdb = flags(0.5)
    ln.alive = flags(0.5)
    ln.bounce = torch.randint(0, SETTINGS.max_bounces + 1, (B,), generator=g)
    ln.pid = torch.randint(0, W * H, (B,), generator=g)
    ln.k_lane = torch.randint(0, q.K, (B,), generator=g)
    if flat:
        ln.tr_o = torch.randn((B, 3), generator=g)
        ln.tr_d = torch.randn((B, 3), generator=g)
        ln.shadow = flags(0.5)
        ln.need_scan = flags(0.5)
    return q, ln, g


def _finalize(ln, g):
    """Random FINALIZE inputs that a loop can produce: a lane resolves a
    shadow query or shades a primary hit (never both), and leaves a query
    pending only where it shaded."""
    done = torch.rand((B,), generator=g) < 0.7
    resolve, shade = done & ln.shadow, done & ~ln.shadow
    pend = shade & (torch.rand((B,), generator=g) < 0.4)
    return rg.Finalize(resolve, shade, pend, torch.rand((B,), generator=g) < 0.5,
                       torch.rand((B,), generator=g) < 0.5,
                       torch.randn((B, 3), generator=g), torch.randn((B, 3), generator=g))


def _walk(q, ln, was, fin):
    """The claim rule lane by lane: the registers, frame and cursor it
    leaves, as plain Python values and tensors."""
    S, K, HW = q.S, q.K, W * H
    r = {k: getattr(ln, k).clone() for k in ("o", "d", "tp", "col", "alive", "hdb", "absorb",
                                             "bounce", "pid", "rid", "k_lane")}
    if fin is not None:
        r.update({k: getattr(ln, k).clone() for k in ("tr_o", "tr_d", "shadow", "need_scan")})
    acc, cnt = q.acc.clone(), q.cnt.clone()
    issued = int(ln.issued)
    taken = 0
    for i in range(B):
        cont = False
        if fin is None:
            end = bool(was[i]) and (not bool(ln.alive[i])
                                    or int(ln.bounce[i]) >= SETTINGS.max_bounces)
        else:
            done = bool(fin.resolve[i]) or (bool(fin.shade[i]) and not bool(fin.pend[i]))
            cont = done and bool(fin.cont_prev[i] if ln.shadow[i] else fin.cont_shade[i])
            end = done and not cont
        if end:
            acc[int(ln.pid[i])] += ln.col[i]
            cnt[int(ln.pid[i])] += 1
            r["k_lane"][i] += 1
        can = False
        if end and int(r["k_lane"][i]) < K:
            s = issued + taken
            taken += 1
            if s < S:
                can = True
                pid = min(int(q.pixq_pad[s]), HW)
                rid = (q.rid_base + s) & 0xFFFFFFFF
                jx, jy, _ = rnglib.uniform3(q.seed, torch.tensor([rid]), rg.SLOT_JITTER)
                o, d = primary_rays(CAM, torch.tensor([pid % W]), torch.tensor([pid // W]),
                                    jx, jy, W, H, SETTINGS.screen_z)
        if fin is not None:
            pend = bool(fin.pend[i])
            if pend:
                r["tr_o"][i], r["tr_d"][i] = fin.o_sh[i], fin.d_sh[i]
            elif can:
                r["tr_o"][i], r["tr_d"][i] = o[0], d[0]
            elif cont:
                r["tr_o"][i], r["tr_d"][i] = ln.o[i], ln.d[i]
            start = pend or can or cont
            if start:
                r["shadow"][i] = pend
            r["need_scan"][i] = start
        r["alive"][i] = (bool(ln.alive[i]) and not end) or can
        if can:
            r["o"][i], r["d"][i] = o[0], d[0]
            r["tp"][i], r["col"][i], r["absorb"][i] = 1.0, 0.0, 0.0
            r["hdb"][i] = False
            r["bounce"][i] = 0
            r["pid"][i], r["rid"][i] = pid, rid
    return r, acc, cnt, min(issued + taken, S)


def _check(q, ln, was=None, fin=None):
    want, acc, cnt, issued = _walk(q, ln, was, fin)
    rg.regen(q, ln, was, fin)
    for k, v in want.items():
        got = getattr(ln, k)
        assert got.dtype == v.dtype and torch.equal(got, v), k
    assert int(ln.issued) == issued
    # the frame's row HW holds what the eager code adds for the other lanes
    assert torch.equal(q.cnt, cnt)
    assert torch.allclose(q.acc[:-1], acc[:-1], rtol=1e-6, atol=1e-6)


# (S, the cursor before the iteration, lanes alive before the bounce,
# which of them end, k_lane held at K - 1)
QUEUE_CASES = {
    "no_lane_ends": (500, 30, "none", "none", False),
    "every_lane_claims": (500, 30, "all", "all", False),
    "queue_runs_out_mid_iteration": (40, 30, "all", "all", False),
    "queue_already_drained": (40, 40, "all", "all", False),
    "lanes_at_capacity": (500, 30, "all", "all", True),
    "mixed": (60, 45, "half", "half", True),
}


@pytest.mark.parametrize("case", list(QUEUE_CASES))
def test_queue_route_follows_the_claim_rule(case):
    S, issued, was_p, end_p, at_cap = QUEUE_CASES[case]
    q, ln, g = _lanes(S, len(case), flat=False)
    ln.issued = torch.tensor(issued)
    p = {"none": 0.0, "half": 0.5, "all": 1.0}
    was = torch.rand((B,), generator=g) < p[was_p]
    # a lane ends when it died or reached the cap
    ln.alive = ~(torch.rand((B,), generator=g) < p[end_p])
    ln.bounce = torch.where(ln.alive, torch.randint(0, SETTINGS.max_bounces, (B,), generator=g),
                            ln.bounce)
    if at_cap:
        ln.k_lane[::3] = q.K - 1
    _check(q, ln, was=was)


@pytest.mark.parametrize("seed", range(4))
def test_flat_route_finalize_follows_the_claim_rule(seed):
    """Shadow queries resolved or pending, paths that go on or end, a
    queue that runs out within the iteration (seeds 2, 3)."""
    S = 400 if seed < 2 else 30
    q, ln, g = _lanes(S, 10 + seed, flat=True)
    ln.issued = torch.tensor(min(20, S))
    _check(q, ln, fin=_finalize(ln, g))


def test_lanes_at_the_bounce_cap_end():
    q, ln, _ = _lanes(500, 3, flat=False)
    was = torch.ones((B,), dtype=torch.bool)
    ln.alive = torch.ones((B,), dtype=torch.bool)
    ln.bounce = torch.arange(B) % (SETTINGS.max_bounces + 1)
    ended = ln.bounce >= SETTINGS.max_bounces
    _check(q, ln, was=was)
    assert int(q.cnt.sum()) == int(ended.sum())


def test_fused_regen_takes_the_eager_code_off_the_card():
    q, ln, _ = _lanes(500, 5, flat=False)
    q2 = dataclasses.replace(q, acc=q.acc.clone(), cnt=q.cnt.clone())
    ln2 = dataclasses.replace(ln)
    was = torch.ones((B,), dtype=torch.bool)
    before = rgk.fused_regen.launches
    rg.regen(q, ln, was)
    rgk.fused_regen(q2, ln2, was)
    assert rgk.fused_regen.launches == before
    assert all(torch.equal(getattr(ln, f.name), getattr(ln2, f.name))
               for f in dataclasses.fields(ln) if getattr(ln, f.name) is not None)
    assert torch.equal(q.acc, q2.acc) and torch.equal(q.cnt, q2.cnt)


def test_camera_operand_holds_the_rotation_of_primary_rays():
    cam = rg.camera_operand(CAM, "cpu")
    assert cam.dtype == torch.float32 and cam.shape == (7,)
    assert torch.equal(cam[:3], CAM.location)
    assert torch.equal(cam[3:], torch.stack([torch.cos(CAM.rot_x), torch.sin(CAM.rot_x),
                                             torch.cos(CAM.rot_y), torch.sin(CAM.rot_y)]))


def _triangles():
    """64 triangles over a plane under a two-triangle light."""
    from wasm_pathtracer_tpu_torch.models.scene import Material, SceneBuilder
    r = np.random.default_rng(3)
    b = SceneBuilder(background=(0.05, 0.05, 0.1))
    b.add_plane((0.0, -3.0, 0.0), (0.0, 1.0, 0.0), Material.diffuse(0.8, 0.8, 0.8))
    tris = r.uniform(-2.0, 2.0, (64, 1, 3)) + r.uniform(-0.4, 0.4, (64, 3, 3))
    b.add_triangles(tris.astype(np.float32), Material.diffuse(0.7, 0.4, 0.3))
    light = Material.emissive(10.0, 10.0, 10.0)
    b.add_triangle((1.5, 4.0, 1.5), (1.5, 4.0, -1.5), (-1.5, 4.0, -1.5), light)
    b.add_triangle((-1.5, 4.0, 1.5), (1.5, 4.0, 1.5), (-1.5, 4.0, -1.5), light)
    return b.build("cpu")


@pytest.mark.parametrize("route", ["queue", "flat"])
def test_loops_regenerate_once_an_iteration(route, monkeypatch):
    from wasm_pathtracer_tpu_torch.ops import bvh, wavefront
    calls = []

    def counting(q, ln, was=None, fin=None):
        calls.append(fin is not None)
        rg.regen(q, ln, was, fin)

    monkeypatch.setattr(rgk, "fused_regen", counting)
    scene = _triangles() if route == "flat" else scenes.sphere_plane(device="cpu")
    prep = trace.prepare(scene)
    fn = integrator.render_queue
    if route == "flat":
        prep = bvh.attach_clusters(prep, scene, group=16, min_count=16)
        fn = wavefront.render_queue_flat
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=3)
    acc, cnt, _, its = fn(prep, scene, st, CAM, torch.arange(64) % 48, 8, 6, 5, 16,
                          return_iters=True)
    assert len(calls) == its > 0 and set(calls) == {route == "flat"}
    assert int(cnt.sum()) == 64


def _share(profile):
    from portbench import harness
    reader = harness.load_module(REPO / "portbench" / "metrics" / "queue.regen_launch_share.py")
    return reader.read(harness.Observed(config={"iteration_kernel": "fused_nearest"},
                                        counters={}, host={}, profile=profile))


K1 = "void wpt::fused_nearest_kernel<8, 128>(float const*, wpt::Counts)"
REGEN = "void wpt::wpt_regen_kernel<false, false>(wpt::RegenArgs)"


@pytest.mark.parametrize("names, launched, want", [
    ([K1, REGEN, "elementwise"] * 3, {"fused_nearest": 3}, 1.0),
    ([K1, "elementwise", "elementwise"] * 3, {"fused_nearest": 3}, 0.0),
    ([K1, REGEN, K1], {"fused_nearest": 2}, 0.5),
    ([REGEN], {"fused_nearest": 0}, None),
    (None, None, None),
])
def test_regen_launch_share_reader(names, launched, want):
    from portbench import harness
    profile = None
    if names is not None:
        ops = [(n, 10 * i, 10 * i + 5) for i, n in enumerate(names)]
        profile = harness.Profile(device_ops=ops, host_events=[], wall_s=1.0,
                                  launched=launched, calls={}, units=1)
    assert _share(profile) == want
