#!/usr/bin/env python3
"""Time the port's kernels as an older commit had them against the kernels
of this tree, on one NVIDIA GPU, inside one process.

    python3 scripts/kernel_ab.py --parent DIR [--extra NAME=DIR ...]
                                 [--variant NAME:CONST=VALUE,...]
                                 [--only scene|k8|select|probe|paths ...] [--sass]
                                 [--out FILE]
    python3 scripts/kernel_ab.py --kernels-per-iteration

``DIR`` is the older commit's ``csrc`` directory (for example ``git archive
<commit> wasm_pathtracer_tpu_torch/csrc | tar -x -C build/parent``).  Every
library is built here (one ``nvcc`` per source, all builds started
together) and the package's wrappers, or for the scene kernels the entry
points themselves, launch one or the other, so that the commits are
compared under one clock, one timer and one card state.  ``--variant``
adds a copy of this tree's ``csrc`` with the named ``constexpr`` constants
of its sources set to other values (``lanes4:K1_LANES=4,K2_LANES=4``): a
step of a design timed beside the others; ``--extra NAME=DIR`` adds any
other ``csrc`` directory (a patched copy) under that name.

- ``scene``: ``fused_nearest`` (K1) and ``fused_occluded`` (K2) on two ray
  sets of 16,384: the museum rays of ``chip_smoke.py``'s phases ``k1`` and
  ``k2``, and the rays of one call of the museum headline
  (``chip_smoke.headline_inputs``).  Agreement with the plain version
  (hits, max |dt|, shape ids; verdicts), device ms in two rounds, the
  second in reverse order, and a family split: the museum rays' ms with
  one family's count set to 0, with only that family, and with none.  A
  library from before the scene kernels took shape ids (no
  ``wpt_scene_launch_shape``) is called with that commit's arguments.
- ``k8``: ``dense_tri_nearest`` on mesh70k (70,314 triangles) and cloud300k
  (300,002), 16,384 rays of ``chip_smoke.py``'s phase ``k8``: agreement
  with the plain version (hits, max |dt|, slots) and device ms, in two
  rounds, the second in reverse order.
- ``select``: ``select_blocks`` and ``select_scan`` at C = 550 (mesh70k)
  and C = 2,344 (cloud300k): entries equal to the plain version bit for
  bit, ids equal where finite, device ms in two rounds.
- ``probe``: ``probe_pair`` (K4), ``probe_min`` (K5) and ``probe_blocks``
  (K7) at C = 550 (mesh70k) and C = 2,344 (cloud300k) on the rays and
  clusters of ``chip_smoke.py``'s phase ``clusters`` (16,384 rays, the
  clusters the select gives them), on the clustered museum (C = 1,
  every family but planes), and K4 on the inputs of one call of the
  mesh70k flat path (``chip_smoke.flat_inputs``).  Agreement with the
  plain version (hits, max |dt|, shape ids, K7's entries) and K7's
  minimum over G against K5's t, device ms in two rounds, the second in
  reverse order, and each library's registers.  A library from before the
  staged table (no ``wpt_probe_launch_shape``) is called with that
  commit's arguments.
- ``paths``: mesh70k at full width (512x512, NEE, 8 bounces, S = 524,288,
  B = 16,384) through the dense-sweep loop and the flat wavefront, in the
  order parent, current, current, parent: paths/s by the host clock.
  Needs a parent with this tree's scene- and probe-kernel arguments.

``--sass`` disassembles every library (``cuobjdump -sass``) and prints, for
K1, K2, K8 and the probe kernels, each kernel's instruction count and its
loops (a backward branch and the instructions it spans) with their sizes
and most common opcodes, and a hash of K8's instruction stream, which is
equal between two libraries exactly when K8's machine code is.

``--kernels-per-iteration`` profiles a short run of the museum headline
(S = 131,072) with the package and ``chip_smoke.py`` that come first on
``sys.path`` (``WPT_TREE=DIR`` puts another checkout's first) and prints
the device kernels per loop iteration.

Device ms are ``chip_smoke.cuda_ms``: CUDA events around each of five
replays of a CUDA graph that holds the call 50 (K1, K2), 5 (K8) or 20
(selects, probes) times, the median replay per call (a K8 call is its
memset, sweep and unpack kernels).  Results go to standard output and, as JSON, to
``--out`` (``build/kernel_ab.json``).  Needs a GPU and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import hashlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, os.environ.get("WPT_TREE", str(ROOT)))

import chip_smoke as cs  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
# the scene kernels' entry points before they took shape ids
OLD_SCENE_SIGNATURES = {
    # tables, 6 family counts, o, d, R, t_out, fam_out, slot_out, stream
    "wpt_fused_nearest": [_P] + [_I] * 6 + [_P, _P, _I, _P, _P, _P, _P],
    # tables, 6 family counts, o, d, dist, excl code, R, occ_out, stream
    "wpt_fused_occluded": [_P] + [_I] * 6 + [_P, _P, _P, _P, _I, _P, _P],
}


# the probe kernels' entry points before the staged table
OLD_PROBE_SIGNATURES = {
    # table, C, G, o, d, cidx, n_rounds, R, t_out, sid_out, stream
    "wpt_probe": [_P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P],
    # table, C, G, o, d, cidx, R, dist_out, stream
    "wpt_probe_blocks": [_P, _I, _I, _P, _P, _P, _I, _P, _P],
}


def is_old_scene(lib) -> bool:
    return not hasattr(lib, "wpt_scene_launch_shape")


def is_old_probe(lib) -> bool:
    return not hasattr(lib, "wpt_probe_launch_shape")


def variant_csrc(spec: str) -> pathlib.Path:
    """A copy of this tree's csrc (``build/variants/NAME``) with the
    constants of ``NAME:CONST=VALUE,...`` set."""
    from wasm_pathtracer_tpu_torch.ops import _build
    name, _, assigns = spec.partition(":")
    out = ROOT / "build" / "variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out)
    for assign in filter(None, assigns.split(",")):
        const, _, value = assign.partition("=")
        pattern = re.compile(rf"(constexpr \w+ {const} = )[^;]+;")
        hits = 0
        for src in sorted(out.glob("*.cu")) + sorted(out.glob("*.cuh")):
            text, n = pattern.subn(rf"\g<1>{value};", src.read_text())
            if n:
                src.write_text(text)
                hits += n
        if hits != 1:
            raise ValueError(f"variant {name}: {const} is defined {hits} times")
    return out


def build_all(parent, variants=(), extras=()):
    """{"parent": library of the sources in ``parent``, "current": the
    package's own, NAME: each variant's and each extra's}, built in
    parallel.  Each is loaded with the entry points it has (an older
    ``csrc`` may lack some) and this tree's argument types, except a
    scene-kernel or probe library from before shape ids or the staged
    table, which gets that commit's."""
    from wasm_pathtracer_tpu_torch.ops import _build
    dirs = {"parent": pathlib.Path(parent).resolve(), "current": _build.CSRC}
    for spec in variants:
        dirs[spec.partition(":")[0]] = variant_csrc(spec)
    for spec in extras:
        name, _, path = spec.partition("=")
        dirs[name] = pathlib.Path(path).resolve()
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as pool:
        paths = dict(zip(dirs, pool.map(_build.build, dirs.values())))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        lib.path = path
        sigs = dict(_build._SIGNATURES)
        if is_old_scene(lib):
            sigs.update(OLD_SCENE_SIGNATURES)
        if is_old_probe(lib):
            sigs.update(OLD_PROBE_SIGNATURES)
        for entry, argtypes in sigs.items():
            fn = getattr(lib, entry, None)
            if fn is not None:
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = lib
    cs.log("built " + ", ".join(f"{k} {v.parent.name}" for k, v in paths.items()))
    return libs


class use_library:
    """Make the package's wrappers launch the kernels of ``lib``."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from wasm_pathtracer_tpu_torch.ops import _build
        self.saved = _build.library
        _build.library = lambda: self.lib

    def __exit__(self, *exc):
        from wasm_pathtracer_tpu_torch.ops import _build
        _build.library = self.saved


def two_rounds(libs, call, n):
    """{name: [ms in the first round, ms in the second]}; the second round
    runs in reverse order."""
    ms = {name: [] for name in libs}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            with use_library(libs[name]):
                ms[name].append(cs.cuda_ms(call, n))
    return ms


def ab_k8(device, libs):
    import torch
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera
    from wasm_pathtracer_tpu_torch.ops import trace
    from wasm_pathtracer_tpu_torch.ops import traverse_kernels as tk
    sets = {"mesh70k": (scenes.mesh_scene(scenes.surface_mesh(188), device),
                        cs.mesh_camera(device)),
            "cloud300k": (scenes.cloud(300_000, device=device), initial_camera(5, device))}
    out = {}
    for i, (scene_name, (scene, cam)) in enumerate(sets.items()):
        rows = trace.prepare(scene, use_pallas=True).tri_rows
        o, d = cs.test_rays(16_384, 500 + i, device, cam)
        t_p, s_p = tk.dense_tri_nearest_reference(rows, o, d)
        hit_p = torch.isfinite(t_p)
        res = {}
        for name, lib in libs.items():
            with use_library(lib):
                t_k, s_k = tk.dense_tri_nearest(rows, o, d)
                torch.cuda.synchronize()
                shape = (tk.launch_shape(rows.shape[0], 16_384)
                         if hasattr(lib, "wpt_dense_tri_launch_shape") else {})
            hit_k = torch.isfinite(t_k)
            both = hit_k & hit_p
            res[name] = dict(
                hit_agreement=(hit_k == hit_p).float().mean().item(),
                max_abs_dt=(t_k[both] - t_p[both]).abs().max().item(),
                t_within_1e5=bool(torch.allclose(t_k[both], t_p[both], rtol=1e-5, atol=1e-5)),
                slot_agreement=(s_k == s_p)[both].float().mean().item(), **shape)
        ms = two_rounds(libs, lambda: tk.dense_tri_nearest(rows, o, d), 5)
        for name in libs:
            res[name]["ms"] = ms[name]
            cs.log(f"K8 {scene_name} {name}: {json.dumps(res[name])}")
        out[scene_name] = res
    return out


def ab_select(device, libs):
    import torch
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera
    from wasm_pathtracer_tpu_torch.ops import bvh, trace
    from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
    big = scenes.cloud(300_000, device=device)
    sets = {"mesh70k": (cs.mesh70k(device)[1], cs.mesh_camera(device)),
            "cloud300k": (bvh.attach_clusters(trace.prepare(big), big),
                          initial_camera(5, device))}
    out = {}
    for i, (scene_name, (prep, cam)) in enumerate(sets.items()):
        cl = prep.cluster
        o, d = cs.test_rays(16_384, 400 + i, device, cam)
        R = o.shape[0]
        fresh = (torch.full((R,), -torch.inf, device=device),
                 torch.full((R,), -1, dtype=torch.int32, device=device))
        e0, c0 = pk.select_blocks_reference(cl, o, d, *fresh)[:2]
        cont = (torch.arange(R, device=device) % 2 == 0) & torch.isfinite(e0)
        se = torch.where(cont, e0, -torch.inf).contiguous()
        sc = torch.where(cont, c0, -1).to(torch.int32).contiguous()
        ref = pk.select_scan_reference(cl, prep, o, d, se, sc)
        calls = {"select_blocks": lambda: pk.select_blocks(cl, o, d, se, sc),
                 "select_scan": lambda: pk.select_scan(cl, prep, o, d, se, sc)}
        res = {name: {} for name in libs}
        for kernel, call in calls.items():
            for name, lib in libs.items():
                with use_library(lib):
                    got = call()
                    torch.cuda.synchronize()
                exact = all(torch.equal(a, b) for a, b in zip(got[0:5:2], ref[0:5:2]))
                ids = all(torch.equal(a[torch.isfinite(e)], b[torch.isfinite(e)])
                          for a, b, e in ((got[1], ref[1], ref[0]), (got[3], ref[3], ref[2])))
                res[name][kernel] = dict(entries_bit_equal=exact, ids_equal=ids)
            for name, ms in two_rounds(libs, call, 20).items():
                res[name][kernel]["ms"] = ms
        for name in libs:
            cs.log(f"select {scene_name} C={cl.num_clusters} {name}: {json.dumps(res[name])}")
        out[scene_name] = res
    return out


def probe_calls(lib, cl, o, d, c1, c2):
    """({kernel name: call}, outputs): K4 (clusters c1, c2), K5 and K7
    (cluster c1) of ``lib`` launched on these inputs with the arguments
    of the commit it was built from; outputs (t (2, R), sid (2, R), t
    (1, R), sid (1, R), dist (R, G)) hold what the last calls wrote."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
    dev, R, G = o.device, o.shape[0], cl.group
    cidx2 = torch.stack([c1, c2]).contiguous()
    out = (torch.empty((2, R), device=dev), torch.empty((2, R), dtype=torch.int32, device=dev),
           torch.empty((1, R), device=dev), torch.empty((1, R), dtype=torch.int32, device=dev),
           torch.empty((R, G), device=dev))
    head = ((cl.table.data_ptr(), cl.num_clusters, G) if is_old_probe(lib)
            else pk._check_probe(cl, o, d, c1, ())[2])

    def run(entry, *args):
        rc = entry(*head, o.data_ptr(), d.data_ptr(), *args,
                   torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{entry.__name__}: CUDA error {rc}")

    # the calls hold the output tensors, so that their memory outlives them
    t2, s2, t1, s1, dist = out
    return ({"probe_pair": lambda: run(lib.wpt_probe, cidx2.data_ptr(), 2, R, t2.data_ptr(),
                                       s2.data_ptr()),
             "probe_min": lambda: run(lib.wpt_probe, c1.data_ptr(), 1, R, t1.data_ptr(),
                                      s1.data_ptr()),
             "probe_blocks": lambda: run(lib.wpt_probe_blocks, c1.data_ptr(), R,
                                         dist.data_ptr())},
            out)


def probe_sets(device):
    """{name: (cluster set, o, d, c1, c2)}: phase clusters' rays (16,384)
    and clusters on mesh70k, cloud300k and the clustered museum, and the
    inputs of one call of the mesh70k flat path."""
    import torch
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera
    from wasm_pathtracer_tpu_torch.ops import bvh, trace
    from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
    big = scenes.cloud(300_000, device=device)
    sets = {"mesh70k": (cs.mesh70k(device)[1].cluster, cs.mesh_camera(device)),
            "cloud300k": (bvh.attach_clusters(trace.prepare(big), big).cluster,
                          initial_camera(5, device)),
            "museum_clustered": (cs.museum_clustered(device)[1].cluster,
                                 initial_camera(0, device))}
    out = {}
    for i, (name, (cl, cam)) in enumerate(sets.items()):
        o, d = cs.test_rays(16_384, 400 + i, device, cam)
        fresh = (torch.full((16_384,), -torch.inf, device=device),
                 torch.full((16_384,), -1, dtype=torch.int32, device=device))
        sel = pk.select_blocks_reference(cl, o, d, *fresh)
        out[name] = (cl, o, d, sel[1].contiguous(), sel[3].contiguous())
    out["flat_path_inputs"] = cs.flat_inputs(device)
    return out


def ab_probe(device, libs):
    import torch
    from wasm_pathtracer_tpu_torch.ops import probe_kernels as pk
    out = {}
    for set_name, (cl, o, d, c1, c2) in probe_sets(device).items():
        p4 = pk.probe_pair_reference(cl, o, d, c1, c2)
        p7 = pk.probe_blocks_reference(cl, o, d, c1)
        res, calls = {}, {}
        for name, lib in libs.items():
            calls[name], (t2, s2, t1, s1, dist) = probe_calls(lib, cl, o, d, c1, c2)
            for call in calls[name].values():
                call()
            torch.cuda.synchronize()
            rounds = []
            for k in range(2):
                t_p, s_p = p4[2 * k], p4[2 * k + 1]
                hit_k, hit_p = torch.isfinite(t2[k]), torch.isfinite(t_p)
                both = hit_k & hit_p
                rounds.append(dict(
                    hit_agreement=(hit_k == hit_p).float().mean().item(),
                    max_abs_dt=(t2[k][both] - t_p[both]).abs().max().item() if both.any() else 0.0,
                    t_within_1e5=bool(torch.allclose(t2[k][both], t_p[both], rtol=1e-5,
                                                     atol=1e-5)),
                    sid_agreement=(s2[k] == s_p)[both].float().mean().item() if both.any() else 1.0,
                    hit_rate=hit_p.float().mean().item()))
            fin_k, fin_p = torch.isfinite(dist), torch.isfinite(p7)
            both = fin_k & fin_p
            res[name] = dict(
                k4_rounds=rounds, k5_equals_k4_round1=bool(torch.equal(t1[0], t2[0])),
                k7_finite_agreement=(fin_k == fin_p).float().mean().item(),
                k7_max_abs_dt=(dist[both] - p7[both]).abs().max().item() if both.any() else 0.0,
                k7_min_equals_k5=bool(torch.equal(dist.amin(dim=1), t1[0])))
            if not is_old_probe(lib):
                with use_library(lib):
                    res[name]["launch"] = pk.launch_shape(o.shape[0], 2)
        kernels = ("probe_pair",) if set_name == "flat_path_inputs" else \
            ("probe_pair", "probe_min", "probe_blocks")
        for kernel in kernels:
            ms = {name: [] for name in libs}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    ms[name].append(cs.cuda_ms(calls[name][kernel], 20))
            for name in libs:
                res[name][f"{kernel}_ms"] = ms[name]
        for name in libs:
            cs.log(f"probe {set_name} C={cl.num_clusters} {name}: {json.dumps(res[name])}")
        out[set_name] = res
    return out


def ab_paths(device, libs):
    if is_old_scene(libs["parent"]) or is_old_probe(libs["parent"]):
        raise ValueError("paths: the parent's scene or probe kernels take other "
                         "arguments than this tree's wrappers pass")
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.ops import integrator, trace, wavefront
    h = cs.MESH
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=h["max_bounces"])
    cam = cs.mesh_camera(device)
    scene, flat_prep = cs.mesh70k(device)
    sweep_scene = scenes.mesh_scene(scenes.surface_mesh(188), device)
    sweep_prep = trace.prepare(sweep_scene, use_pallas=True)
    out = {"dense_sweep": [], "flat": []}
    for name in ("parent", "current", "current", "parent"):
        with use_library(libs[name]):
            _, _, rec = cs.run_queue(f"dense-sweep path, {name} kernels",
                                     integrator.render_queue, sweep_prep, sweep_scene,
                                     st, cam, h, device)
            out["dense_sweep"].append(dict(kernels=name, **rec))
            _, _, rec = cs.run_queue(f"flat path, {name} kernels",
                                     wavefront.render_queue_flat, flat_prep, scene, st,
                                     cam, h, device)
            out["flat"].append(dict(kernels=name, **rec))
    return out


def scene_calls(lib, tables, sid_map, code_of, o, d, dist, lsid):
    """(K1 call, K2 call, K1 result): the entry points of ``lib`` launched
    on these inputs (with the arguments of the commit it was built from)
    and K1's (t, shape id) after a call."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    dev, R = o.device, o.shape[0]
    t = torch.empty(R, device=dev)
    occ = torch.empty(R, dtype=torch.bool, device=dev)
    head = (tables.flat.data_ptr(), *tables.counts, o.data_ptr(), d.data_ptr())

    def run(entry, *args):
        rc = entry(*head, *args, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{entry.__name__}: CUDA error {rc}")

    if is_old_scene(lib):
        fam = torch.empty(R, dtype=torch.int32, device=dev)
        slot = torch.empty(R, dtype=torch.int32, device=dev)
        excl = sk._excl_codes(lsid, code_of).contiguous()
        return (lambda: run(lib.wpt_fused_nearest, R, t.data_ptr(), fam.data_ptr(),
                            slot.data_ptr()),
                lambda: run(lib.wpt_fused_occluded, dist.data_ptr(), excl.data_ptr(), R,
                            occ.data_ptr()),
                lambda: (t, sk._sid_of_codes(
                    tables, torch.where(fam >= 0, (fam << sk.SLOT_BITS) | slot, -1),
                    sid_map)), occ)
    sid = torch.empty(R, dtype=torch.int64, device=dev)
    return (lambda: run(lib.wpt_fused_nearest, sid_map.data_ptr(), R, t.data_ptr(),
                        sid.data_ptr()),
            lambda: run(lib.wpt_fused_occluded, dist.data_ptr(), lsid.data_ptr(),
                        code_of.data_ptr(), R, occ.data_ptr()),
            lambda: (t, sid), occ)


def without_family(tables, fam):
    """``tables`` with family ``fam``'s rows taken out."""
    import torch
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    counts = list(tables.counts)
    start = sum(n * k for n, k in zip(counts[:fam], sk.WIDTHS))
    end = start + counts[fam] * sk.WIDTHS[fam]
    counts[fam] = 0
    return sk.SceneTables(torch.cat([tables.flat[:start], tables.flat[end:]]).contiguous(),
                          tuple(counts))


def ab_scene(device, libs):
    import torch
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.ops import scene_kernels as sk
    from wasm_pathtracer_tpu_torch.ops import trace
    scene = scenes.museum(device)
    prep = trace.prepare(scene)
    o1, d1 = (x[:16_384].contiguous() for x in cs.test_rays(16_384 + 37, 100, device))
    o2, d2 = cs.test_rays(16_384 + 37, 200, device)
    shadow = [x[:16_384].contiguous() for x in cs.shadow_rays(prep, scene, o2, d2, 300)[:4]]
    got = cs.headline_inputs(device)
    tables, ho, hd, hsid = got["fused_nearest"]
    sets = {"museum": (prep.tables, prep.sid_of_slot, prep.code_of, (o1, d1), shadow),
            "headline": (tables, hsid, got["fused_occluded"][5], (ho, hd),
                         got["fused_occluded"][1:5])}
    out = {}
    for set_name, (tables, sid_map, code_of, (o, d), (so, sd, dist, lsid)) in sets.items():
        t_p, s_p = sk.fused_nearest_reference(tables, o, d, sid_map)
        occ_p = sk.fused_occluded_reference(tables, so, sd, dist, lsid, code_of)
        res = {name: {} for name in libs}
        k1s, k2s = {}, {}
        for name, lib in libs.items():
            k1, _, k1_out, _ = scene_calls(lib, tables, sid_map, code_of, o, d, dist, lsid)
            _, k2, _, occ = scene_calls(lib, tables, sid_map, code_of, so, sd, dist, lsid)
            k1()
            k2()
            torch.cuda.synchronize()
            t_k, s_k = k1_out()
            both = torch.isfinite(t_k) & torch.isfinite(t_p)
            res[name].update(
                hit_agreement=(torch.isfinite(t_k) == torch.isfinite(t_p)).float().mean().item(),
                max_abs_dt=(t_k[both] - t_p[both]).abs().max().item(),
                sid_agreement=(s_k == s_p)[both].float().mean().item(),
                verdict_agreement=(occ == occ_p).float().mean().item())
            k1s[name], k2s[name] = k1, k2
        for kernel, calls in (("k1_ms", k1s), ("k2_ms", k2s)):
            ms = {name: [] for name in libs}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    ms[name].append(cs.cuda_ms(calls[name], 50))
            for name in libs:
                res[name][kernel] = ms[name]
        if set_name == "museum":
            # a family's share: the museum rays with its count set to 0, or
            # every other family's; and with no primitive at all (what
            # launching, staging nothing and writing the rays' results takes)
            present = [f for f in range(6) if tables.counts[f]]
            cuts = {}
            for fam in present:
                cuts[f"without {sk.FAMILIES[fam]}"] = without_family(tables, fam)
                only = tables
                for other in present:
                    if other != fam:
                        only = without_family(only, other)
                cuts[f"only {sk.FAMILIES[fam]}"] = only
            cuts["nothing"] = sk.SceneTables(tables.flat[:0], (0,) * 6)
            for name, lib in libs.items():
                split = {}
                for label, cut in cuts.items():
                    k1, _, _, _ = scene_calls(lib, cut, sid_map, code_of, o, d, dist, lsid)
                    _, k2, _, _ = scene_calls(lib, cut, sid_map, code_of, so, sd, dist, lsid)
                    split[label] = [cs.cuda_ms(k1, 50), cs.cuda_ms(k2, 50)]
                res[name]["k1_k2_ms_family_split"] = split
        for name in libs:
            cs.log(f"scene {set_name} {name}: {json.dumps(res[name])}")
        out[set_name] = res
    return out


PARTS = {"scene": ab_scene, "k8": ab_k8, "select": ab_select, "probe": ab_probe,
         "paths": ab_paths}


def sass_report(libs):
    """Instruction counts and loops of K1, K2, K8 and the probe kernels in
    each library's machine code, and a hash of K8's instruction stream."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    func = re.compile(r"^\s*Function : (\S+)")
    instr = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
    target = re.compile(r"\bBRA\S*\s+(?:`\()?(0x[0-9a-f]+)")
    wanted = ("fused_nearest_kernel", "fused_occluded_kernel", "dense_tri_kernel",
              "probe_kernel")
    out = {}
    for name, lib in libs.items():
        text = subprocess.run([cuobjdump, "-sass", str(lib.path)], capture_output=True,
                              text=True, check=True).stdout
        fns, cur = {}, None
        for line in text.splitlines():
            m = func.match(line)
            if m:
                cur = fns.setdefault(m.group(1), {"code": [], "at": {}})
                continue
            m = instr.match(line) if cur is not None else None
            if m:
                cur["at"][int(m.group(1), 16)] = len(cur["code"])
                cur["code"].append(m.group(2))
        rep = {}
        for fn, body in fns.items():
            short = next((w for w in wanted if w in fn), None)
            if short is None:
                continue
            code = body["code"]
            ops = [re.sub(r"^@!?U?P\w+\s+", "", c).split()[0] for c in code]
            loops = []
            for i, c in enumerate(code):
                m = target.search(c)
                start = body["at"].get(int(m.group(1), 16)) if m else None
                if start is not None and start <= i:
                    hist = {}
                    for op in ops[start:i + 1]:
                        hist[op] = hist.get(op, 0) + 1
                    top = sorted(hist.items(), key=lambda kv: -kv[1])[:8]
                    loops.append(dict(first=start, last=i, instructions=i + 1 - start,
                                      top=top))
            entry = dict(function=fn, instructions=len(code),
                         loops=[lp for lp in loops if lp["instructions"] >= 8])
            if short == "dense_tri_kernel":
                entry["sha256"] = hashlib.sha256("\n".join(code).encode()).hexdigest()[:16]
            rep.setdefault(short, []).append(entry)
        for short, entries in rep.items():
            for e in entries:
                cs.log(f"sass {name} {short}: {json.dumps(e)}")
        out[name] = rep
    return out


def kernels_per_iteration(device):
    """Device kernels per loop iteration of the museum headline loop, from
    a profiled run of S = 131,072 after a warm-up run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import initial_camera
    from wasm_pathtracer_tpu_torch.ops import integrator, trace
    h = cs.HEADLINE
    scene = scenes.museum(device)
    prep = trace.prepare(scene)
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=h["max_bounces"])
    cam = initial_camera(0, device)
    pix = cs.headline_queue(device, 8 * h["B"])

    def run():
        return integrator.render_queue(prep, scene, st, cam, pix, h["width"], h["height"],
                                       3, h["B"], return_iters=True)[3]

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        iters = run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    per = len(names) / iters
    cs.log(f"kernels per iteration ({cs.__file__}): {per:.2f} ({len(names)} device "
           f"events in {iters} iterations)")
    return dict(kernels_per_iteration=per, device_events=len(names), iterations=iters)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="csrc directory of the commit to compare with")
    ap.add_argument("--variant", nargs="*", default=[],
                    help="NAME:CONST=VALUE,... copies of this tree's csrc to time too")
    ap.add_argument("--extra", nargs="*", default=[],
                    help="NAME=DIR: other csrc directories to time too")
    ap.add_argument("--only", nargs="+", choices=list(PARTS), default=list(PARTS))
    ap.add_argument("--sass", action="store_true",
                    help="report K1, K2, K8 and the probes' machine code")
    ap.add_argument("--kernels-per-iteration", action="store_true",
                    help="only count the headline loop's device kernels per iteration")
    ap.add_argument("--out", default=str(ROOT / "build" / "kernel_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = cs.card_line()
    cs.log(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {card}")
    record = {"card": card}
    if args.kernels_per_iteration:
        record["kernels_per_iteration"] = kernels_per_iteration(device)
    else:
        if not args.parent:
            ap.error("--parent is needed")
        libs = build_all(args.parent, args.variant, args.extra)
        if args.sass:
            record["sass"] = sass_report(libs)
        for part in args.only:
            record[part] = PARTS[part](device, libs)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    cs.log(f"wrote {out}; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
