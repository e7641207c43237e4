#!/usr/bin/env python3
"""Time the port's dense sweep (K8) and cluster selects (K3, K6) as an
older commit had them against the kernels of this tree, on one NVIDIA GPU,
inside one process.

    python3 scripts/kernel_ab.py --parent DIR [--only k8|select|paths ...]
                                 [--out FILE]

``DIR`` is the older commit's ``csrc`` directory (for example ``git archive
<commit> wasm_pathtracer_tpu_torch/csrc | tar -x -C build/parent``).  Both
libraries are built here and the package's wrappers launch one or the
other, so that the two commits are compared under one clock, one timer and
one card state.

- ``k8``: ``dense_tri_nearest`` on mesh70k (70,314 triangles) and cloud300k
  (300,002), 16,384 rays of ``chip_smoke.py``'s phase ``k8``: agreement
  with the plain version (hits, max |dt|, slots) and device ms, in two
  rounds, the second in reverse order.
- ``select``: ``select_blocks`` and ``select_scan`` at C = 550 (mesh70k)
  and C = 2,344 (cloud300k): entries equal to the plain version bit for
  bit, ids equal where finite, device ms in two rounds.
- ``paths``: mesh70k at full width (512x512, NEE, 8 bounces, S = 524,288,
  B = 16,384) through the dense-sweep loop and the flat wavefront, in the
  order parent, current, current, parent: paths/s by the host clock.

Device ms are ``chip_smoke.cuda_ms``: CUDA events around a CUDA graph that
holds the call 5 (K8) or 20 (selects) times, per call (a K8 call is its
memset, sweep and unpack kernels).  Results go to standard output and, as
JSON, to ``--out`` (``build/kernel_ab.json``).  Needs a GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def build_both(parent):
    """{"parent": library of the sources in ``parent``, "current": the
    package's own}.  The parent's is built by the package's ``build()``
    pointed at the other directory, and loaded with the entry points it
    has (an older ``csrc`` may lack some)."""
    from wasm_pathtracer_tpu_torch.ops import _build
    own = _build.CSRC
    _build.CSRC = pathlib.Path(parent).resolve()
    try:
        old = ctypes.CDLL(str(_build.build()))
    finally:
        _build.CSRC = own
    for name, argtypes in _build._SIGNATURES.items():
        fn = getattr(old, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return {"parent": old, "current": _build.library()}


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


def ab_paths(device, libs):
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


PARTS = {"k8": ab_k8, "select": ab_select, "paths": ab_paths}


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="csrc directory of the commit to compare with")
    ap.add_argument("--only", nargs="+", choices=list(PARTS), default=list(PARTS))
    ap.add_argument("--out", default=str(ROOT / "build" / "kernel_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = cs.card_line()
    cs.log(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {card}")
    record = {"card": card}
    libs = build_both(args.parent)
    for part in args.only:
        record[part] = PARTS[part](device, libs)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    cs.log(f"wrote {out}; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
