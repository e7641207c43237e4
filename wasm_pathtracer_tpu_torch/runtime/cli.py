"""Command-line renderer (``wasm_pathtracer_tpu.runtime.cli``).

Renders a fixed number of paths through a :class:`Session` and writes a
PNG; ``--bench`` prints a JSON throughput line.  The device defaults to
CUDA, and asking for it without a card is an error.

Usage:
  python -m wasm_pathtracer_tpu_torch.runtime.cli --scene 0 \
      --width 512 --height 512 --ticks 262144 --out frame.png
"""

from __future__ import annotations

import argparse
import json
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", type=int, default=0,
                   help="scene id (0=museum, 2=bunny, 3/4/5=100/10k/100k-"
                        "triangle cloud, 100=sphere+plane, 101=whitted)")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--left-type", type=int, default=1, choices=[0, 1],
                   help="left-half estimator (0=NoNEE, 1=NEE)")
    p.add_argument("--right-type", type=int, default=1, choices=[0, 1],
                   help="right-half estimator (0=NoNEE, 1=NEE)")
    p.add_argument("--max-bounces", type=int, default=16)
    p.add_argument("--batch", type=int, default=None,
                   help="paths per session step (default 32768)")
    p.add_argument("--lanes", type=int, default=None,
                   help="persistent-wavefront lane count")
    p.add_argument("--ticks", type=int, default=65536,
                   help="paths to trace, split between the halves")
    p.add_argument("--obj", type=str, default=None,
                   help="OBJ mesh to upload as mesh id 1 (the bunny slot)")
    p.add_argument("--out", type=str, default=None, help="output PNG path")
    p.add_argument("--bench", action="store_true",
                   help="print a JSON throughput report")
    p.add_argument("--camera", type=float, nargs=5, default=None,
                   metavar=("X", "Y", "Z", "RX", "RY"))
    p.add_argument("--seed", type=int, default=0xBABABEBE)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (default cuda)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models.camera import Camera
    from wasm_pathtracer_tpu_torch.runtime.session import Session
    from wasm_pathtracer_tpu_torch.utils.png import write_png

    # viewport clamped like the JAX CLI
    width = min(max(args.width, 128), 1920)
    height = min(max(args.height, 128), 1920)

    def settings(rt):
        kw = {}
        if args.batch:
            kw["ray_batch_size"] = args.batch
        if args.lanes:
            kw["regen_lanes"] = args.lanes
        return RenderSettings(render_type=RenderType(rt),
                              max_bounces=args.max_bounces, **kw)

    camera = Camera.create(args.camera[:3], args.camera[3],
                           args.camera[4]) if args.camera else None
    sess = Session(width, height, args.scene, camera=camera,
                   left=settings(args.left_type),
                   right=settings(args.right_type),
                   seed=args.seed, device=args.device)
    if args.obj:
        from wasm_pathtracer_tpu_torch.utils.obj import load_obj
        # the client's preparation of its bunny: scale x8, flip z
        sess.store_mesh(1, load_obj(args.obj, scale=8.0, flip_z=True))

    def sync():
        if sess.device.type == "cuda":
            torch.cuda.synchronize(sess.device)

    if args.bench:
        # build the kernels and warm the allocator before timing
        sess.compute(2)
        sync()
        sess.reset()
    t0 = time.perf_counter()
    traced = sess.compute(args.ticks)
    sync()
    dt = time.perf_counter() - t0

    if args.bench:
        kind = (torch.cuda.get_device_name(sess.device)
                if sess.device.type == "cuda" else "cpu")
        print(json.dumps({
            "metric": "paths_per_sec",
            "value": traced / dt,
            "unit": "paths/s",
            "device": kind,
            "bvh_visits": sess.num_bvh_hits,
            "paths": traced,
            "seconds": dt,
        }))

    if args.out:
        write_png(args.out, sess.results())
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
