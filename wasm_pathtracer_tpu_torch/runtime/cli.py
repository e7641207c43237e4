"""Command-line renderer (``wasm_pathtracer_tpu.runtime.cli``).

Renders through a :class:`Session` for ``--seconds`` of wall time (in
steps auto-tuned by the :class:`Driver`) or for exactly ``--ticks``
paths, and writes a PNG; ``--bench`` prints a JSON throughput line.
Each half takes its own estimator (0 = no NEE, 1 = NEE, 2 = photon-guided
NEE) and may sample adaptively; ``--show-sampling`` writes the
sampling-density view, ``--light-debug`` the light-selection render,
``--debug-view`` one depth or trace-cost frame of primary rays, and
``--whitted DEPTH`` one deterministic Whitted frame.  ``--checkpoint``
saves the render state at the end and ``--resume`` restores it first
(the JAX package's file format).  The device defaults to CUDA, and
asking for it without a card is an error.

``--ranks N`` renders the session over N processes of this host, one a
card (``parallel.distributed.launch``): every rank holds the whole
session and traces its shard of each batch (``--batch`` paths, so a
half's batch is N x ``--batch``), the frame sums are all-reduced, and
rank 0 alone writes the PNG, the bench line and the checkpoint.  A rank
that fails stops every rank.

Usage:
  python -m wasm_pathtracer_tpu_torch.runtime.cli --scene 0 \
      --width 512 --height 512 --ticks 262144 --out frame.png
  python -m wasm_pathtracer_tpu_torch.runtime.cli --scene 0 --ranks 4 \
      --right-type 2 --right-adaptive --seconds 10 --bench --out frame.png
  python -m wasm_pathtracer_tpu_torch.runtime.cli --scene 101 --whitted 4 \
      --out whitted.png
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", type=int, default=0,
                   help="scene id (0=museum, 2=bunny, 3/4/5=100/10k/100k-"
                        "triangle cloud, 100=sphere+plane, 101=whitted)")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--left-type", type=int, default=1, choices=[0, 1, 2],
                   help="left-half estimator (0=NoNEE, 1=NEE, 2=PNEE)")
    p.add_argument("--right-type", type=int, default=1, choices=[0, 1, 2],
                   help="right-half estimator (0=NoNEE, 1=NEE, 2=PNEE)")
    p.add_argument("--left-adaptive", action="store_true")
    p.add_argument("--right-adaptive", action="store_true")
    p.add_argument("--light-debug", action="store_true",
                   help="NEE adds the picked light's unshadowed intensity")
    p.add_argument("--show-sampling", action="store_true",
                   help="write the sampling-density view instead of colour")
    p.add_argument("--debug-view", choices=["depth", "bvh"], default=None,
                   help="render one depth / trace-cost false-colour frame")
    p.add_argument("--max-bounces", type=int, default=16)
    p.add_argument("--batch", type=int, default=None,
                   help="paths per session step (default 32768)")
    p.add_argument("--lanes", type=int, default=None,
                   help="persistent-wavefront lane count")
    p.add_argument("--seconds", type=float, default=5.0,
                   help="wall-clock budget of the render")
    p.add_argument("--ticks", type=int, default=None,
                   help="exact path budget, split between the halves "
                        "(overrides --seconds)")
    p.add_argument("--whitted", type=int, default=None, metavar="DEPTH",
                   help="render one deterministic Whitted frame at this "
                        "recursion depth instead of path tracing")
    p.add_argument("--obj", type=str, default=None,
                   help="OBJ mesh to upload as mesh id 1 (the bunny slot)")
    p.add_argument("--out", type=str, default=None, help="output PNG path")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="save the render state here at the end (.npz)")
    p.add_argument("--resume", type=str, default=None,
                   help="restore the render state from this file first")
    p.add_argument("--bench", action="store_true",
                   help="print a JSON throughput report")
    p.add_argument("--camera", type=float, nargs=5, default=None,
                   metavar=("X", "Y", "Z", "RX", "RY"))
    p.add_argument("--seed", type=int, default=0xBABABEBE)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (default cuda)")
    p.add_argument("--ranks", type=int, default=1,
                   help="processes to render the session over, one a card "
                        "(NCCL; gloo with --device cpu)")
    return p


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.ranks > 1:
        if args.debug_view is not None or args.whitted is not None:
            parser.error("--ranks renders a session; --debug-view and --whitted "
                         "render on one device")
        from wasm_pathtracer_tpu_torch.parallel.distributed import launch
        launch(_rank_main, args.ranks, args=(argv,), device=args.device)
        return
    _render(args)


def _rank_main(mesh, argv):
    """One rank of ``--ranks``: the session over ``mesh``."""
    _render(build_parser().parse_args(argv), mesh)


def _render(args, mesh=None):
    import torch

    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models.camera import Camera
    from wasm_pathtracer_tpu_torch.runtime import checkpoint
    from wasm_pathtracer_tpu_torch.runtime.driver import Driver
    from wasm_pathtracer_tpu_torch.runtime.session import Session
    from wasm_pathtracer_tpu_torch.utils.png import write_png

    # viewport clamped like the JAX CLI
    width = min(max(args.width, 128), 1920)
    height = min(max(args.height, 128), 1920)

    def settings(rt, adaptive):
        kw = {}
        if args.batch:
            kw["ray_batch_size"] = args.batch
        if args.lanes:
            kw["regen_lanes"] = args.lanes
        return RenderSettings(render_type=RenderType(rt), adaptive=adaptive,
                              is_debug_photons=args.light_debug,
                              max_bounces=args.max_bounces, **kw)

    camera = Camera.create(args.camera[:3], args.camera[3], args.camera[4],
                           device=args.device) if args.camera else None
    sess = Session(width, height, args.scene, camera=camera,
                   left=settings(args.left_type, args.left_adaptive),
                   right=settings(args.right_type, args.right_adaptive),
                   seed=args.seed, device=args.device if mesh is None else None,
                   mesh=mesh)
    # rank 0 writes what the run leaves behind
    writes = mesh is None or mesh.rank == 0
    if args.obj:
        from wasm_pathtracer_tpu_torch.utils.obj import load_obj
        # the client's preparation of its bunny: scale x8, flip z
        sess.store_mesh(1, load_obj(args.obj, scale=8.0, flip_z=True))

    if args.resume:
        checkpoint.load(args.resume, sess)

    if args.debug_view is not None:
        from wasm_pathtracer_tpu_torch.models.camera import primary_rays
        from wasm_pathtracer_tpu_torch.ops import accum, integrator
        from wasm_pathtracer_tpu_torch.utils.png import tonemap_u8
        pix = torch.arange(width * height, device=sess.device)
        half = torch.full(pix.shape, 0.5, device=sess.device)
        o, d = primary_rays(sess.camera, pix % width, pix // width, half, half,
                            width, height)
        if args.debug_view == "depth":
            t, _ = integrator.trace_depth(sess.prep, sess.scene, o, d)
            img = accum.depth_image(t.reshape(height, width))
        else:
            cost = integrator.trace_bvh_cost(sess.prep, sess.scene, o, d)
            c = cost.reshape(height, width).to(torch.float32)
            img = accum.mix_color(c / torch.clamp(c.max(), min=1.0))
        if args.out:
            write_png(args.out, tonemap_u8(img.cpu().numpy()))
            print(f"wrote {args.out}")
        return

    if args.whitted is not None:
        from wasm_pathtracer_tpu_torch.ops import whitted
        from wasm_pathtracer_tpu_torch.utils.png import tonemap_u8
        pix = torch.arange(width * height, device=sess.device)
        with torch.no_grad():
            img = whitted.render_whitted(sess.prep, sess.scene, sess.left.settings,
                                         sess.camera, pix % width, pix // width,
                                         width, height, depth=args.whitted)
        if args.out:
            write_png(args.out, tonemap_u8(img.reshape(height, width, 3).cpu().numpy()))
            print(f"wrote {args.out}")
        return

    def sync():
        if sess.device.type == "cuda":
            torch.cuda.synchronize(sess.device)

    if args.bench:
        # build the kernels and warm the allocator before timing
        sess.compute(2)
        sync()
        if args.resume:
            checkpoint.load(args.resume, sess)
        else:
            sess.reset()
    t0 = time.perf_counter()
    if args.ticks is not None:
        traced = sess.compute(args.ticks)
    elif mesh is None:
        drv = Driver(sess)
        drv.run(seconds=args.seconds)
        traced = drv.total_ticks
    else:
        # one batch a half a step, until rank 0's clock says stop: every
        # rank makes the same steps, so the collectives pair up
        from wasm_pathtracer_tpu_torch.parallel.distributed import rank0_decides
        step = sess.left.settings.ray_batch_size + sess.right.settings.ray_batch_size
        traced = 0
        while rank0_decides(traced == 0 or time.perf_counter() - t0 < args.seconds):
            traced += sess.compute(step * mesh.size)
    sync()
    dt = time.perf_counter() - t0
    if not writes:
        return

    if args.bench:
        kind = (torch.cuda.get_device_name(sess.device)
                if sess.device.type == "cuda" else "cpu")
        print(json.dumps({
            "metric": "paths_per_sec",
            "value": traced / dt,
            "unit": "paths/s",
            "device": kind,
            "bvh_visits": sess.num_bvh_hits,
            "queue_iters": sess.num_queue_iters,
            "ranks": 1 if mesh is None else mesh.size,
            "paths": traced,
            "seconds": dt,
        }))

    if args.out:
        write_png(args.out, sess.results(show_sampling=args.show_sampling))
        print(f"wrote {args.out}")

    if args.checkpoint:
        checkpoint.save(args.checkpoint, sess)
        print(f"checkpointed to {args.checkpoint}")


if __name__ == "__main__":
    main()
