"""Inverse rendering demo: recover scene materials from a target image
(the counterpart of the JAX package's ``examples/inverse_render.py``).

Renders a target of ``sphere_plane`` with the true materials, perturbs
the diffuse albedos, then descends back with the sharded train step
(``parallel.make_train_step``: gradients summed over the ray mesh, here
the one-member mesh of this process).  Succeeds (exit 0) when the
largest diffuse albedo error falls below 0.8x its start.

Run:  python -m wasm_pathtracer_tpu_torch.examples.inverse_render
      [--steps 40] [--size 48] [--lr 0.8] [--out strip.png] [--device cpu]

The device defaults to the card; ``--device cpu`` renders through the
kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--size", type=int, default=48)
    p.add_argument("--lr", type=float, default=0.8)
    p.add_argument("--out", type=str, default=None,
                   help="write before/after/target PNG strip")
    p.add_argument("--device", type=str, default=None,
                   help="torch device to render on (default: the card)")
    args = p.parse_args(argv)

    from wasm_pathtracer_tpu_torch.config import RenderSettings, RenderType
    from wasm_pathtracer_tpu_torch.models import scenes
    from wasm_pathtracer_tpu_torch.models.camera import Camera
    from wasm_pathtracer_tpu_torch.models.scene import MatKind
    from wasm_pathtracer_tpu_torch.ops import trace
    from wasm_pathtracer_tpu_torch.parallel import (
        make_ray_mesh, make_train_step, render_image_sharded)

    scene = scenes.sphere_plane(device=args.device)
    prep = trace.prepare(scene)
    st = RenderSettings(render_type=RenderType.NORMAL_NEE, max_bounces=5,
                        early_exit=False)
    cam = Camera.create((0.0, 1.5, -2.0), 0.25, 0.0, device=args.device)
    W = H = args.size
    mesh = make_ray_mesh(device=args.device)

    print(f"devices: {mesh.size} ({mesh.device}); target render...")
    with torch.no_grad():
        target = render_image_sharded(mesh, prep, scene, st, cam, W, H, 1000, spp=8)

    # perturb the DIFFUSE albedos (emissive shapes never read their
    # albedo row, so it receives no gradient: keep it fixed and measure
    # only the rows that matter)
    diffuse_rows = (scene.mat_kind == int(MatKind.DIFFUSE))[:, None]
    shift = torch.tensor([[0.15, -0.3, 0.25]], dtype=torch.float32, device=mesh.device)
    wrong_albedo = torch.clamp(scene.albedo + torch.where(diffuse_rows, shift, 0.0), 0, 1)
    cur = scene.with_materials(albedo=wrong_albedo)

    def albedo_err(s):
        return float(torch.where(diffuse_rows, s.albedo - scene.albedo, 0.0).abs().max())

    init_err = albedo_err(cur)
    with torch.no_grad():
        before = render_image_sharded(mesh, prep, cur, st, cam, W, H, 2000, spp=4)

    step = make_train_step(mesh, prep, st, W, H, lr=args.lr, spp=4)
    cc = cam
    for i in range(args.steps):
        loss, cur, cc = step(cur, cc, target, 3000 + i)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {float(loss):.5f}  "
                  f"max albedo err {albedo_err(cur):.3f}")

    with torch.no_grad():
        after = render_image_sharded(mesh, prep, cur, st, cam, W, H, 4000, spp=4)
    final_err = albedo_err(cur)
    print(f"max albedo error: {init_err:.3f} -> {final_err:.3f}")

    if args.out:
        from wasm_pathtracer_tpu_torch.utils.png import tonemap_u8, write_png
        strip = np.concatenate([before.cpu().numpy(), after.cpu().numpy(),
                                target.cpu().numpy()], axis=1)
        write_png(args.out, tonemap_u8(strip))
        print(f"wrote {args.out} (before | after | target)")

    # success: materially recovered toward the truth (full recovery
    # needs more steps than a demo budget)
    return 0 if final_err < 0.8 * init_err else 1


if __name__ == "__main__":
    sys.exit(main())
