"""The precisions the reference computes in: float32, as the
configurations state, and bfloat16 for the control (the nearest
precision below float32 for a program without matrix products).  In
bfloat16 the scene's tables and every carried ray, distance, throughput
and radiance are rounded to bfloat16 after each step; the arithmetic in
between runs in float32."""

from __future__ import annotations

import torch


def identity(x):
    return x


def bfloat16(x):
    if not torch.is_floating_point(x):
        return x
    return x.to(torch.bfloat16).to(x.dtype)


QUANT = {"float32": identity, "bfloat16": bfloat16}


def quantize_scene(scene, quant):
    """``scene`` with its geometry and material tables rounded."""
    return scene.replace(params=quant(scene.params), albedo=quant(scene.albedo),
                         emission=quant(scene.emission))
