"""Built-in scenes (``wasm_pathtracer_tpu.models.scenes``).

- id 0: museum — ground plane, 27 tori, 108 emissive light triangles
  (colours shuffled per row with the reference RNG stream), AARect walls.
- id 100: sphere + plane.
- id 101: whitted — textured floor square, a refractive and a reflective
  sphere, sky background.

The mesh and triangle-cloud scenes (ids 1-5) render through the cluster
structure, which arrives with the port's mesh slice.
"""

from __future__ import annotations

import numpy as np

from wasm_pathtracer_tpu_torch.models.scene import Material, SceneBuilder, SceneData
from wasm_pathtracer_tpu_torch.utils.rng import Xorshift32


def museum(device="cpu") -> SceneData:
    b = SceneBuilder(background=(0.0, 0.0, 0.0))
    b.add_plane((0.0, -1.0, 0.0), (0.0, 1.0, 0.0), Material.diffuse(0.7, 0.7, 0.7))

    xs = [-16.0, -12.0, -8.0, -4.0, 0.0, 4.0, 8.0, 12.0, 16.0]
    colors = [
        (1.0, 0.3, 0.3),
        (0.0, 1.0, 1.0), (0.3, 0.3, 1.0), (1.0, 0.0, 0.0),
        (0.0, 1.0, 0.0),
        (0.0, 0.0, 1.0), (1.0, 0.0, 1.0), (1.0, 1.0, 0.0),
        (0.3, 1.0, 0.3),
    ]

    # the reference advances its xorshift twice before shuffling, then
    # shuffles the colour list after each row
    rng = Xorshift32()
    rng.next()
    rng.next()

    for y in (-7.5, 0.0, 7.5):
        for i, x in enumerate(xs):
            b.add_torus((x, -0.5, y), 1.3, 0.3, Material.diffuse(1.0, 1.0, 1.0))
            _museum_lights(b, x, y, tuple(2.5 * c for c in colors[i]))
        rng.shuffle(colors)

    for x in (-14.0, -10.0, -6.0, -2.0, 2.0, 6.0, 10.0, 14.0):
        b.add_aarect(x - 0.1, x + 0.1, -1.0, 2.0, -20.0, 20.0,
                     Material.diffuse(0.7, 0.7, 0.7))
    b.add_aarect(-20.0, 20.0, -1.0, 2.0, 3.75 - 0.1, 3.75 + 0.1,
                 Material.diffuse(0.7, 0.7, 0.7))
    b.add_aarect(-20.0, 20.0, -1.0, 2.0, -3.75 - 0.1, -3.75 + 0.1,
                 Material.diffuse(0.7, 0.7, 0.7))
    return b.build(device)


def _museum_lights(b: SceneBuilder, x: float, y: float, color: tuple):
    """Two 2-triangle area lights per torus."""
    m = Material.emissive(*color)
    for dz in (2.8, -2.8):
        z_near = y + dz
        z_far = y + (2.5 if dz > 0 else -2.5)
        lc1 = (x - 1.0, 0.0, z_near)
        lc2 = (x + 1.0, 0.0, z_near)
        lc3 = (x + 1.0, 1.0, z_far)
        lc4 = (x - 1.0, 1.0, z_far)
        b.add_triangle(lc3, lc2, lc1, m)
        b.add_triangle(lc4, lc3, lc1, m)


def sphere_plane(device="cpu") -> SceneData:
    b = SceneBuilder(background=(0.1, 0.1, 0.1))
    b.add_plane((0.0, -1.0, 0.0), (0.0, 1.0, 0.0), Material.diffuse(0.8, 0.8, 0.8))
    b.add_sphere((0.0, 0.0, 5.0), 1.0, Material.diffuse(0.8, 0.2, 0.2))
    light = Material.emissive(8.0, 8.0, 8.0)
    b.add_triangle((1.0, 4.0, 6.0), (1.0, 4.0, 4.0), (-1.0, 4.0, 4.0), light)
    b.add_triangle((-1.0, 4.0, 6.0), (1.0, 4.0, 6.0), (-1.0, 4.0, 4.0), light)
    return b.build(device)


def whitted(textures: dict | None = None, device="cpu") -> SceneData:
    b = SceneBuilder(background=(135.0 / 255.0, 206.0 / 255.0, 250.0 / 255.0))
    if textures and 0 in textures:
        tex_id = b.add_texture(textures[0])
    else:
        tex_id = b.add_texture(checker_texture())
    b.add_square((0.0, -1.0, 4.0), 8.0, Material.diffuse(1.0, 1.0, 1.0,
                                                         texture_id=tex_id))
    b.add_sphere((-1.3, 1.0, -0.2), 0.7, Material.refract((0.5, 1.0, 0.5), 1.02))
    b.add_sphere((-0.4, 0.0, 1.0), 0.6, Material.reflect(1.0, 1.0, 1.0, 0.3))
    # an area light overhead so the path tracer has something to sample
    light = Material.emissive(10.0, 10.0, 10.0)
    b.add_triangle((1.0, 6.0, -2.0), (1.0, 6.0, -4.0), (-1.0, 6.0, -4.0), light)
    b.add_triangle((-1.0, 6.0, -2.0), (1.0, 6.0, -2.0), (-1.0, 6.0, -4.0), light)
    return b.build(device)


def checker_texture(n: int = 16) -> np.ndarray:
    """16x16 red/yellow checkerboard."""
    t = np.zeros((n, n, 3), np.float32)
    yy, xx = np.mgrid[0:n, 0:n]
    red = (xx + yy) % 2 == 0
    t[red] = (1.0, 0.0, 0.0)
    t[~red] = (1.0, 1.0, 0.0)
    return t


_MESH_SCENES = (1, 2, 3, 4, 5)


def select_scene(scene_id: int, textures: dict | None = None,
                 device="cpu") -> SceneData:
    """Scene registry: ids 0, 100 and 101."""
    if scene_id == 0:
        return museum(device)
    if scene_id == 100:
        return sphere_plane(device)
    if scene_id == 101:
        return whitted(textures, device)
    if scene_id in _MESH_SCENES:
        raise NotImplementedError(
            f"scene {scene_id} is a mesh/cloud scene; it renders through "
            "the cluster structure, which comes with the mesh slice of the "
            "port")
    raise ValueError(f"Invalid scene {scene_id}")
