"""Built-in scenes (``wasm_pathtracer_tpu.models.scenes``).

- id 0: museum — ground plane, 27 tori, 108 emissive light triangles
  (colours shuffled per row with the reference RNG stream), AARect walls.
- id 2: bunny — two planes, an uploaded triangle mesh (mesh id 1) and a
  two-triangle area light.
- ids 3 / 4 / 5: triangle clouds of 100 / 10k / 100k triangles (or an
  uploaded mesh under mesh id 2 / 3 / 4) over a plane, with an area
  light.
- id 100: sphere + plane.
- id 101: whitted — textured floor square, a refractive and a reflective
  sphere, sky background.

Mesh-dependent scenes take a mesh registry dict (mesh id -> (T, 3, 3)
float32 vertices).  Large meshes render through the cluster structure
(``ops.bvh.attach_clusters``).  Every builder puts its tables on the
card unless ``device`` says otherwise (``utils.device.resolve_device``).
"""

from __future__ import annotations

import numpy as np

from wasm_pathtracer_tpu_torch.models.scene import Material, SceneBuilder, SceneData
from wasm_pathtracer_tpu_torch.utils.device import resolve_device
from wasm_pathtracer_tpu_torch.utils.rng import Xorshift32


def museum(device=None) -> SceneData:
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


def sphere_plane(device=None) -> SceneData:
    b = SceneBuilder(background=(0.1, 0.1, 0.1))
    b.add_plane((0.0, -1.0, 0.0), (0.0, 1.0, 0.0), Material.diffuse(0.8, 0.8, 0.8))
    b.add_sphere((0.0, 0.0, 5.0), 1.0, Material.diffuse(0.8, 0.2, 0.2))
    light = Material.emissive(8.0, 8.0, 8.0)
    b.add_triangle((1.0, 4.0, 6.0), (1.0, 4.0, 4.0), (-1.0, 4.0, 4.0), light)
    b.add_triangle((-1.0, 4.0, 6.0), (1.0, 4.0, 6.0), (-1.0, 4.0, 4.0), light)
    return b.build(device)


def whitted(textures: dict | None = None, device=None) -> SceneData:
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


# mesh ids of the reference client: BUNNY_LOW=0, BUNNY_HIGH=1,
# CLOUD_100=2, CLOUD_10K=3, CLOUD_100K=4
MESH_BUNNY_HIGH = 1
MESH_CLOUD_100 = 2
MESH_CLOUD_10K = 3
MESH_CLOUD_100K = 4

# the mesh-upload transform: x0.5 scale, +5 z
_UPLOAD_SCALE = np.float32(0.5)
_UPLOAD_SHIFT = np.array([0.0, 0.0, 5.0], np.float32)


def bunny_high(meshes: dict | None = None, device=None) -> SceneData:
    """Two planes, the uploaded high-poly bunny (mesh id 1) if any, and a
    two-triangle area light."""
    b = SceneBuilder(background=(0.0, 0.0, 0.0))
    b.add_plane((0.0, -1.0, 0.0), (0.0, 1.0, 0.0), Material.diffuse(1.0, 1.0, 1.0))
    b.add_plane((0.0, 0.0, 13.0), (0.0, 0.0, -1.0), Material.diffuse(0.8, 1.0, 0.8))
    if meshes and MESH_BUNNY_HIGH in meshes:
        tris = np.asarray(meshes[MESH_BUNNY_HIGH], np.float32) * _UPLOAD_SCALE
        b.add_triangles(tris + _UPLOAD_SHIFT, Material.diffuse(1.0, 0.4, 0.4))
    light = Material.emissive(16.0, 16.0, 16.0)
    lc1 = (-1.0, 7.0, 0.0)
    lc2 = (1.0, 7.0, 0.0)
    lc3 = (1.0, 7.0, 2.0)
    lc4 = (-1.0, 7.0, 2.0)
    b.add_triangle(lc3, lc2, lc1, light)
    b.add_triangle(lc4, lc3, lc1, light)
    return b.build(device)


def cloud(n: int, meshes: dict | None = None, mesh_id: int | None = None,
          device=None) -> SceneData:
    """Triangle-cloud scene: :func:`triangle_cloud` of ``n`` triangles,
    or the mesh uploaded under ``mesh_id``, over a plane."""
    b = SceneBuilder(background=(0.02, 0.02, 0.04))
    b.add_plane((0.0, -3.0, 0.0), (0.0, 1.0, 0.0),
                Material.diffuse(0.8, 0.8, 0.8))
    if meshes and mesh_id is not None and mesh_id in meshes:
        tris = np.asarray(meshes[mesh_id], np.float32) * _UPLOAD_SCALE
    else:
        tris = triangle_cloud(n) * _UPLOAD_SCALE
    b.add_triangles(tris + _UPLOAD_SHIFT, Material.diffuse(0.75, 0.55, 0.35))
    light = Material.emissive(14.0, 14.0, 14.0)
    b.add_triangle((2.0, 7.0, 4.5), (2.0, 7.0, 0.5), (-2.0, 7.0, 0.5), light)
    b.add_triangle((-2.0, 7.0, 4.5), (2.0, 7.0, 4.5), (-2.0, 7.0, 0.5), light)
    return b.build(device)


def surface_mesh(n: int) -> np.ndarray:
    """Deformed-sphere surface mesh of 2 * n * (n - 1) triangles, the
    bunny-class stand-in; n = 188 gives 70,312."""
    th = np.linspace(0.15, np.pi - 0.15, n)
    ph = np.linspace(0, 2 * np.pi, n, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    r = 1.5 + 0.35 * np.sin(6 * T) * np.cos(5 * P) + 0.15 * np.cos(9 * P)
    V = np.stack([r * np.sin(T) * np.cos(P), r * np.cos(T),
                  r * np.sin(T) * np.sin(P)], -1).astype(np.float32)
    tris = []
    for i in range(n - 1):
        j = np.arange(n)
        j2 = (j + 1) % n
        a, b_, c, d = V[i, j], V[i, j2], V[i + 1, j], V[i + 1, j2]
        tris.append(np.stack([a, b_, c], 1))
        tris.append(np.stack([b_, d, c], 1))
    return np.concatenate(tris, 0)


def mesh_scene(tris: np.ndarray, device=None) -> SceneData:
    """Ground plane, a triangle mesh and a two-triangle area light."""
    b = SceneBuilder(background=(0.05, 0.05, 0.08))
    b.add_plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                Material.diffuse(0.8, 0.8, 0.8))
    b.add_triangles(tris, Material.diffuse(0.9, 0.45, 0.3))
    light = Material.emissive(14.0, 14.0, 14.0)
    b.add_triangle((2.0, 6.0, 2.0), (2.0, 6.0, -2.0), (-2.0, 6.0, -2.0),
                   light)
    b.add_triangle((-2.0, 6.0, 2.0), (2.0, 6.0, 2.0), (-2.0, 6.0, -2.0),
                   light)
    return b.build(device)


def triangle_cloud(n: int, seed: int = 7) -> np.ndarray:
    """n triangles with centres in [-2.5, 2.5]^2 x [0, 5] and per-vertex
    offsets in [0, 0.5]^3, deterministic in ``seed``."""
    r = np.random.default_rng(seed)
    cx = r.uniform(-2.5, 2.5, size=(n, 1, 1))
    cy = r.uniform(-2.5, 2.5, size=(n, 1, 1))
    cz = r.uniform(0.0, 5.0, size=(n, 1, 1))
    centers = np.concatenate([cx, cy, cz], axis=-1)
    offsets = r.uniform(0.0, 0.5, size=(n, 3, 3))
    return (centers + offsets).astype(np.float32)


_REGISTRY = {
    0: lambda meshes, textures, device: museum(device),
    2: lambda meshes, textures, device: bunny_high(meshes, device),
    # scene id = cloud mesh id + 1
    3: lambda meshes, textures, device: cloud(100, meshes, MESH_CLOUD_100, device),
    4: lambda meshes, textures, device: cloud(10_000, meshes, MESH_CLOUD_10K,
                                              device),
    5: lambda meshes, textures, device: cloud(100_000, meshes, MESH_CLOUD_100K,
                                              device),
    100: lambda meshes, textures, device: sphere_plane(device),
    101: lambda meshes, textures, device: whitted(textures, device),
}


def select_scene(scene_id: int, meshes: dict | None = None,
                 textures: dict | None = None, device=None) -> SceneData:
    """Scene registry: ids 0, 2, 3, 4, 5, 100 and 101."""
    if scene_id not in _REGISTRY:
        raise ValueError(f"Invalid scene {scene_id}")
    return _REGISTRY[scene_id](meshes, textures, resolve_device(device))
