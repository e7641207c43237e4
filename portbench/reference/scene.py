"""The scenes of the benchmark's configurations, built anew: a frozen copy
of the port's ``models/scene.py`` builder and of the museum and cloud
builders of ``models/scenes.py``, trimmed to what the reference reads.

A scene is one unified shape table (``params (N, 9)`` + ``ptype (N,)``),
a material table and the area lights as shape indices.  Infinite shapes
(planes) occupy a prefix of the shape table.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from portbench.reference.rng import Xorshift32


class PrimType(enum.IntEnum):
    PLANE = 0
    SPHERE = 1
    TRIANGLE = 2
    TORUS = 3
    AARECT = 4
    SQUARE = 5


class MatKind(enum.IntEnum):
    DIFFUSE = 0
    EMISSIVE = 1
    REFLECT = 2
    REFRACT = 3


EXTRA_REFLECTIVITY = 0
EXTRA_IOR = 1
EXTRA_ABSORB_R = 2
EXTRA_ABSORB_B = 4


@dataclasses.dataclass(frozen=True)
class Material:
    kind: MatKind = MatKind.DIFFUSE
    albedo: tuple = (0.0, 0.0, 0.0)
    emission: tuple = (0.0, 0.0, 0.0)

    @staticmethod
    def diffuse(r, g, b) -> "Material":
        return Material(MatKind.DIFFUSE, albedo=(r, g, b))

    @staticmethod
    def emissive(r, g, b) -> "Material":
        return Material(MatKind.EMISSIVE, emission=(r, g, b))


@dataclasses.dataclass(frozen=True)
class Scene:
    """Scene tables as float32 / int tensors on one device.  ``mat_extra``
    is (N, 5): reflectivity, ior, absorption rgb (ior 1 here)."""

    ptype: torch.Tensor
    params: torch.Tensor
    mat_kind: torch.Tensor
    albedo: torch.Tensor
    emission: torch.Tensor
    mat_extra: torch.Tensor
    light_shape: torch.Tensor
    background: torch.Tensor
    num_inf: int
    num_shapes: int
    num_lights: int

    @property
    def device(self) -> torch.device:
        return self.params.device

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)


class SceneBuilder:
    """Collect shapes, register emissive shapes as area lights, order the
    infinite shapes first."""

    def __init__(self, background=(0.0, 0.0, 0.0)):
        self.background = tuple(background)
        self._inf: list = []
        self._fin: list = []

    def _add(self, ptype, params, mat, infinite):
        row = np.zeros(9, dtype=np.float32)
        row[:len(params)] = params
        (self._inf if infinite else self._fin).append((int(ptype), row, mat))

    def add_plane(self, location, normal, mat):
        n = np.asarray(normal, np.float32)
        n = n / np.linalg.norm(n)
        self._add(PrimType.PLANE, [*location, *n], mat, True)

    def add_triangle(self, v0, v1, v2, mat):
        self._add(PrimType.TRIANGLE, [*v0, *v1, *v2], mat, False)

    def add_triangles(self, tris, mat):
        for t in np.asarray(tris, np.float32).reshape(-1, 9):
            self._add(PrimType.TRIANGLE, list(t), mat, False)

    def add_torus(self, center, big_r, small_r, mat):
        self._add(PrimType.TORUS, [*center, big_r, small_r], mat, False)

    def add_aarect(self, x_min, x_max, y_min, y_max, z_min, z_max, mat):
        self._add(PrimType.AARECT, [x_min, y_min, z_min, x_max, y_max, z_max], mat, False)

    def build(self, device) -> Scene:
        shapes = self._inf + self._fin
        n = len(shapes)
        mats = [s[2] for s in shapes]
        extra = np.zeros((n, 5), np.float32)
        extra[:, EXTRA_IOR] = 1.0

        def t(a, dt):
            return torch.from_numpy(np.array(a, dtype=dt)).to(device)

        light = [i for i, m in enumerate(mats) if m.kind == MatKind.EMISSIVE]
        return Scene(
            ptype=t([s[0] for s in shapes], np.int32),
            params=t(np.stack([s[1] for s in shapes]), np.float32),
            mat_kind=t([int(m.kind) for m in mats], np.int32),
            albedo=t(np.array([m.albedo for m in mats], np.float32).reshape(n, 3), np.float32),
            emission=t(np.array([m.emission for m in mats], np.float32).reshape(n, 3),
                       np.float32),
            mat_extra=t(extra, np.float32),
            light_shape=t(light, np.int32),
            background=t(self.background, np.float32),
            num_inf=len(self._inf), num_shapes=n, num_lights=len(light))


def museum(device) -> Scene:
    """Scene 0: ground plane, 27 tori, 108 emissive light triangles
    (colours shuffled per row with the xorshift stream), AARect walls."""
    b = SceneBuilder(background=(0.0, 0.0, 0.0))
    b.add_plane((0.0, -1.0, 0.0), (0.0, 1.0, 0.0), Material.diffuse(0.7, 0.7, 0.7))
    xs = [-16.0, -12.0, -8.0, -4.0, 0.0, 4.0, 8.0, 12.0, 16.0]
    colors = [(1.0, 0.3, 0.3), (0.0, 1.0, 1.0), (0.3, 0.3, 1.0), (1.0, 0.0, 0.0),
              (0.0, 1.0, 0.0), (0.0, 0.0, 1.0), (1.0, 0.0, 1.0), (1.0, 1.0, 0.0),
              (0.3, 1.0, 0.3)]
    rng = Xorshift32()
    rng.next()
    rng.next()
    for y in (-7.5, 0.0, 7.5):
        for i, x in enumerate(xs):
            b.add_torus((x, -0.5, y), 1.3, 0.3, Material.diffuse(1.0, 1.0, 1.0))
            m = Material.emissive(*(2.5 * c for c in colors[i]))
            for dz in (2.8, -2.8):
                z_near = y + dz
                z_far = y + (2.5 if dz > 0 else -2.5)
                lc1 = (x - 1.0, 0.0, z_near)
                lc2 = (x + 1.0, 0.0, z_near)
                lc3 = (x + 1.0, 1.0, z_far)
                lc4 = (x - 1.0, 1.0, z_far)
                b.add_triangle(lc3, lc2, lc1, m)
                b.add_triangle(lc4, lc3, lc1, m)
        rng.shuffle(colors)
    wall = Material.diffuse(0.7, 0.7, 0.7)
    for x in (-14.0, -10.0, -6.0, -2.0, 2.0, 6.0, 10.0, 14.0):
        b.add_aarect(x - 0.1, x + 0.1, -1.0, 2.0, -20.0, 20.0, wall)
    b.add_aarect(-20.0, 20.0, -1.0, 2.0, 3.75 - 0.1, 3.75 + 0.1, wall)
    b.add_aarect(-20.0, 20.0, -1.0, 2.0, -3.75 - 0.1, -3.75 + 0.1, wall)
    return b.build(device)


def triangle_cloud(n: int, seed: int = 7) -> np.ndarray:
    """n triangles with centres in [-2.5, 2.5]^2 x [0, 5] and per-vertex
    offsets in [0, 0.5]^3 (the upstream client's procedural cloud)."""
    r = np.random.default_rng(seed)
    cx = r.uniform(-2.5, 2.5, size=(n, 1, 1))
    cy = r.uniform(-2.5, 2.5, size=(n, 1, 1))
    cz = r.uniform(0.0, 5.0, size=(n, 1, 1))
    centers = np.concatenate([cx, cy, cz], axis=-1)
    offsets = r.uniform(0.0, 0.5, size=(n, 3, 3))
    return (centers + offsets).astype(np.float32)


def cloud(n: int, device) -> Scene:
    """Scenes 3-5: a triangle cloud of ``n`` triangles (x0.5, +5 z) over a
    plane, with a two-triangle area light."""
    b = SceneBuilder(background=(0.02, 0.02, 0.04))
    b.add_plane((0.0, -3.0, 0.0), (0.0, 1.0, 0.0), Material.diffuse(0.8, 0.8, 0.8))
    tris = triangle_cloud(n) * np.float32(0.5)
    b.add_triangles(tris + np.array([0.0, 0.0, 5.0], np.float32),
                    Material.diffuse(0.75, 0.55, 0.35))
    light = Material.emissive(14.0, 14.0, 14.0)
    b.add_triangle((2.0, 7.0, 4.5), (2.0, 7.0, 0.5), (-2.0, 7.0, 0.5), light)
    b.add_triangle((-2.0, 7.0, 4.5), (2.0, 7.0, 4.5), (-2.0, 7.0, 0.5), light)
    return b.build(device)


SCENES = {0: museum, 3: lambda device: cloud(100, device),
          4: lambda device: cloud(10_000, device), 5: lambda device: cloud(100_000, device)}


def build_scene(scene_id: int, device) -> Scene:
    if scene_id not in SCENES:
        raise ValueError(f"the reference builds scenes {sorted(SCENES)}, not {scene_id}")
    return SCENES[scene_id](device)


def finite_aabb(scene: Scene):
    """World AABB (lo (3,), hi (3,)) over the finite shapes, host side.
    Triangles are padded by 0.1 * EPSILON, tori by their radii, AARects
    are their corners."""
    n0, n1 = scene.num_inf, scene.num_shapes
    pt = scene.ptype.cpu().numpy()[n0:n1]
    p = scene.params.cpu().numpy()[n0:n1].astype(np.float32)
    lo = np.empty((len(pt), 3), np.float32)
    hi = np.empty((len(pt), 3), np.float32)
    tri = pt == int(PrimType.TRIANGLE)
    pad = np.float32(0.1 * 2e-4)
    v = p[tri, :9].reshape(-1, 3, 3)
    lo[tri], hi[tri] = v.min(1) - pad, v.max(1) + pad
    tor = pt == int(PrimType.TORUS)
    r = p[tor, 3] + p[tor, 4]
    ext = np.stack([r, p[tor, 4], r], axis=-1)
    lo[tor], hi[tor] = p[tor, :3] - ext, p[tor, :3] + ext
    aa = pt == int(PrimType.AARECT)
    lo[aa], hi[aa] = p[aa, 0:3], p[aa, 3:6]
    if not (tri | tor | aa).all():
        raise ValueError("the reference boxes triangles, tori and AARects only")
    lo, hi = lo.min(0, initial=np.inf), hi.max(0, initial=-np.inf)
    if not np.all(np.isfinite(lo)):
        return np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)
    return lo, hi
