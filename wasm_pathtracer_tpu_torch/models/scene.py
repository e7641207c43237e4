"""Structure-of-arrays scene tables (``wasm_pathtracer_tpu.models.scene``).

A scene is one unified shape table (``params (N, 9)`` + ``ptype (N,)``),
a material table, area lights as shape indices, 0-sized lights and a
texture atlas.  Infinite shapes (planes) occupy a prefix of the shape
table.  The host-side :class:`SceneBuilder` is the JAX package's, and
produces identical arrays; :class:`SceneData` holds them as tensors.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from wasm_pathtracer_tpu_torch.utils.device import resolve_device


class PrimType(enum.IntEnum):
    PLANE = 0      # infinite; always in the brute-force prefix
    SPHERE = 1
    TRIANGLE = 2
    TORUS = 3
    AARECT = 4
    SQUARE = 5


class MatKind(enum.IntEnum):
    DIFFUSE = 0
    EMISSIVE = 1
    REFLECT = 2   # mirror component mixed with diffuse by `reflectivity`
    REFRACT = 3   # dielectric: Fresnel reflect/transmit + Beer absorption


# mat_extra column layout
EXTRA_REFLECTIVITY = 0
EXTRA_IOR = 1
EXTRA_ABSORB_R = 2
EXTRA_ABSORB_G = 3
EXTRA_ABSORB_B = 4

_N_PARAMS = 9
_N_EXTRA = 5

# SceneData's tensor fields, in declaration order
TENSOR_FIELDS = (
    "ptype", "params", "mat_kind", "albedo", "emission", "mat_extra",
    "tex_id", "light_shape", "plight_kind", "plight_pos", "plight_dir",
    "plight_color", "plight_angle", "background", "textures",
)
_INT_FIELDS = ("ptype", "mat_kind", "tex_id", "light_shape", "plight_kind")


@dataclasses.dataclass(frozen=True)
class Material:
    """Host-side material description used by the scene builder."""

    kind: MatKind = MatKind.DIFFUSE
    albedo: tuple = (0.0, 0.0, 0.0)
    emission: tuple = (0.0, 0.0, 0.0)
    reflectivity: float = 0.0
    ior: float = 1.0
    absorption: tuple = (0.0, 0.0, 0.0)
    texture_id: int = -1

    @staticmethod
    def diffuse(r, g, b, texture_id: int = -1) -> "Material":
        return Material(MatKind.DIFFUSE, albedo=(r, g, b), texture_id=texture_id)

    @staticmethod
    def emissive(r, g, b) -> "Material":
        return Material(MatKind.EMISSIVE, emission=(r, g, b))

    @staticmethod
    def reflect(r, g, b, reflectivity: float) -> "Material":
        return Material(MatKind.REFLECT, albedo=(r, g, b), reflectivity=reflectivity)

    @staticmethod
    def refract(absorption: tuple, ior: float) -> "Material":
        return Material(MatKind.REFRACT, albedo=(1.0, 1.0, 1.0), ior=ior,
                        absorption=absorption)


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Scene tables as tensors on one device."""

    # --- unified shape table ---------------------------------------------
    ptype: torch.Tensor        # (N,) int32, PrimType
    params: torch.Tensor       # (N, 9) f32, layout per PrimType
    # --- material table ---------------------------------------------------
    mat_kind: torch.Tensor     # (N,) int32, MatKind
    albedo: torch.Tensor       # (N, 3) f32
    emission: torch.Tensor     # (N, 3) f32
    mat_extra: torch.Tensor    # (N, 5) f32: reflectivity, ior, absorption rgb
    tex_id: torch.Tensor       # (N,) int32, -1 = untextured
    # --- lights -----------------------------------------------------------
    light_shape: torch.Tensor  # (L,) int32 shape ids of emissive shapes
    plight_kind: torch.Tensor  # (PL,) int32: 0 point, 1 spot, 2 directional
    plight_pos: torch.Tensor   # (PL, 3)
    plight_dir: torch.Tensor   # (PL, 3)
    plight_color: torch.Tensor  # (PL, 3)
    plight_angle: torch.Tensor  # (PL,)
    # --- misc -------------------------------------------------------------
    background: torch.Tensor   # (3,) f32
    textures: torch.Tensor     # (K, th, tw, 3) f32 atlas (K may be 0)
    # --- static metadata --------------------------------------------------
    num_inf: int = 0
    num_shapes: int = 0
    num_lights: int = 0
    num_plights: int = 0

    @property
    def device(self) -> torch.device:
        return self.params.device

    def to(self, device) -> "SceneData":
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device) for k in TENSOR_FIELDS})

    def detach(self) -> "SceneData":
        """The same tables cut from any autograd graph."""
        return dataclasses.replace(self, **{
            k: getattr(self, k).detach() for k in TENSOR_FIELDS})

    def with_materials(self, albedo=None, emission=None, mat_extra=None) -> "SceneData":
        """A new scene with the given material leaves (the differentiable
        ones: gradients flow into the tensors given)."""
        return dataclasses.replace(
            self,
            albedo=self.albedo if albedo is None else albedo,
            emission=self.emission if emission is None else emission,
            mat_extra=self.mat_extra if mat_extra is None else mat_extra)

    def with_light_rows(self, rows) -> "SceneData":
        """A new scene whose area lights' (L, 9) geometry rows are
        ``rows``; the shape table is rebuilt out of place, so gradients
        flow into ``rows`` (the NEE estimator's area, cosines, distance
        and sample point, and the lights' hit distances)."""
        return dataclasses.replace(self, params=self.params.index_put(
            (self.light_shape.long(),), rows))


def scene_from_numpy(arrays: dict, num_inf: int, num_shapes: int,
                     num_lights: int, num_plights: int,
                     device=None) -> SceneData:
    """Build a :class:`SceneData` from a dict of arrays keyed by field
    name — e.g. the JAX package's ``SceneData`` read field by field with
    ``np.asarray`` — so both packages compute on identical tables."""
    device = resolve_device(device)
    kw = {}
    for k in TENSOR_FIELDS:
        a = np.asarray(arrays[k])
        dt = np.int32 if k in _INT_FIELDS else np.float32
        kw[k] = torch.from_numpy(np.array(a, dtype=dt)).to(device)
    return SceneData(**kw, num_inf=int(num_inf), num_shapes=int(num_shapes),
                     num_lights=int(num_lights), num_plights=int(num_plights))


def _finite_boxes(ptype: np.ndarray, p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi), (n, 3) float32 each: the AABBs of the finite shape rows
    ``p`` (n, 9) of types ``ptype`` (n,), host side.  Triangles are
    padded by 0.1 * EPSILON (``ops.cluster.prim_aabbs`` pads every
    family, as the JAX cluster build does)."""
    ptype = np.asarray(ptype)
    p = np.asarray(p, np.float32)
    lo = np.empty((len(ptype), 3), np.float32)
    hi = np.empty((len(ptype), 3), np.float32)
    known = np.zeros(len(ptype), bool)

    def put(kind, bmin, bmax):
        m = ptype == int(kind)
        if m.any():
            lo[m], hi[m] = bmin(p[m]), bmax(p[m])
        known[m] = True

    put(PrimType.SPHERE, lambda q: q[:, :3] - q[:, 3:4], lambda q: q[:, :3] + q[:, 3:4])
    pad = np.float32(0.1 * 2e-4)
    put(PrimType.TRIANGLE, lambda q: q[:, :9].reshape(-1, 3, 3).min(1) - pad,
        lambda q: q[:, :9].reshape(-1, 3, 3).max(1) + pad)

    def torus_ext(q):
        r = q[:, 3] + q[:, 4]
        return np.stack([r, q[:, 4], r], axis=-1)

    put(PrimType.TORUS, lambda q: q[:, :3] - torus_ext(q), lambda q: q[:, :3] + torus_ext(q))
    put(PrimType.AARECT, lambda q: q[:, 0:3], lambda q: q[:, 3:6])

    def half(q):
        return np.stack([q[:, 3] / 2, np.zeros_like(q[:, 3]), q[:, 3] / 2], axis=-1)

    put(PrimType.SQUARE, lambda q: q[:, :3] - half(q), lambda q: q[:, :3] + half(q))
    if not known.all():
        raise ValueError(f"no AABB for ptype {int(ptype[~known][0])}")
    return lo, hi


def prim_aabb(ptype: int, p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The AABB (lo (3,), hi (3,)) of one primitive row (host side)."""
    lo, hi = _finite_boxes(np.array([int(ptype)]), np.asarray(p)[None])
    return lo[0], hi[0]


def finite_aabb(scene: SceneData) -> tuple[np.ndarray, np.ndarray]:
    """World AABB over the finite shapes (host side; the photon grid's
    extent); a scene without finite shapes reads the unit box."""
    n0, n1 = scene.num_inf, scene.num_shapes
    lo, hi = _finite_boxes(scene.ptype.cpu().numpy()[n0:n1],
                           scene.params.cpu().numpy()[n0:n1])
    lo, hi = lo.min(0, initial=np.inf), hi.max(0, initial=-np.inf)
    if not np.all(np.isfinite(lo)):
        return np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)
    return lo, hi


class SceneBuilder:
    """Host-side (NumPy) scene assembly: collect shapes, register
    emissive shapes as area lights, order infinite shapes first."""

    def __init__(self, background=(0.0, 0.0, 0.0)):
        self.background = tuple(background)
        self._inf: list[tuple[int, np.ndarray, Material]] = []
        self._fin: list[tuple[int, np.ndarray, Material]] = []
        self.textures: list[np.ndarray] = []
        self._plights: list[tuple[int, tuple, tuple, tuple, float]] = []

    # -- shape adders ------------------------------------------------------
    def _add(self, ptype: PrimType, params: list, mat: Material, infinite: bool):
        row = np.zeros(_N_PARAMS, dtype=np.float32)
        row[: len(params)] = params
        (self._inf if infinite else self._fin).append((int(ptype), row, mat))

    def add_plane(self, location, normal, mat: Material):
        n = np.asarray(normal, np.float32)
        n = n / np.linalg.norm(n)
        self._add(PrimType.PLANE, [*location, *n], mat, infinite=True)

    def add_sphere(self, center, radius, mat: Material):
        self._add(PrimType.SPHERE, [*center, radius], mat, infinite=False)

    def add_triangle(self, v0, v1, v2, mat: Material):
        self._add(PrimType.TRIANGLE, [*v0, *v1, *v2], mat, infinite=False)

    def add_triangles(self, tris: np.ndarray, mat: Material):
        """Bulk add of a (T, 3, 3) vertex array."""
        for t in np.asarray(tris, np.float32).reshape(-1, 9):
            self._add(PrimType.TRIANGLE, list(t), mat, infinite=False)

    def add_torus(self, center, big_r, small_r, mat: Material):
        self._add(PrimType.TORUS, [*center, big_r, small_r], mat, infinite=False)

    def add_aarect(self, x_min, x_max, y_min, y_max, z_min, z_max, mat: Material):
        # stored as (min, max) corners
        self._add(PrimType.AARECT, [x_min, y_min, z_min, x_max, y_max, z_max],
                  mat, infinite=False)

    def add_square(self, center, size, mat: Material):
        """Axis-aligned y-plane quad."""
        self._add(PrimType.SQUARE, [*center, size], mat, infinite=False)

    # -- 0-sized lights ----------------------------------------------------
    def add_point_light(self, location, color, strength: float):
        c = tuple(strength * x for x in color)
        self._plights.append((0, tuple(location), (0.0, 0.0, 1.0), c, 0.0))

    def add_spot_light(self, location, direction, angle, color, strength):
        c = tuple(strength * x for x in color)
        self._plights.append((1, tuple(location), tuple(direction), c, angle))

    def add_directional_light(self, direction, color):
        self._plights.append((2, (0.0, 0.0, 0.0), tuple(direction),
                              tuple(color), 0.0))

    def add_texture(self, rgb: np.ndarray) -> int:
        """Register an RGB float texture; returns its id."""
        self.textures.append(np.asarray(rgb, np.float32))
        return len(self.textures) - 1

    # -- finalize ----------------------------------------------------------
    def build(self, device=None) -> SceneData:
        device = resolve_device(device)
        shapes = self._inf + self._fin
        n = len(shapes)
        ptype = np.array([s[0] for s in shapes], np.int32)
        params = (np.stack([s[1] for s in shapes])
                  if n else np.zeros((0, _N_PARAMS), np.float32))

        mats = [s[2] for s in shapes]
        mat_kind = np.array([int(m.kind) for m in mats], np.int32)
        albedo = np.array([m.albedo for m in mats], np.float32).reshape(n, 3)
        emission = np.array([m.emission for m in mats], np.float32).reshape(n, 3)
        extra = np.zeros((n, _N_EXTRA), np.float32)
        for i, m in enumerate(mats):
            extra[i, EXTRA_REFLECTIVITY] = m.reflectivity
            extra[i, EXTRA_IOR] = m.ior
            extra[i, EXTRA_ABSORB_R:EXTRA_ABSORB_B + 1] = m.absorption
        tex_id = np.array([m.texture_id for m in mats], np.int32)

        light_shape = np.array(
            [i for i, m in enumerate(mats) if m.kind == MatKind.EMISSIVE],
            np.int32,
        )

        if self.textures:
            th = max(t.shape[0] for t in self.textures)
            tw = max(t.shape[1] for t in self.textures)
            atlas = np.zeros((len(self.textures), th, tw, 3), np.float32)
            for k, t in enumerate(self.textures):
                atlas[k, : t.shape[0], : t.shape[1]] = t
        else:
            atlas = np.zeros((0, 1, 1, 3), np.float32)

        pl = self._plights
        arrays = dict(
            ptype=ptype, params=params, mat_kind=mat_kind, albedo=albedo,
            emission=emission, mat_extra=extra, tex_id=tex_id,
            light_shape=light_shape,
            plight_kind=np.array([p[0] for p in pl], np.int32),
            plight_pos=np.array([p[1] for p in pl], np.float32).reshape(len(pl), 3),
            plight_dir=np.array([p[2] for p in pl], np.float32).reshape(len(pl), 3),
            plight_color=np.array([p[3] for p in pl], np.float32).reshape(len(pl), 3),
            plight_angle=np.array([p[4] for p in pl], np.float32),
            background=np.asarray(self.background, np.float32),
            textures=atlas,
        )
        return scene_from_numpy(arrays, len(self._inf), n,
                                int(light_shape.shape[0]), len(pl), device)
