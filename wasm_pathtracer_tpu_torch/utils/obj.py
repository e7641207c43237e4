"""Wavefront OBJ loading (``wasm_pathtracer_tpu.utils.obj``; NumPy only).

Supports ``v``/``vn``/``f``, triangulates polygon faces as a fan, and
de-indexes into a flat ``(num_tris, 3, 3)`` float32 vertex array.
Negative OBJ indices are supported.
"""

from __future__ import annotations

import numpy as np


def parse_obj(text: str) -> np.ndarray:
    """Parse OBJ source -> (T, 3, 3) float32 triangle vertices."""
    verts: list[tuple[float, float, float]] = []
    tris: list[tuple[int, int, int]] = []

    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif tag == "f":
            idx = []
            for p in parts[1:]:
                vi = p.split("/")[0]
                i = int(vi)
                idx.append(i - 1 if i > 0 else len(verts) + i)
            for k in range(1, len(idx) - 1):  # fan triangulation
                tris.append((idx[0], idx[k], idx[k + 1]))
        # vn / vt / o / g / s / usemtl etc. are ignored, as in the reference

    v = np.asarray(verts, dtype=np.float32)
    if not tris:
        return np.zeros((0, 3, 3), dtype=np.float32)
    t = np.asarray(tris, dtype=np.int64)
    return v[t]


def load_obj(path: str, scale: float = 1.0, flip_z: bool = False) -> np.ndarray:
    """Load an OBJ file, scaled, and mirrored in z with the winding
    restored when ``flip_z`` is set (the client loads its bunny with
    scale 8 and a flipped z)."""
    with open(path, "r") as f:
        tris = parse_obj(f.read())
    tris = tris * np.float32(scale)
    if flip_z:
        tris = tris * np.array([1.0, 1.0, -1.0], dtype=np.float32)
        # flipping one axis mirrors the winding; swap two verts to restore it
        tris = tris[:, [0, 2, 1], :]
    return tris
