"""Minimal dependency-free PNG writer (numpy only)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def encode_png(rgb: np.ndarray, level: int = 6) -> bytes:
    """Encode an (H, W, 3) uint8 array as PNG bytes."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape}")
    h, w, _ = rgb.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    # filter byte 0 (None) per scanline
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, level))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as a PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def tonemap_u8(img: np.ndarray) -> np.ndarray:
    """Clamp to [0, 1] and quantize: ``(clamp(v) * 255) as u8``."""
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
