"""Images out of the generator: uint8 conversion and a stdlib PNG writer.

The serving path needs no imaging library: a PNG of 8-bit grayscale or RGB
rows is a signature, an IHDR chunk, one zlib-compressed IDAT chunk and an
IEND chunk. The pixels are those of the JAX package's ``cli/serve.py:
_png_b64``: ``clip((x + 1) * 127.5, 0, 255)`` cast to uint8, grayscale for
one channel.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_uint8(img) -> np.ndarray:
    """[-1, 1] float image (H, W, C) -> uint8 (H, W, C)."""
    return np.clip((np.asarray(img, np.float32) + 1.0) * 127.5,
                   0, 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(data, zlib.crc32(kind)) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def png_bytes(u8: np.ndarray) -> bytes:
    """uint8 (H, W), (H, W, 1) or (H, W, 3) -> PNG file bytes."""
    u8 = np.asarray(u8)
    if u8.dtype != np.uint8:
        raise ValueError(f"png_bytes takes uint8, got {u8.dtype}")
    if u8.ndim == 3 and u8.shape[-1] == 1:
        u8 = u8[..., 0]
    if u8.ndim == 2:
        color_type = 0                      # grayscale
    elif u8.ndim == 3 and u8.shape[-1] == 3:
        color_type = 2                      # RGB
    else:
        raise ValueError(f"unsupported image shape {u8.shape}")
    h, w = u8.shape[:2]
    rows = np.ascontiguousarray(u8).reshape(h, -1)
    # filter type 0 (None) in front of every row
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))
