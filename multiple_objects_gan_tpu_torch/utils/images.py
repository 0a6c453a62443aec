"""Images into and out of the models: the device-side normalize of a
training batch, uint8 conversion, a stdlib PNG writer, and the image grids,
box outlines and caption text of the JAX package's ``utils/images.py``.

The serving path needs no imaging library: a PNG of 8-bit grayscale or RGB
rows is a signature, an IHDR chunk, one zlib-compressed IDAT chunk and an
IEND chunk. The pixels are those of the JAX package's ``cli/serve.py:
_png_b64``: ``clip((x + 1) * 127.5, 0, 255)`` cast to uint8, grayscale for
one channel.

Text is drawn with the port's own 5x7 bitmap font (:data:`FONT`, capitals,
digits and a little punctuation; lower case is drawn in capitals): PIL's
default font cannot be reproduced without PIL, so the caption pixels differ
from the JAX package's while the grids around them are the same.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Sequence

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def as_model_image(img: torch.Tensor) -> torch.Tensor:
    """A batch of images (B, H, W, C) -> the model's float (B, C, H, W).

    uint8 [0, 255] maps to [-1, 1] as ``x / 127.5 - 1`` (the reference's
    ToTensor + Normalize(0.5, 0.5), code/multi-mnist/main.py:80-82); float
    values pass through unchanged, as the JAX package's ``as_model_image``
    does. Batches travel as uint8, so this runs where the tensor lies: on
    the device, as the JAX step does (train/step.py:270).
    """
    if img.dtype == torch.uint8:
        img = img.float() / 127.5 - 1.0
    return img.permute(0, 3, 1, 2).contiguous()


def to_uint8(img) -> np.ndarray:
    """[-1, 1] float image (H, W, C) -> uint8 (H, W, C)."""
    return np.clip((np.asarray(img, np.float32) + 1.0) * 127.5,
                   0, 255).astype(np.uint8)


def png_chunk(kind: bytes, data: bytes) -> bytes:
    """One PNG chunk: length, kind, data and CRC."""
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
    return (PNG_SIGNATURE + png_chunk(b"IHDR", ihdr)
            + png_chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + png_chunk(b"IEND", b""))


def tile_uint8(img) -> np.ndarray:
    """(H, W, C) in [-1, 1] -> uint8 (H, W, 3), as the JAX package's
    ``utils/images.py:to_uint8`` rounds it; uint8 passes through, gray is
    repeated to RGB."""
    x = np.asarray(img)
    if x.dtype != np.uint8:
        x = (np.asarray(x, np.float32) + 1.0) / 2.0
        x = (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    return x


def make_grid(images, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """(N, H, W, C) float in [-1, 1] or uint8 -> one uint8 RGB grid,
    ``nrow`` tiles a row with ``pad`` black pixels between them, as the JAX
    package's ``make_grid`` (vutils.save_image's layout)."""
    n, h, w, _ = images.shape
    rows = (n + nrow - 1) // nrow
    grid = np.zeros((rows * (h + pad) + pad, nrow * (w + pad) + pad, 3),
                    np.uint8)
    for i in range(n):
        r, c = divmod(i, nrow)
        y, x = r * (h + pad) + pad, c * (w + pad) + pad
        grid[y:y + h, x:x + w] = tile_uint8(images[i])
    return grid


def save_grid(images, path: str, nrow: int = 8) -> None:
    """:func:`make_grid` written to ``path`` as a PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(make_grid(images, nrow=nrow)))


def save_image(img, path: str) -> None:
    """One (H, W, C) image in [-1, 1] (or uint8) written to ``path`` as a
    PNG, its pixels rounded as the JAX package's ``to_uint8`` rounds them
    before PIL saves them (``cli/attngan_runner.py:gen_example``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(tile_uint8(img)))


def draw_bboxes(img_uint8: np.ndarray, bboxes, color=(220, 30, 30)
                ) -> np.ndarray:
    """A copy of (H, W, 3) uint8 with the 1-pixel outline of each
    normalised (x, y, w, h) box, corners truncated to pixels as PIL's
    ``ImageDraw.rectangle`` does; a box with a negative entry (the -1
    padding) is skipped."""
    out = np.array(img_uint8, copy=True)
    h, w = out.shape[:2]
    for bb in np.asarray(bboxes).reshape(-1, 4):
        if np.any(bb < 0):
            continue
        x0, y0 = int(bb[0] * w), int(bb[1] * h)
        x1, y1 = int((bb[0] + bb[2]) * w), int((bb[1] + bb[3]) * h)
        xs = slice(max(x0, 0), min(x1, w - 1) + 1)
        ys = slice(max(y0, 0), min(y1, h - 1) + 1)
        for y in (y0, y1):
            if 0 <= y < h:
                out[y, xs] = color
        for x in (x0, x1):
            if 0 <= x < w:
                out[ys, x] = color
    return out


_GLYPHS = """
A 01110 10001 10001 11111 10001 10001 10001
B 11110 10001 10001 11110 10001 10001 11110
C 01110 10001 10000 10000 10000 10001 01110
D 11110 10001 10001 10001 10001 10001 11110
E 11111 10000 10000 11110 10000 10000 11111
F 11111 10000 10000 11110 10000 10000 10000
G 01110 10001 10000 10111 10001 10001 01111
H 10001 10001 10001 11111 10001 10001 10001
I 01110 00100 00100 00100 00100 00100 01110
J 00111 00010 00010 00010 00010 10010 01100
K 10001 10010 10100 11000 10100 10010 10001
L 10000 10000 10000 10000 10000 10000 11111
M 10001 11011 10101 10101 10001 10001 10001
N 10001 10001 11001 10101 10011 10001 10001
O 01110 10001 10001 10001 10001 10001 01110
P 11110 10001 10001 11110 10000 10000 10000
Q 01110 10001 10001 10001 10101 10010 01101
R 11110 10001 10001 11110 10100 10010 10001
S 01111 10000 10000 01110 00001 00001 11110
T 11111 00100 00100 00100 00100 00100 00100
U 10001 10001 10001 10001 10001 10001 01110
V 10001 10001 10001 10001 10001 01010 00100
W 10001 10001 10001 10101 10101 10101 01010
X 10001 10001 01010 00100 01010 10001 10001
Y 10001 10001 10001 01010 00100 00100 00100
Z 11111 00001 00010 00100 01000 10000 11111
0 01110 10001 10011 10101 11001 10001 01110
1 00100 01100 00100 00100 00100 00100 01110
2 01110 10001 00001 00010 00100 01000 11111
3 11111 00010 00100 00010 00001 10001 01110
4 00010 00110 01010 10010 11111 00010 00010
5 11111 10000 11110 00001 00001 10001 01110
6 00110 01000 10000 11110 10001 10001 01110
7 11111 00001 00010 00100 01000 01000 01000
8 01110 10001 10001 01110 10001 10001 01110
9 01110 10001 10001 01111 00001 00010 01100
, 00000 00000 00000 00000 01100 00100 01000
. 00000 00000 00000 00000 00000 01100 01100
- 00000 00000 00000 11111 00000 00000 00000
: 00000 01100 01100 00000 01100 01100 00000
? 01110 10001 00001 00010 00100 00000 00100
"""
#: character -> (7, 5) bool glyph; a space is blank, anything else "?"
FONT = {line[0]: np.array([[c == "1" for c in row]
                           for row in line[2:].split()])
        for line in _GLYPHS.strip().splitlines()}
FONT[" "] = np.zeros((7, 5), bool)
GLYPH_ADVANCE = 6        # pixels from one character to the next


def draw_text(img: np.ndarray, xy: tuple[int, int], text: str,
              fill=(0, 0, 0)) -> None:
    """Draw ``text`` into (H, W, 3) uint8 in place, the top left of its
    first glyph at ``xy`` = (x, y), clipped to the image."""
    h, w = img.shape[:2]
    x, y = xy
    for ch in text.upper():
        glyph = FONT.get(ch, FONT["?"])
        gy, gx = np.nonzero(glyph)
        gy, gx = gy + y, gx + x
        keep = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
        img[gy[keep], gx[keep]] = fill
        x += GLYPH_ADVANCE


def caption_tile(lines: Sequence[str], hw: tuple[int, int],
                 fill=(0, 0, 0)) -> np.ndarray:
    """A white (H, W, 3) uint8 tile with one line of text every 11 rows
    from (2, 2), as the JAX package's ``caption_tile`` lays it out
    (trainer.py:330-340)."""
    tile = np.full((hw[0], hw[1], 3), 255, np.uint8)
    for i, line in enumerate(lines):
        draw_text(tile, (2, 2 + 11 * i), line, fill)
    return tile
