"""A standard-library PNG reader and Pillow's resize, in numpy.

The JAX package's readers open images with PIL (``data/datasets.py:42-52``)
or its native decoder; the card's machine has neither, so the port decodes
PNGs itself and reproduces the two PIL calls its readers make:

* :func:`read_png` is ``Image.open(path).convert("L" | "RGB")`` for 8-bit,
  non-interlaced PNGs of colour types 0 (gray), 2 (RGB), 3 (palette) and 6
  (RGBA), with all five row filters. RGBA -> RGB drops alpha; RGB -> L is
  Pillow's ITU-R 601-2 luma in 16-bit fixed point (``L24`` in its
  ``Convert.c``); a palette converts through its RGB entries. Anything
  else (16-bit or sub-byte samples, interlacing, gray + alpha, a bad CRC)
  raises ``ValueError``.
* :func:`resize_bilinear` is ``Image.resize(size, Image.BILINEAR)`` on
  uint8 (Pillow's ``Resample.c``), and :func:`resize` with ``"lanczos"``
  is ``Image.LANCZOS`` (a 3-lobe windowed sinc): a separable filter,
  widened by the scale on a downscale, its coefficients normalised and
  rounded to 22-bit fixed point, the horizontal pass first into uint8,
  then the vertical pass; a pass whose size does not change is skipped.
  :func:`resize_bilinear_batch` gives the same for a stack of images in
  one pass each way: a pass is a float64 matrix product with the
  fixed-point coefficients, exact because every sum stays below 2^53;
  :func:`resize_bilinear_tensor` gives it on a tensor's own device (the
  card's decoded batches), summing the gathered taps in int64.

The Average and Paeth row filters depend on the byte to their left, so
they are undone in a Python loop over the row; None, Sub and Up are
vectorised. The port's own writer (``utils/images.py:png_bytes``) uses
filter 0 alone.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib

import numpy as np
import torch

from multiple_objects_gan_tpu_torch.utils.images import PNG_SIGNATURE

_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}      # colour type -> samples a pixel
_PRECISION_BITS = 32 - 8 - 2               # Resample.c's 8-bit precision


def _chunks(data: bytes):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(body, zlib.crc32(kind)) != crc:
            raise ValueError(f"broken PNG chunk {kind!r} (length or CRC)")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("truncated PNG file (no IEND)")


def _unfilter_loop(line: bytes, prev: bytes, bpp: int, paeth: bool
                   ) -> bytes:
    """Undo the Average (paeth=False) or Paeth row filter."""
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if not paeth:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return bytes(cur)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {data.size} bytes, "
                         f"expected {h * (stride + 1)}")
    data = data.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(data[y, 0]), data[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:        # Sub: a running sum, mod 256, per channel
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:        # Up
            out[y] = line + prev
        elif kind in (3, 4):   # Average, Paeth
            out[y] = np.frombuffer(_unfilter_loop(
                line.tobytes(), prev.tobytes(), bpp, kind == 4), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        prev = out[y]
    return out


def decode_png(data: bytes) -> tuple[np.ndarray, int, np.ndarray | None]:
    """PNG bytes -> (samples (H, W, channels) uint8, colour type, palette
    (n, 3) uint8 or None)."""
    header, idat, palette = None, [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype} (8-bit types 0, 2, 3, 6 are read)")
    if interlace:
        raise ValueError("unsupported PNG: interlaced")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    ch = _CHANNELS[ctype]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    return pixels.reshape(h, w, ch), ctype, palette


def _luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L (Convert.c ``L24``): ITU-R 601-2 in 16-bit fixed
    point, rounded."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def convert(pixels: np.ndarray, ctype: int, palette, mode: str
            ) -> np.ndarray:
    """:func:`decode_png`'s samples -> ``mode`` "L" (H, W) or "RGB"
    (H, W, 3) uint8, as Pillow's ``Image.convert`` gives them."""
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)   # Pillow's palette is 256 long
        table[:len(palette)] = palette
        rgb = table[pixels[..., 0]]
    elif ctype == 0:
        return pixels[..., 0] if mode == "L" else np.repeat(pixels, 3, -1)
    else:
        rgb = pixels[..., :3]
    if mode == "RGB":
        return np.ascontiguousarray(rgb)
    if mode == "L":
        return _luma(rgb)
    raise ValueError(f"convert to 'L' or 'RGB', not {mode!r}")


def read_png(path: str, mode: str) -> np.ndarray:
    """``Image.open(path).convert(mode)`` as uint8: (H, W) for "L",
    (H, W, 3) for "RGB"."""
    with open(path, "rb") as f:
        data = f.read()
    return convert(*decode_png(data), mode)


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x *= math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


# Resample.c's filters: name -> (filter, support)
FILTERS = {"bilinear": (_bilinear, 1.0), "lanczos": (_lanczos, 3.0)}


def _coefficients(in_size: int, out_size: int, resample: str = "bilinear"):
    """Resample.c ``precompute_coeffs`` for ``resample`` (a key of
    :data:`FILTERS`) and ``normalize_coeffs_8bpc``: per output index the
    first input index, the tap count and the fixed-point weights
    (out_size, ksize) int64."""
    filt, base_support = FILTERS[resample]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    count = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [filt((x + xmin - center + 0.5) * (1.0 / filterscale))
              for x in range(xmax)]
        ww = 0.0
        for w in ws:
            ww += w
        for x, w in enumerate(ws):
            k = w / ww if ww != 0.0 else w
            kk[xx, x] = int((-0.5 if k < 0 else 0.5)
                            + k * (1 << _PRECISION_BITS))
        first[xx], count[xx] = xmin, xmax
    return first, count, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int,
                   resample: str = "bilinear") -> np.ndarray:
    """One pass of Resample.c over ``axis`` (0: rows, 1: columns) of an
    (H, W, C) uint8 image, into uint8."""
    first, count, kk = _coefficients(img.shape[axis], out_size, resample)
    taps = first[:, None] + np.arange(kk.shape[1])[None, :]
    taps = np.minimum(taps, img.shape[axis] - 1)   # their weights are 0
    kk = np.where(np.arange(kk.shape[1])[None, :] < count[:, None], kk, 0)
    src = np.take(img.astype(np.int64), taps, axis=axis)  # (.., out, k, ..)
    if axis == 0:
        acc = (src * kk[:, :, None, None]).sum(axis=1)
    else:
        acc = (src * kk[None, :, :, None]).sum(axis=2)
    acc = (acc + (1 << (_PRECISION_BITS - 1))) >> _PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, size: tuple[int, int],
           resample: str = "bilinear") -> np.ndarray:
    """``Image.fromarray(img).resize(size, Image.BILINEAR)`` (or
    ``Image.LANCZOS`` for ``resample="lanczos"``) for uint8 (H, W) or
    (H, W, C); ``size`` is (width, height), as PIL takes it."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize takes uint8, got {img.dtype}")
    w, h = size
    x = img[..., None] if img.ndim == 2 else img
    if x.shape[1] != w:
        x = _resample_axis(x, w, 1, resample)
    if x.shape[0] != h:
        x = _resample_axis(x, h, 0, resample)
    return x[..., 0] if img.ndim == 2 else x


def resize_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(img).resize(size, Image.BILINEAR)`` for uint8
    (H, W) or (H, W, C); ``size`` is (width, height), as PIL takes it."""
    return resize(img, size, "bilinear")


@functools.lru_cache(maxsize=32)
def _dense_coefficients(in_size: int, out_size: int,
                        resample: str = "bilinear") -> np.ndarray:
    """The fixed-point coefficients of :func:`_coefficients` as an
    (out_size, in_size) float64 matrix."""
    first, count, kk = _coefficients(in_size, out_size, resample)
    m = np.zeros((out_size, in_size))
    for o in range(out_size):
        m[o, first[o]:first[o] + count[o]] = kk[o, :count[o]]
    return m


def _dense_pass(x: np.ndarray, m: np.ndarray, spec: str) -> np.ndarray:
    acc = np.einsum(spec, m, x, optimize=True) + (1 << (_PRECISION_BITS - 1))
    return np.clip(np.floor(acc / (1 << _PRECISION_BITS)), 0, 255)


def resize_bilinear_batch(images: np.ndarray, size: tuple[int, int]
                          ) -> np.ndarray:
    """:func:`resize_bilinear` of every image of a uint8 (N, H, W, C)
    stack, bit for bit; ``size`` is (width, height)."""
    if images.dtype != np.uint8:
        raise ValueError(f"resize_bilinear_batch takes uint8, got "
                         f"{images.dtype}")
    w, h = size
    x = images.astype(np.float64)
    if x.shape[2] != w:
        x = _dense_pass(x, _dense_coefficients(x.shape[2], w),
                        "ow,nhwc->nhoc")
    if x.shape[1] != h:
        x = _dense_pass(x, _dense_coefficients(x.shape[1], h),
                        "oh,nhwc->nowc")
    return x.astype(np.uint8)


@functools.lru_cache(maxsize=32)
def _taps(in_size: int, out_size: int, resample: str = "bilinear"):
    """:func:`_coefficients` as (out_size, ksize) input indices (clamped;
    their weights past the tap count are 0) and weights."""
    first, count, kk = _coefficients(in_size, out_size, resample)
    k = np.arange(kk.shape[1])
    taps = np.minimum(first[:, None] + k[None, :], in_size - 1)
    return taps, np.where(k[None, :] < count[:, None], kk, 0)


def resize_bilinear_tensor(images: torch.Tensor, size: tuple[int, int]
                           ) -> torch.Tensor:
    """:func:`resize_bilinear_batch` of a uint8 (N, H, W, C) tensor on its
    own device (the card's decoded batches stay there), bit for bit: each
    pass gathers its taps and sums them with the fixed-point weights in
    int64."""
    if images.dtype != torch.uint8:
        raise ValueError(f"resize_bilinear_tensor takes uint8, got "
                         f"{images.dtype}")
    w, h = size
    x = images.long()
    for axis, out in ((2, w), (1, h)):
        if x.shape[axis] == out:
            continue
        taps, kk = _taps(x.shape[axis], out)
        src = x.index_select(axis, torch.from_numpy(taps.reshape(-1)).to(
            x.device))
        shape = list(x.shape)
        shape[axis:axis + 1] = list(taps.shape)
        weights = torch.from_numpy(kk).to(x.device).view(
            list(taps.shape) + [1] * (x.ndim - axis - 1))
        acc = (src.view(shape) * weights).sum(dim=axis + 1)
        x = ((acc + (1 << (_PRECISION_BITS - 1))) >> _PRECISION_BITS).clamp(
            0, 255)
    return x.to(torch.uint8)
