"""Baseline JPEG in numpy: the port's plain codec and nvjpeg's oracle.

The JAX package reads and writes COCO's JPEGs with PIL
(``Image.open(p).convert("RGB")``, ``Image.fromarray(a).save(p)``); the
card's machine has no PIL and no libjpeg, so the port carries its own codec
and reproduces libjpeg-turbo's arithmetic, which PIL links, bit for bit:

* :func:`decode_jpeg` reads baseline and extended sequential Huffman files
  (SOF0/SOF1) of 8-bit samples, 1 or 3 components, sampled 4:4:4, 4:2:2 or
  4:2:0, with or without restart intervals, interleaved or not, of any size.
  It dequantizes, runs the integer "islow" IDCT (``jidctint.c``), upsamples
  chroma with libjpeg's "fancy" triangle filters and their rounding biases
  (``jdsample.c`` ``h2v1``/``h2v2_fancy_upsample``) and converts YCbCr to
  RGB with the fixed-point tables of ``jdcolor.c``. It returns RGB uint8
  (H, W, 3), as ``convert("RGB")`` gives it: a grayscale file is repeated
  to three channels. Progressive, arithmetic-coded, lossless, 12-bit and
  4-component (CMYK/YCCK) files, and other samplings, raise ``ValueError``
  naming the file.
* :func:`encode_jpeg` writes what ``Image.fromarray(a).save(p)`` writes
  for uint8 RGB (or gray) at its defaults: quality 75, 4:2:0, the standard
  Huffman tables, ``jccolor.c``'s fixed-point RGB -> YCbCr, ``jcsample.c``'s
  h2v2 downsample with its alternating bias, edge replication to whole
  blocks, the islow FDCT (``jfdctint.c``) and libjpeg-turbo's reciprocal
  quantizer (``jcdctmgr.c``). The quantized coefficients are PIL's, so the
  file decodes to the pixels of PIL's own file; header bytes may differ.

Transforms and colour passes are vectorised over every block of a plane;
the Huffman coder is a Python loop over symbols, reading 16-bit windows
precomputed for every bit position. It is fast enough for small sets (a
268x268 image decodes in tens of milliseconds); on the card
``data/nvjpeg.py`` does the work.
"""

from __future__ import annotations

import functools
import os
import re

import numpy as np

# zigzag position k -> natural (row-major) index of the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# the islow transforms' constants (jidctint.c / jfdctint.c), CONST_BITS 13
CONST_BITS = 13
PASS1_BITS = 2
F0_298 = 2446
F0_390 = 3196
F0_541 = 4433
F0_765 = 6270
F0_899 = 7373
F1_175 = 9633
F1_501 = 12299
F1_847 = 15137
F1_961 = 16069
F2_053 = 16819
F2_562 = 20995
F3_072 = 25172

# Annex K's example tables: luminance and chrominance quantizers (natural
# order) and the standard Huffman tables (bits, values), jcparam.c
STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99])
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
             bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))
DEFAULT_QUALITY = 75
SAMPLINGS = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2)}

_END_OF_SCAN = re.compile(rb"\xff[^\x00\xd0-\xd7]")
_RESTART = re.compile(rb"\xff[\xd0-\xd7]")
_REFUSED_SOF = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical",
    0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded",
    0xCE: "arithmetic-coded", 0xCF: "arithmetic-coded"}


# --------------------------------------------------------------- transforms

def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _idct_pass(d, shift: int):
    """One 1-D pass of jpeg_idct_islow over the last axis of int64 ``d``
    (..., 8): the even part from inputs 0, 2, 4, 6, the odd part from 1, 3,
    5, 7, each output DESCALEd by ``shift``."""
    z2, z3 = d[..., 2], d[..., 6]
    z1 = (z2 + z3) * F0_541
    tmp2 = z1 - z3 * F1_847
    tmp3 = z1 + z2 * F0_765
    tmp0 = (d[..., 0] + d[..., 4]) << CONST_BITS
    tmp1 = (d[..., 0] - d[..., 4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F1_175
    t0, t1, t2, t3 = t0 * F0_298, t1 * F2_053, t2 * F3_072, t3 * F1_501
    z1, z2 = z1 * -F0_899, z2 * -F2_562
    z3, z4 = z3 * -F1_961 + z5, z4 * -F0_390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([_descale(o, shift) for o in out], axis=-1)


def _idct_range_limit(v):
    """libjpeg's post-IDCT range limit: (v + 128) clamped to 0..255 after
    masking to 10 bits (the table of jdmaster.c prepare_range_limit_table)."""
    x = v & 1023
    return np.where(x < 128, x + 128, np.where(
        x < 512, 255, np.where(x < 896, 0, x - 896))).astype(np.uint8)


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Dequantize and inverse-transform (N, 8, 8) coefficients (natural
    order) with the (8, 8) quantizer: (N, 8, 8) uint8 samples, bit for bit
    libjpeg-turbo's ``jpeg_idct_islow``."""
    d = coefs.astype(np.int64) * quant.astype(np.int64)
    # pass 1 over the columns (the coefficient rows), into the workspace
    ws = _idct_pass(np.swapaxes(d, -1, -2), CONST_BITS - PASS1_BITS)
    ws = np.swapaxes(ws, -1, -2)
    # pass 2 over the rows
    out = _idct_pass(ws, CONST_BITS + PASS1_BITS + 3)
    return _idct_range_limit(out)


def _fdct_pass(d, first: bool):
    """One 1-D pass of jpeg_fdct_islow over the last axis of int64 ``d``."""
    tmp0, tmp7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    tmp1, tmp6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    tmp2, tmp5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    tmp3, tmp4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    shift = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS
    out = [None] * 8
    if first:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, PASS1_BITS)
    z1 = (tmp12 + tmp13) * F0_541
    out[2] = _descale(z1 + tmp13 * F0_765, shift)
    out[6] = _descale(z1 - tmp12 * F1_847, shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F1_175
    tmp4, tmp5 = tmp4 * F0_298, tmp5 * F2_053
    tmp6, tmp7 = tmp6 * F3_072, tmp7 * F1_501
    z1, z2 = z1 * -F0_899, z2 * -F2_562
    z3, z4 = z3 * -F1_961 + z5, z4 * -F0_390 + z5
    out[7] = _descale(tmp4 + z1 + z3, shift)
    out[5] = _descale(tmp5 + z2 + z4, shift)
    out[3] = _descale(tmp6 + z2 + z3, shift)
    out[1] = _descale(tmp7 + z1 + z4, shift)
    return np.stack(out, axis=-1)


def fdct_islow(samples: np.ndarray) -> np.ndarray:
    """(N, 8, 8) uint8 samples -> (N, 8, 8) int64 DCT coefficients scaled
    by 8, libjpeg-turbo's ``jpeg_fdct_islow`` on samples minus 128."""
    d = samples.astype(np.int64) - 128
    d = _fdct_pass(d, first=True)                                # rows
    d = _fdct_pass(np.swapaxes(d, -1, -2), first=False)          # columns
    return np.swapaxes(d, -1, -2)


def _reciprocal(divisor: int):
    """jcdctmgr.c ``compute_reciprocal`` for 16-bit DCT elements: the
    (reciprocal, correction, shift) of one divisor."""
    if divisor == 1:
        return 1, 0, 0
    b = divisor.bit_length() - 1
    r = 16 + b
    fq, fr = divmod(1 << r, divisor)
    c = divisor // 2
    if fr == 0:
        fq >>= 1
        r -= 1
    elif fr <= divisor // 2:
        c += 1
    else:
        fq += 1
    return fq, c, r - 16


def quantize(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 8, 8) FDCT output -> quantized coefficients, as libjpeg-turbo's
    ``quantize`` divides by ``quant * 8`` with reciprocals (the C and SIMD
    quantizers agree)."""
    recip = np.array([[_reciprocal(int(q) << 3) for q in row]
                      for row in quant.reshape(8, 8)], np.int64)
    rec, corr, shift = recip[..., 0], recip[..., 1], recip[..., 2]
    mag = np.abs(coefs).astype(np.int64)
    q = ((mag + corr) * rec) >> (shift + 16)
    return np.where(coefs < 0, -q, q)


# ------------------------------------------------------------------ colours

def _fix(x: float, bits: int = 16) -> int:
    return int(x * (1 << bits) + 0.5)


_I = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _I + (1 << 15)) >> 16
_CB_B = (_fix(1.77200) * _I + (1 << 15)) >> 16
_CR_G = -_fix(0.71414) * _I
_CB_G = -_fix(0.34414) * _I + (1 << 15)


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c ``ycc_rgb_convert`` on uint8 planes -> (H, W, 3) uint8."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c ``rgb_ycc_convert``: uint8 (H, W, 3) -> Y, Cb, Cr uint8."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
         + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + off
          + half - 1) >> 16
    cr = (_fix(0.5) * r + off + half - 1 - _fix(0.41869) * g
          - _fix(0.08131) * b) >> 16
    return y.astype(np.uint8), cb.astype(np.uint8), cr.astype(np.uint8)


def _upsample_h2(x: np.ndarray, width: int, bias_even: int, bias_odd: int,
                 shift: int) -> np.ndarray:
    """Horizontal half of the fancy upsamplers on the first ``width``
    columns of int64 ``x``: out[2j] = (3 x[j] + x[j-1] + bias_even) >> shift,
    out[2j+1] = (3 x[j] + x[j+1] + bias_odd) >> shift, edges replicated."""
    x = x[:, :width]
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * width), np.int64)
    out[:, 0::2] = (3 * x + left + bias_even) >> shift
    out[:, 1::2] = (3 * x + right + bias_odd) >> shift
    return out


def _upsample(plane: np.ndarray, hf: int, vf: int, dw: int, dh: int,
              fancy: bool = True) -> np.ndarray:
    """jdsample.c for one component: ``plane`` holds at least (dh, dw)
    decoded samples; (hf, vf) the factors up to the full size. Fancy
    triangle filters where libjpeg takes them (more than 2 columns), box
    replication otherwise."""
    x = plane[:dh, :dw].astype(np.int64)
    if (hf, vf) == (1, 1):
        return x
    if dw <= 2 or not fancy:
        return np.repeat(np.repeat(x, vf, axis=0), hf, axis=1)
    if vf == 1:                                         # h2v1
        return _upsample_h2(x, dw, 1, 2, 2)
    above = np.concatenate([x[:1], x[:-1]], axis=0)     # h2v2
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * dh, 2 * dw), np.int64)
    out[0::2] = _upsample_h2(3 * x + above, dw, 8, 7, 4)
    out[1::2] = _upsample_h2(3 * x + below, dw, 8, 7, 4)
    return out


# ------------------------------------------------------------------ Huffman

def _huffman_codes(bits, values):
    """Canonical (code, length) for each symbol of a DHT table."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


@functools.lru_cache(maxsize=32)
def _lookup(bits: tuple, values: tuple) -> list:
    """A 65536-entry table from a 16-bit window to length << 8 | symbol, -1
    where no code starts."""
    table = np.full(1 << 16, -1, np.int64)
    for sym, (code, length) in _huffman_codes(bits, values).items():
        lo = code << (16 - length)
        table[lo:lo + (1 << (16 - length))] = (length << 8) | sym
    return table.tolist()


def _windows(segment: bytes) -> tuple[list, int]:
    """Every bit position's next 16 bits of an unstuffed entropy-coded
    segment (past its end, 1 bits, as the encoder pads), and the bit count."""
    bits = np.unpackbits(np.frombuffer(segment, np.uint8))
    n = bits.size
    bits = np.concatenate([bits, np.ones(32, np.uint8)]).astype(np.int64)
    win = np.zeros(n + 16, np.int64)
    for k in range(16):
        win += bits[k:k + n + 16] << (15 - k)
    return win.tolist(), n


def _extend(v: int, s: int) -> int:
    return v if v >= 1 << (s - 1) else v - (1 << s) + 1


def _decode_segment(segment: bytes, units, tables, out, name: str) -> None:
    """Huffman-decode the blocks ``units`` [(component, block offset)] of
    one restart interval into the flat zigzag coefficient lists ``out``."""
    win, nbits = _windows(segment)
    pos = 0
    pred = {}
    for comp, base in units:
        dc, ac = tables[comp]
        coefs = out[comp]
        e = dc[win[pos]]
        if e < 0:
            raise ValueError(f"{name}: corrupt JPEG data (bad DC code)")
        pos += e >> 8
        s = e & 255
        diff = 0
        if s:
            diff = _extend(win[pos] >> (16 - s), s)
            pos += s
        p = pred.get(comp, 0) + diff
        pred[comp] = p
        coefs[base] = p
        k = 1
        while k < 64:
            e = ac[win[pos]]
            if e < 0:
                raise ValueError(f"{name}: corrupt JPEG data (bad AC code)")
            pos += e >> 8
            rs = e & 255
            s = rs & 15
            if s:
                k += rs >> 4
                if k > 63:
                    raise ValueError(f"{name}: corrupt JPEG data (run past "
                                     "the block's end)")
                coefs[base + k] = _extend(win[pos] >> (16 - s), s)
                pos += s
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break
        if pos > nbits:
            raise ValueError(f"{name}: truncated JPEG data")


# ------------------------------------------------------------------ decoder

class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq


def _refuse(name: str, what: str):
    raise ValueError(f"{name}: unsupported JPEG ({what}); baseline "
                     "sequential 8-bit files with 1 or 3 components are read")


def decode_jpeg(data: bytes, name: str = "<bytes>", fancy: bool = True
                ) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, as PIL 12's
    ``Image.open(...).convert("RGB")`` (libjpeg-turbo) gives it. ``fancy``
    False replicates each chroma sample instead (libjpeg's
    ``do_fancy_upsampling = FALSE``), the yardstick for decoders without
    the triangle filter."""
    return _parse(data, name, decode=True, fancy=fancy)


def probe_jpeg(data: bytes, name: str = "<bytes>") -> tuple[int, int, int]:
    """(height, width, components) of a JPEG this codec takes, from its
    markers alone (scans are skipped, not decoded); raises ``ValueError``
    as :func:`decode_jpeg` does for a kind it refuses or a file that ends
    before its EOI marker."""
    return _parse(data, name, decode=False)


def _parse(data: bytes, name: str, decode: bool, fancy: bool = True):
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    qt, dht = {}, {}
    comps, size, restart = None, None, 0
    jfif, adobe = False, None
    coefs = None
    pos = 2
    while True:
        if pos + 2 > len(data):
            raise ValueError(f"{name}: truncated JPEG file (no EOI)")
        if data[pos] != 0xFF:
            raise ValueError(f"{name}: corrupt JPEG file (no marker at byte "
                             f"{pos})")
        while pos + 2 < len(data) and data[pos + 1] == 0xFF:
            pos += 1
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD8 or marker == 0x01:
            continue
        length = int.from_bytes(data[pos:pos + 2], "big")
        body = data[pos + 2:pos + length]
        if len(body) != length - 2:
            raise ValueError(f"{name}: truncated JPEG file (marker "
                             f"0x{marker:02X})")
        pos += length
        if marker in _REFUSED_SOF:
            _refuse(name, _REFUSED_SOF[marker])
        if marker == 0xCC:
            _refuse(name, "arithmetic-coded")
        if marker in (0xC0, 0xC1):
            if body[0] != 8:
                _refuse(name, f"{body[0]}-bit samples")
            height = int.from_bytes(body[1:3], "big")
            width = int.from_bytes(body[3:5], "big")
            nf = body[5]
            if nf not in (1, 3):
                _refuse(name, f"{nf} components (CMYK/YCCK)")
            if height == 0 or width == 0:
                _refuse(name, "no height in the frame header (DNL)")
            comps = [_Component(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                                body[7 + 3 * i] & 15, body[8 + 3 * i])
                     for i in range(nf)]
            size = (height, width)
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mcux = -(-width // (8 * hmax))
            mcuy = -(-height // (8 * vmax))
            for c in comps:
                c.bw, c.bh = mcux * c.h, mcuy * c.v
            coefs = [[0] * (c.bw * c.bh * 64) for c in comps]
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                n = sum(counts)
                dht[(tc, th)] = _lookup(tuple(counts),
                                       tuple(body[i + 17:i + 17 + n]))
                i += 17 + n
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    vals = np.frombuffer(body[i + 1:i + 129], ">u2")
                    i += 129
                else:
                    vals = np.frombuffer(body[i + 1:i + 65], np.uint8)
                    i += 65
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = vals
                qt[tq] = q.reshape(8, 8)
        elif marker == 0xDD:
            restart = int.from_bytes(body[:2], "big")
        elif marker == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:
            if comps is None:
                raise ValueError(f"{name}: corrupt JPEG file (scan before "
                                 "the frame header)")
            if not decode:
                m = _END_OF_SCAN.search(data, pos)
                pos = m.start() if m else len(data)
                continue
            pos = _read_scan(data, pos, body, comps, size, dht, restart,
                             coefs, name)
    if comps is None:
        raise ValueError(f"{name}: corrupt JPEG file (no frame header)")
    if not decode:
        _check_sampling(comps, name)
        return size[0], size[1], len(comps)
    return _reconstruct(comps, coefs, qt, size, jfif, adobe, name, fancy)


def _read_scan(data, pos, header, comps, size, dht, restart, coefs, name
               ) -> int:
    """Decode one scan whose header is ``header`` and whose entropy-coded
    data starts at ``pos``; returns the position of the next marker."""
    ns = header[0]
    sel = []
    for i in range(ns):
        cid, tt = header[1 + 2 * i], header[2 + 2 * i]
        ci = next((k for k, c in enumerate(comps) if c.id == cid), None)
        if ci is None:
            raise ValueError(f"{name}: corrupt JPEG file (scan names "
                             f"component {cid})")
        key_dc, key_ac = (0, tt >> 4), (1, tt & 15)
        if key_dc not in dht or key_ac not in dht:
            raise ValueError(f"{name}: corrupt JPEG file (missing Huffman "
                             "table)")
        sel.append((ci, dht[key_dc], dht[key_ac]))
    ss, se = header[1 + 2 * ns], header[2 + 2 * ns]
    if ss != 0 or se != 63:
        _refuse(name, "spectral selection")
    m = _END_OF_SCAN.search(data, pos)
    end = m.start() if m else len(data)
    segments = [s.replace(b"\xff\x00", b"\xff")
                for s in _RESTART.split(data[pos:end])]
    units = _scan_units(comps, size, sel)
    mcus = len(units)
    interval = restart or mcus
    tables = {ci: (dc, ac) for ci, dc, ac in sel}
    n_int = -(-mcus // interval)
    if len(segments) < n_int:
        raise ValueError(f"{name}: truncated JPEG data ({len(segments)} of "
                         f"{n_int} restart intervals)")
    for k in range(n_int):
        flat = [u for mcu in units[k * interval:(k + 1) * interval]
                for u in mcu]
        _decode_segment(segments[k], flat, tables, coefs, name)
    return end


def _scan_units(comps, size, sel):
    """The scan's MCUs in order, each a list of (component, coefficient
    offset) of its blocks: an interleaved scan's MCU holds each component's
    h x v blocks; a one-component scan's MCU is one block, over the
    component's own block grid (A.2.2)."""
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    if len(sel) == 1:
        ci = sel[0][0]
        c = comps[ci]
        bx = -(-_ceil_div(size[1] * c.h, hmax) // 8)
        by = -(-_ceil_div(size[0] * c.v, vmax) // 8)
        return [[(ci, (y * c.bw + x) * 64)] for y in range(by)
                for x in range(bx)]
    mcux = comps[0].bw // comps[0].h
    mcuy = comps[0].bh // comps[0].v
    units = []
    for my in range(mcuy):
        for mx in range(mcux):
            mcu = []
            for ci, _, _ in sel:
                c = comps[ci]
                for v in range(c.v):
                    for h in range(c.h):
                        mcu.append((ci, ((my * c.v + v) * c.bw
                                         + mx * c.h + h) * 64))
            units.append(mcu)
    return units


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _check_sampling(comps, name: str) -> None:
    """Refuse samplings other than 4:4:4, 4:2:2 and 4:2:0 (and gray)."""
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    for c in comps:
        hf, vf = hmax // c.h, vmax // c.v
        if (hf * c.h, vf * c.v) != (hmax, vmax) or (hf, vf) not in (
                (1, 1), (2, 1), (2, 2)):
            _refuse(name, "sampling " + ", ".join(
                f"{k.h}x{k.v}" for k in comps))


def _reconstruct(comps, coefs, qt, size, jfif, adobe, name, fancy=True
                 ) -> np.ndarray:
    """Inverse-transform, upsample and colour-convert the decoded
    coefficients into (H, W, 3) uint8."""
    height, width = size
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    _check_sampling(comps, name)
    planes = []
    for c, flat in zip(comps, coefs):
        if c.tq not in qt:
            raise ValueError(f"{name}: corrupt JPEG file (missing "
                             f"quantization table {c.tq})")
        hf, vf = hmax // c.h, vmax // c.v
        zz = np.array(flat, np.int64).reshape(-1, 64)
        nat = np.empty_like(zz)
        nat[:, ZIGZAG] = zz
        blocks = idct_islow(nat.reshape(-1, 8, 8), qt[c.tq])
        plane = blocks.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(c.bh * 8, c.bw * 8)
        dw = _ceil_div(width * c.h, hmax)
        dh = _ceil_div(height * c.v, vmax)
        planes.append(_upsample(plane, hf, vf, dw, dh, fancy)[
            :height, :width])
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=-1)
    ids = tuple(c.id for c in comps)
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = ids == (82, 71, 66)
    if rgb:
        return np.stack(planes, -1).astype(np.uint8)
    return ycc_to_rgb(*planes)


def read_jpeg(path: str) -> np.ndarray:
    """``Image.open(path).convert("RGB")`` as (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_jpeg(data, path)


# ------------------------------------------------------------------ encoder

def quality_tables(quality: int = DEFAULT_QUALITY):
    """jcparam.c ``jpeg_set_quality`` (force_baseline): the luminance and
    chrominance quantizers (8, 8) for ``quality``."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [np.clip((t * scale + 50) // 100, 1, 255).reshape(8, 8)
            for t in (STD_LUMA_Q, STD_CHROMA_Q)]


def _pad_edges(x: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """``x`` grown to (rows, cols) by replicating its last row and column
    (jcsample.c expand_right_edge, jcprepct.c expand_bottom_edge)."""
    return np.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])),
                  mode="edge")


def _downsample(x: np.ndarray, h: int, v: int) -> np.ndarray:
    """jcsample.c h2v1/h2v2 downsample of an even-sized plane, with the
    alternating bias (h2v1: 0, 1, ...; h2v2: 1, 2, ...) along each row."""
    x = x.astype(np.int64)
    cols = x.shape[1] // 2
    if v == 1:
        bias = np.arange(cols) % 2
        return ((x[:, 0::2] + x[:, 1::2] + bias) >> 1).astype(np.uint8)
    bias = 1 + np.arange(cols) % 2
    s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
    return ((s + bias) >> 2).astype(np.uint8)


def _to_blocks(plane: np.ndarray) -> np.ndarray:
    rows, cols = plane.shape
    return plane.reshape(rows // 8, 8, cols // 8, 8).transpose(
        0, 2, 1, 3).reshape(-1, 8, 8)


class _BitWriter:
    def __init__(self):
        self.parts = []

    def put(self, code: int, length: int) -> None:
        if length:
            self.parts.append(format(code, f"0{length}b"))

    def bytes(self) -> bytes:
        s = "".join(self.parts)
        s += "1" * (-len(s) % 8)
        if not s:
            return b""
        raw = int(s, 2).to_bytes(len(s) // 8, "big")
        return raw.replace(b"\xff", b"\xff\x00")


def _category(v: int) -> tuple[int, int]:
    """(size category, its extra bits) of a coefficient value."""
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def encode_jpeg(img: np.ndarray, quality: int = DEFAULT_QUALITY,
                subsampling: str = "4:2:0") -> bytes:
    """uint8 (H, W, 3) RGB, or (H, W) / (H, W, 1) gray, -> JPEG bytes whose
    coefficients are those of ``Image.fromarray(img).save(p,
    quality=quality)`` (PIL's default subsampling is 4:2:0). The writers
    save at the defaults, PIL's; the other qualities and samplings are
    there for the tests, which hold the quantizer tables and the sampling
    factors against PIL's, and for ``chip_smoke.py``'s 4:4:4 and 4:2:2
    files."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_jpeg takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        planes, sampling = [img], [(1, 1)]
    elif img.ndim == 3 and img.shape[-1] == 3:
        if subsampling not in SAMPLINGS:
            raise ValueError(f"subsampling {subsampling!r} is not one of "
                             f"{sorted(SAMPLINGS)}")
        planes = list(rgb_to_ycc(img))
        sampling = [SAMPLINGS[subsampling], (1, 1), (1, 1)]
    else:
        raise ValueError(f"encode_jpeg takes (H, W[, 1 or 3]), got "
                         f"{img.shape}")
    height, width = img.shape[:2]
    hmax, vmax = sampling[0]
    mcux = _ceil_div(width, 8 * hmax)
    mcuy = _ceil_div(height, 8 * vmax)
    luma_q, chroma_q = quality_tables(quality)
    blocks = []
    for ci, (plane, (h, v)) in enumerate(zip(planes, sampling)):
        bw = _ceil_div(width * h, 8 * hmax)        # width_in_blocks
        bh = _ceil_div(height * v, 8 * vmax)
        if (h, v) != (hmax, vmax):
            fh, fv = hmax // h, vmax // v
            plane = _pad_edges(plane, _ceil_div(height, fv) * fv,
                               bw * 8 * fh)
            plane = _downsample(plane, fh, fv)
        plane = _pad_edges(plane, bh * 8, bw * 8)[:bh * 8, :bw * 8]
        q = luma_q if ci == 0 else chroma_q
        coef = quantize(fdct_islow(_to_blocks(plane)), q)
        blocks.append(coef.reshape(bh, bw, 64)[..., ZIGZAG])
    tables = [(_huffman_codes(*DC_LUMA), _huffman_codes(*AC_LUMA)),
              (_huffman_codes(*DC_CHROMA), _huffman_codes(*AC_CHROMA))]
    out = _BitWriter()
    pred = [0] * len(planes)
    zero = np.zeros(64, np.int64)
    for my in range(mcuy):
        for mx in range(mcux):
            for ci, (h, v) in enumerate(sampling):
                grid = blocks[ci]
                dc_codes, ac_codes = tables[min(ci, 1)]
                last_dc = None
                for y in range(v):
                    for x in range(h):
                        by, bx = my * v + y, mx * h + x
                        if by < grid.shape[0] and bx < grid.shape[1]:
                            blk = grid[by, bx]
                        else:     # a dummy block: the previous DC, no AC
                            blk = zero.copy()
                            blk[0] = last_dc
                        last_dc = int(blk[0])
                        _encode_block(out, blk, pred, ci, dc_codes,
                                      ac_codes)
    return _file(out.bytes(), planes, sampling, (height, width),
                 (luma_q, chroma_q))


def _encode_block(out: _BitWriter, blk, pred, ci, dc_codes, ac_codes):
    dc = int(blk[0])
    s, bits = _category(dc - pred[ci])
    pred[ci] = dc
    out.put(*dc_codes[s])
    out.put(bits, s)
    nz = np.flatnonzero(blk[1:]) + 1
    k = 1
    for idx in nz.tolist():
        run = idx - k
        while run > 15:
            out.put(*ac_codes[0xF0])
            run -= 16
        s, bits = _category(int(blk[idx]))
        out.put(*ac_codes[(run << 4) | s])
        out.put(bits, s)
        k = idx + 1
    if k < 64:
        out.put(*ac_codes[0x00])


def _file(scan: bytes, planes, sampling, size, quants) -> bytes:
    height, width = size
    parts = [b"\xff\xd8",
             _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tq, q in enumerate(quants[:1 if len(planes) == 1 else 2]):
        parts.append(_segment(0xDB, bytes([tq]) + bytes(
            q.reshape(-1)[ZIGZAG].astype(np.uint8).tolist())))
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
    sof += bytes([len(planes)])
    for ci, (h, v) in enumerate(sampling):
        sof += bytes([ci + 1, (h << 4) | v, min(ci, 1)])
    parts.append(_segment(0xC0, sof))
    dht = [(0x00, DC_LUMA), (0x10, AC_LUMA)]
    if len(planes) == 3:
        dht += [(0x01, DC_CHROMA), (0x11, AC_CHROMA)]
    for key, (bits, values) in dht:
        parts.append(_segment(0xC4, bytes([key] + list(bits)) + bytes(values)))
    sos = bytes([len(planes)])
    for ci in range(len(planes)):
        t = min(ci, 1)
        sos += bytes([ci + 1, (t << 4) | t])
    parts.append(_segment(0xDA, sos + b"\x00\x3f\x00"))
    parts += [scan, b"\xff\xd9"]
    return b"".join(parts)


def write_jpeg(path: str, img: np.ndarray, **kwargs) -> None:
    """:func:`encode_jpeg` of ``img`` written to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, **kwargs))
