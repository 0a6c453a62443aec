"""K1's launch sizing (ops/stn_place_cuda.py:place_tile, place_smem_bytes)
and its table algorithm (csrc/stn_place.cu:stn_place_multi_kernel) on the
CPU.

* The channel tile is 16 at the model's shapes, and for every side from 1
  to 64, either element type and 1..MAX_OBJECTS objects a block's output
  values and shared memory stay within the kernel's limits; a side above
  64 raises before anything is launched.
* The algorithm in numpy, float64, from the same hat weights: each output
  row's and column's taps a, b (a missing tap repeating the other with
  weight 0), each object's input rows with taps, staged in whole 16-byte
  chunks into a buffer that is otherwise NaN, then summed dx inside dy,
  objects ascending. It equals the plain version (atol 1e-12), so the
  kernel reads no row it did not stage and drops no tap.

The CUDA kernel runs only on the card; chip_smoke.py phases 3 and 12 hold
it against the plain version there.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multiple_objects_gan_tpu_torch.ops import stn, stn_place_cuda as m


def _boxes(rng, b, o, kind):
    """``service`` (0.2-0.4 wide, inside the canvas), ``padded`` (every
    other item all -1), ``off-canvas`` (sticking out on every side) or
    ``wide`` (wider than the canvas)."""
    lo, hi = (1.0, 1.6) if kind == "wide" else (0.2, 0.4)
    w = rng.uniform(lo, hi, (b, o))
    h = rng.uniform(lo, hi, (b, o))
    if kind in ("off-canvas", "wide"):
        x = rng.uniform(-0.4, 0.9, (b, o))
        y = rng.uniform(-0.4, 0.9, (b, o))
    else:
        x = rng.uniform(0.0, 1.0 - w)
        y = rng.uniform(0.0, 1.0 - h)
    bbox = np.stack([x, y, w, h], -1).astype(np.float32)
    if kind == "padded":
        bbox[::2] = -1.0
    return bbox


# ------------------------------------------------------------------ sizing


def test_place_tile_is_16_at_the_model_shapes():
    assert m.place_tile((16, 16), (16, 16)) == 16     # G, serving
    assert m.place_tile((15, 15), (16, 16)) == 16     # D


@pytest.mark.parametrize("elem_size", [4, 2], ids=["f32", "bf16"])
def test_place_tile_fits_the_kernel_at_every_side(elem_size):
    """For every side from 1 to MAX_SIDE: the block's shared memory within
    MAX_PLACE_SMEM (the card's 227 KB) for 1..MAX_OBJECTS objects; the tile
    halves as sides grow."""
    for side_in in range(1, m.MAX_SIDE + 1):
        for side_out in (1, side_in, m.MAX_SIDE):
            hw_in, hw_out = (side_in, side_in), (side_out, side_out)
            tile = m.place_tile(hw_in, hw_out)
            assert 1 <= tile <= m.PLACE_TILE
            for objects in (1, m.MAX_OBJECTS):
                smem = m.place_smem_bytes(objects, tile, hw_in, hw_out,
                                          elem_size)
                assert smem <= m.MAX_PLACE_SMEM <= 227 * 1024
    assert m.place_tile((32, 32), (32, 32)) == 4
    assert m.place_tile((64, 64), (64, 64)) == 1


def test_place_smem_bytes_counts_the_kernels_words():
    """Three objects at the G shape in float32: tables 3 x (32 + 2) entries
    of 16 bytes, the sums of 16 planes of 256 values in float32, a buffer
    for each object of 16 planes and one 16-byte chunk, and 3 x 16 words of
    row lists; one object stages one buffer, sixteen stage
    PLACE_STAGES."""
    sums = 16 * 256 * 4
    assert m.place_smem_bytes(3, 16, (16, 16), (16, 16), 4) == (
        16 * 3 * 34 + sums + 3 * (16 * 256 + 4) * 4 + 4 * 3 * 16)
    # bf16 at 15x15: 3600 values round up to 450 chunks of 8, plus one
    assert m.place_smem_bytes(3, 16, (15, 15), (16, 16), 2) == (
        16 * 3 * 34 + sums + 3 * (3600 + 8) * 2 + 4 * 3 * 15)
    assert m.place_smem_bytes(1, 16, (16, 16), (16, 16), 4) == (
        16 * 34 + sums + (16 * 256 + 4) * 4 + 4 * 16)
    assert m.place_smem_bytes(16, 16, (16, 16), (16, 16), 4) == (
        16 * 16 * 34 + sums + m.PLACE_STAGES * (16 * 256 + 4) * 4
        + 4 * 16 * 16)
    # sums of an odd count round up to 16 bytes: 5 x 5 x 3 = 75 -> 76
    assert m.place_smem_bytes(1, 3, (5, 5), (5, 5), 4) == (
        16 * 12 + 4 * 76 + (76 + 4) * 4 + 4 * 5)


@pytest.mark.parametrize("in_hw, out_hw", [((65, 16), (16, 16)),
                                           ((16, 16), (16, 65)),
                                           ((65, 65), (65, 65))])
def test_a_side_above_64_raises(in_hw, out_hw):
    feats = torch.zeros((1, 3, 2) + in_hw)
    bbox = torch.full((1, 3, 4), 0.25)
    with pytest.raises(ValueError, match="at most 64 a side"):
        m._place_cuda(feats, bbox, out_hw)
    m.reset_launch_count()
    with pytest.raises(ValueError, match="at most 64 a side"):
        m._check_sides(in_hw, out_hw, "K1")
    assert m.launch_count() == 0


# --------------------------------------------------------------- algorithm


def _entries(w):
    """Each output row's (column's) taps (a, b, wa, wb) from its row of the
    hat-weight matrix, as tap_entry makes them; a = -1 for none."""
    out = []
    for row in w:
        taps = np.nonzero(row)[0]
        assert len(taps) <= 2
        if len(taps) == 0:
            out.append((-1, -1, 0.0, 0.0))
        elif len(taps) == 1:
            out.append((taps[0], taps[0], row[taps[0]], 0.0))
        else:
            out.append((taps[0], taps[1], row[taps[0]], row[taps[1]]))
    return out


def _k1_table_algorithm(feats, bbox, out_hw, elem_size=4):
    """K1 in numpy: per (b, tile of channels), per object, the rows with
    taps copied in whole 16-byte chunks (chunks counted from the start of
    the flat feature array, which the card allocates on 16 bytes) into a
    buffer of NaN, then each output value summed from that buffer."""
    b, o, c, hi, wi = feats.shape
    ho, wo = out_hw
    v = 16 // elem_size
    tile = m.place_tile((hi, wi), out_hw)
    plane = hi * wi
    flat = feats.reshape(-1)
    wy, wx = stn.place_weights(torch.from_numpy(bbox).reshape(b * o, 4),
                               out_hw, (hi, wi))
    wy = wy.double().numpy().reshape(b, o, ho, hi)
    wx = wx.double().numpy().reshape(b, o, wo, wi)
    out = np.zeros((b, c, ho, wo))
    for bi in range(b):
        for c0 in range(0, c, tile):
            cnt = min(tile, c - c0)
            acc = np.zeros((cnt, ho, wo))
            for oi in range(o):
                rows_e, cols_e = _entries(wy[bi, oi]), _entries(wx[bi, oi])
                rows = sorted({p for e in rows_e if e[0] >= 0
                               for p in e[:2]})
                start = ((bi * o + oi) * c + c0) * plane
                stg = np.full(flat.size + v, np.nan)
                for cc in range(cnt):
                    for r in rows:
                        s = start + cc * plane + r * wi
                        lo, hi_ = s // v * v, ((s + wi - 1) // v + 1) * v
                        stg[lo:hi_] = np.pad(flat, (0, v))[lo:hi_]
                f = stg[start:start + cnt * plane].reshape(cnt, hi, wi)
                for i, (ya, yb, wya, wyb) in enumerate(rows_e):
                    if ya < 0:
                        continue
                    for j, (xa, xb, wxa, wxb) in enumerate(cols_e):
                        if xa < 0:
                            continue
                        r0 = wxa * f[:, ya, xa] + wxb * f[:, ya, xb]
                        r1 = wxa * f[:, yb, xa] + wxb * f[:, yb, xb]
                        acc[:, i, j] += wya * r0 + wyb * r1
            out[bi, c0:c0 + cnt] = acc
    return out


KINDS = ["service", "padded", "off-canvas", "wide"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("in_hw, out_hw, c", [
    ((16, 16), (16, 16), 20), ((15, 15), (16, 16), 37), ((7, 23), (16, 12), 5),
    ((32, 32), (32, 32), 6), ((64, 64), (64, 64), 2)])
def test_k1_table_algorithm_matches_the_plain_version(in_hw, out_hw, c, kind):
    rng = np.random.RandomState(13)
    feats = rng.uniform(-1.0, 1.0, (2, 3, c) + in_hw)
    bbox = _boxes(rng, 2, 3, kind)
    want = m.stn_place_multi_plain(torch.from_numpy(feats),
                                   torch.from_numpy(bbox), out_hw).numpy()
    for elem_size in (4, 2):
        got = _k1_table_algorithm(feats, bbox, out_hw, elem_size)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if kind == "padded":
        assert not got[::2].any()
    assert np.abs(want).max() > 0.1          # the case moves real values
