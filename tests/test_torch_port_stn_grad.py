"""The port's place backward (K2 plain version), the autograd Function that
pairs K1 with K2 (K3), and the extract ops, against the JAX package.

* The plain K2 against the Pallas K2 (``stn_pallas.py:137``) in interpret
  mode, atol 1e-5 for gradients in [-1, 1]: the same rounding argument as
  tests/test_torch_port_stn.py (source coordinates near 30, one float32
  ulp ~2e-6, each side rounds them its own way), with sums of a few more
  taps for boxes wider than the canvas.
* The plain K2 against autograd of the plain K1: the same weights on both
  sides, so only the order of the sums differs; atol 1e-6.
* K3 on the CPU: ``torch.autograd.gradcheck`` in float64 (its own
  tolerances), and no gradient for the boxes.
* The extract ops against the JAX ops, atol 1e-5.

The CUDA kernels run only on the card; chip_smoke.py holds them against
these plain versions there.
"""

from __future__ import annotations

import importlib
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import multiple_objects_gan_tpu.ops as jstn
import multiple_objects_gan_tpu.ops.stn_pallas as sp
from multiple_objects_gan_tpu_torch.ops import stn_place_cuda
stn = importlib.import_module("multiple_objects_gan_tpu_torch.ops.stn")

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run the Pallas kernels in interpret mode, as
    tests/test_stn_pallas.py does."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(sp.pl, "pallas_call", patched)


def _boxes(rng, b, o, kind):
    """Boxes of one kind: ``service`` (0.2-0.4 wide, inside the canvas),
    ``padded`` (every other item all -1), ``off-canvas`` (sticking out on
    every side) or ``wide`` (w, h in [1.0, 1.6], wider than the canvas)."""
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


KINDS = ["service", "padded", "off-canvas", "wide"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("in_hw", [(16, 16), (15, 15)])
def test_grad_plain_matches_pallas_k2_interpret(interpret_mode, in_hw, kind):
    rng = np.random.RandomState(KINDS.index(kind) * 100 + in_hw[0])
    b, o, c = 4, 3, 8
    g = rng.uniform(-1.0, 1.0, (b, 16, 16, c)).astype(np.float32)
    bbox = _boxes(rng, b, o, kind)
    want = np.asarray(sp.stn_place_multi_grad_pallas(
        jnp.asarray(g), jnp.asarray(bbox), in_hw))            # (B,O,h,w,C)
    got = stn_place_cuda.stn_place_multi_grad_plain(
        torch.from_numpy(g).permute(0, 3, 1, 2).contiguous(),
        torch.from_numpy(bbox), in_hw)                        # (B,O,C,h,w)
    assert got.shape == (b, o, c) + in_hw
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), want,
                               atol=ATOL)
    if kind == "padded":
        assert torch.count_nonzero(got[::2]) == 0
    assert np.abs(want).max() > 0.1          # the case moves real values


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("in_hw", [(16, 16), (15, 15)])
def test_grad_plain_is_autograd_of_plain_place(in_hw, kind):
    rng = np.random.RandomState(7)
    b, o, c = 3, 3, 5
    bbox = torch.from_numpy(_boxes(rng, b, o, kind))
    feats = torch.from_numpy(rng.randn(b, o, c, *in_hw).astype(np.float32))
    feats.requires_grad_(True)
    g = torch.from_numpy(rng.uniform(-1, 1, (b, c, 16, 16)).astype(np.float32))
    out = stn_place_cuda.stn_place_multi_plain(feats, bbox, (16, 16))
    (want,) = torch.autograd.grad(out, feats, g)
    got = stn_place_cuda.stn_place_multi_grad_plain(g, bbox, in_hw)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("in_hw", [(16, 16), (15, 15), (5, 7)])
def test_k3_gradcheck_float64(in_hw):
    rng = np.random.RandomState(11)
    bbox = _boxes(rng, 2, 3, "off-canvas")
    bbox[1, 2] = -1.0
    bbox = torch.from_numpy(bbox)
    feats = torch.from_numpy(rng.randn(2, 3, 2, *in_hw)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda f: stn_place_cuda.stn_place_multi_nchw(f, bbox, (6, 8)),
        (feats,))


def test_k3_boxes_get_no_gradient_and_backward_is_k2(monkeypatch):
    """The Function's backward goes through the K2 wrapper with a
    contiguous gradient and the saved input size; the boxes get None."""
    calls = []
    real = stn_place_cuda.stn_place_multi_grad_nchw

    def spy(grad, bbox, in_hw):
        calls.append((grad.is_contiguous(), tuple(in_hw)))
        return real(grad, bbox, in_hw)

    monkeypatch.setattr(stn_place_cuda, "stn_place_multi_grad_nchw", spy)
    rng = np.random.RandomState(3)
    bbox = torch.from_numpy(_boxes(rng, 2, 3, "service")).requires_grad_(True)
    feats = torch.randn(2, 3, 4, 15, 15, requires_grad=True)
    out = stn_place_cuda.stn_place_multi_nchw(feats, bbox, (16, 16))
    assert out.grad_fn is not None
    # a non-contiguous cotangent, as a concatenation's backward gives
    g = torch.randn(2, 8, 16, 16)[:, 2:6]
    out.backward(g)
    assert bbox.grad is None
    assert calls == [(True, (15, 15))]
    torch.testing.assert_close(feats.grad, real(g.contiguous(), bbox.detach(),
                                                (15, 15)), atol=0, rtol=0)


def test_k3_matches_jax_gradient_of_the_place():
    """The port's gradient of a scalar of the place against jax.grad of the
    JAX package's ``stn_place_multi`` (XLA path), JAX layout."""
    rng = np.random.RandomState(5)
    feats = rng.uniform(-1, 1, (2, 3, 15, 15, 6)).astype(np.float32)
    bbox = _boxes(rng, 2, 3, "off-canvas")
    wgt = rng.uniform(-1, 1, (2, 16, 16, 6)).astype(np.float32)
    want = np.asarray(jax.grad(lambda f: jnp.sum(jstn.stn_place_multi(
        f, jnp.asarray(bbox), (16, 16)) * wgt))(jnp.asarray(feats)))
    f = torch.from_numpy(feats).requires_grad_(True)
    (stn.stn_place_multi(f, torch.from_numpy(bbox), (16, 16))
     * torch.from_numpy(wgt)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), want, atol=ATOL)


def test_cpu_path_launches_no_kernel():
    stn_place_cuda.reset_launch_count()
    feats = torch.randn(1, 3, 4, 16, 16, requires_grad=True)
    bbox = torch.from_numpy(_boxes(np.random.RandomState(0), 1, 3, "service"))
    stn_place_cuda.stn_place_multi_nchw(feats, bbox, (16, 16)).sum().backward()
    assert stn_place_cuda.launch_count() == 0
    assert stn_place_cuda.grad_launch_count() == 0


def test_grad_wrapper_refuses_devices_other_than_cuda_and_cpu():
    g = torch.empty((1, 4, 16, 16), device="meta")
    bbox = torch.empty((1, 3, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        stn_place_cuda.stn_place_multi_grad_nchw(g, bbox, (16, 16))


# ------------------------------------------------------------------ extract


@pytest.mark.parametrize("kind", ["service", "off-canvas", "wide"])
def test_stn_extract_multi_matches_jax(kind):
    rng = np.random.RandomState(8)
    img = rng.uniform(-1, 1, (3, 64, 64, 2)).astype(np.float32)
    bbox = _boxes(rng, 3, 3, kind)
    want = np.asarray(jstn.stn_extract_multi(jnp.asarray(img),
                                             jnp.asarray(bbox), (16, 16)))
    got = stn.stn_extract_multi(torch.from_numpy(img), torch.from_numpy(bbox),
                                (16, 16))
    assert got.shape == (3, 3, 16, 16, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    nchw = stn.stn_extract_multi_nchw(
        torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(bbox),
        (16, 16))
    torch.testing.assert_close(nchw, got.permute(0, 1, 4, 2, 3), atol=0,
                               rtol=0)


def test_extract_gradient_flows_to_the_image_only():
    rng = np.random.RandomState(9)
    img = torch.from_numpy(rng.uniform(-1, 1, (2, 1, 64, 64)).astype(
        np.float32)).requires_grad_(True)
    bbox = torch.from_numpy(_boxes(rng, 2, 3, "service")).requires_grad_(True)
    stn.stn_extract_multi_nchw(img, bbox, (16, 16)).square().sum().backward()
    assert bbox.grad is None
    assert img.grad is not None and float(img.grad.abs().sum()) > 0


@pytest.mark.parametrize("place", [True, False], ids=["place", "extract"])
def test_stn_place_and_extract_match_jax(place):
    rng = np.random.RandomState(10)
    x = rng.uniform(-1, 1, (3, 15, 15, 4)).astype(np.float32)
    bbox = _boxes(rng, 3, 1, "off-canvas")[:, 0]
    jfn, tfn = ((jstn.stn_place, stn.stn_place) if place
                else (jstn.stn_extract, stn.stn_extract))
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(bbox), (16, 16)))
    got = tfn(torch.from_numpy(x), torch.from_numpy(bbox), (16, 16)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _k2_box_algorithm(g, bbox, in_hw):
    """K2's redesigned algorithm (csrc/stn_place.cu) in numpy, from the
    same hat weights: each input row's (column's) tap range, the object's
    box of output rows i and input rows p and columns q that have taps,
    T = Wx-sum over j inside the box, then the Wy-sum over the tap range;
    every value outside the box left at zero."""
    b, c, ho, wo = g.shape
    o = bbox.shape[1]
    wy, wx = stn.place_weights(torch.from_numpy(bbox).reshape(b * o, 4),
                               (ho, wo), in_hw)
    wy = wy.double().numpy().reshape(b, o, ho, in_hw[0])
    wx = wx.double().numpy().reshape(b, o, wo, in_hw[1])
    assert ((wy != 0).sum(-1) <= 2).all() and ((wx != 0).sum(-1) <= 2).all()
    out = np.zeros((b, o, c) + tuple(in_hw))
    for bi in range(b):
        for oi in range(o):
            rows = np.nonzero((wy[bi, oi] != 0).any(axis=1))[0]   # i
            prow = np.nonzero((wy[bi, oi] != 0).any(axis=0))[0]   # p
            qcol = np.nonzero((wx[bi, oi] != 0).any(axis=0))[0]   # q
            if not (len(rows) and len(prow) and len(qcol)):
                continue
            i0, i1 = rows.min(), rows.max() + 1
            p0, p1 = prow.min(), prow.max() + 1
            q0, q1 = qcol.min(), qcol.max() + 1
            t = np.einsum("cij,jq->ciq", g[bi][:, i0:i1],
                          wx[bi, oi][:, q0:q1])
            out[bi, oi, :, p0:p1, q0:q1] = np.einsum(
                "ip,ciq->cpq", wy[bi, oi][i0:i1, p0:p1], t)
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("in_hw", [(16, 16), (15, 15), (7, 23)])
def test_k2_box_algorithm_matches_the_plain_version(in_hw, kind):
    """Restricting both passes to the box of rows and columns with taps
    drops nothing: the result equals the plain version's (float64)."""
    rng = np.random.RandomState(11)
    g = rng.uniform(-1.0, 1.0, (4, 5, 16, 16))
    bbox = _boxes(rng, 4, 3, kind)
    want = stn_place_cuda.stn_place_multi_grad_plain(
        torch.from_numpy(g), torch.from_numpy(bbox), in_hw).numpy()
    got = _k2_box_algorithm(g, bbox, in_hw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if kind == "padded":
        assert not got[::2].any()


def test_k2_tile_fits_shared_memory_at_every_side():
    """The wrapper's channel tile keeps K2's shared memory within the
    block's 227 KB for every side up to MAX_SIDE and 1..MAX_OBJECTS
    objects, and is 16 channels at the train step's shapes."""
    m = stn_place_cuda
    assert m.grad_tile((16, 16), (16, 16)) == 16
    assert m.grad_tile((15, 15), (16, 16)) == 16
    worst = 0
    for side_in in range(1, m.MAX_SIDE + 1):
        for side_out in (1, side_in, m.MAX_SIDE):
            for objects in (1, m.MAX_OBJECTS):
                hw_in, hw_out = (side_in, side_in), (side_out, side_out)
                tile = m.grad_tile(hw_in, hw_out)
                assert 1 <= tile <= m.GRAD_TILE
                smem = m.grad_smem_bytes(objects, tile, hw_in, hw_out)
                assert smem <= m.MAX_GRAD_SMEM < 227 * 1024
                worst = max(worst, smem)
    assert worst == m.grad_smem_bytes(m.MAX_OBJECTS, 1, (64, 64), (64, 64))
