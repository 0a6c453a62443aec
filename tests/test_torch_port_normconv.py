"""K4, the port's normconv (``ops/normconv.py``), against the JAX package's
spike (tools/spike_normconv.py) on the CPU, and the port's spike tool.

The plain version is held against the spike's XLA baseline ``normconv_xla``
and against its Pallas kernel in interpret mode (as the JAX package's own
tests run Pallas on the CPU). Inputs are drawn with numpy from a seed.
Tolerances: y within one bf16 ulp of the largest |y| (each side rounds the
same normalized bf16 values' f32 products, summed in another order, to
bf16 once: a value near a rounding boundary may land one ulp apart); the
per-channel sums within 2e-3 of the largest |sum| (f32 sums of up to 9*Cin
products over every pixel, in another order; the plain chain sums its bf16
y, whose rounding errors cancel in the sum far below that).

The Pallas wrapper pads x with -shift/scale rounded to bf16, where the
spike's stated function and its XLA baseline zero-pad the normalized
tensor. In a channel whose gamma is 0 and beta > 0 the normalized value is
relu(beta) everywhere, so the two paddings part at the border: the port
follows the stated function, and the test shows where the Pallas kernel
does not (ROADMAP Queue 3 records it as a note).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from multiple_objects_gan_tpu_torch.ops import normconv as k4
from multiple_objects_gan_tpu_torch.tools import spike_normconv as tool

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "tools"))
import spike_normconv as spike  # noqa: E402  (the JAX package's spike)

SUM_RTOL = 2e-3


def _inputs(shape, seed, zero_gamma=False):
    """numpy inputs: x (B, H, W, Cin) rounded to bf16, its mean and
    variance, gamma, beta and w (3, 3, Cin, Cout), as the spike draws them."""
    b, h, w, cin, cout = shape
    rs = np.random.RandomState(seed)
    x = rs.randn(b, h, w, cin).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    mean, var = x.mean(axis=(0, 1, 2)), x.var(axis=(0, 1, 2))
    gamma = (1.0 + 0.1 * rs.randn(cin)).astype(np.float32)
    beta = (0.1 * rs.randn(cin)).astype(np.float32)
    if zero_gamma:
        gamma[0], beta[0] = 0.0, 0.5
    w = (0.05 * rs.randn(3, 3, cin, cout)).astype(np.float32)
    return x, mean, var, gamma, beta, w


def _port(x, mean, var, gamma, beta, w):
    t = [torch.from_numpy(np.array(a)) for a in (x, mean, var, gamma, beta,
                                                  w)]
    scale, shift = k4.fold_bn(*t[1:5])
    return k4.normconv(t[0].bfloat16(), scale, shift, t[5].bfloat16())


def _jax(fn, x, mean, var, gamma, beta, w, **kwargs):
    y, s1, s2 = fn(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(mean),
                   jnp.asarray(var), jnp.asarray(gamma), jnp.asarray(beta),
                   jnp.asarray(w), **kwargs)
    return (np.asarray(y.astype(jnp.float32)), np.asarray(s1),
            np.asarray(s2))


def _agree(got, want):
    """(max |dy| in ulps of max |y|, relative sum errors)."""
    y, s, q = (t.float().numpy() for t in got)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want[0]).max())) - 7)
    dy = np.abs(y - want[0]).max() / ulp
    rs = np.abs(s - want[1]).max() / np.abs(want[1]).max()
    rq = np.abs(q - want[2]).max() / np.abs(want[2]).max()
    return dy, rs, rq


@pytest.mark.parametrize("shape", [(4, 8, 8, 16, 8), (2, 6, 5, 24, 16),
                                   (8, 16, 16, 128, 128)],
                         ids=["4x8x8x16-8", "odd-sides", "spike-check"])
def test_plain_matches_the_spike_xla_baseline(shape):
    args = _inputs(shape, 0)
    got = _port(*args)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert tuple(got[0].shape) == shape[:3] + (shape[4],)
    dy, rs, rq = _agree(got, _jax(spike.normconv_xla, *args))
    assert dy <= 1.0 and rs < SUM_RTOL and rq < SUM_RTOL, (dy, rs, rq)


@pytest.mark.parametrize("edge", chip_smoke.K4_EDGE_SHAPES
                         + [chip_smoke.K4_ZERO_GAMMA_SHAPE],
                         ids=lambda e: e[0])
def test_plain_matches_the_spike_at_the_chip_smoke_edge_shapes(edge):
    """The edge shapes at which chip_smoke.py phase 11 holds K4 against
    the plain version: the plain version (K4's CPU path) against the
    spike's XLA baseline there, so the card's reference is right too."""
    name, *shape = edge
    args = _inputs(tuple(shape), 5, zero_gamma=name.startswith("gamma 0"))
    got = _port(*args)
    dy, rs, rq = _agree(got, _jax(spike.normconv_xla, *args))
    assert dy <= 1.0 and rs < SUM_RTOL and rq < SUM_RTOL, (dy, rs, rq)


def test_plain_matches_the_pallas_kernel_in_interpret_mode():
    args = _inputs((4, 8, 8, 16, 8), 1)
    want = _jax(spike.normconv, *args, tile_b=2, interpret=True)
    dy, rs, rq = _agree(_port(*args), want)
    assert dy <= 1.0 and rs < SUM_RTOL and rq < SUM_RTOL, (dy, rs, rq)


def test_zero_gamma_channel_pads_as_the_stated_function_not_as_pallas():
    """gamma = 0, beta = 0.5 in channel 0: the normalized channel is 0.5
    inside the image and the padding is 0 (the spike's stated function and
    ``normconv_xla``); the Pallas wrapper's pad value -shift/scale is 0
    there, which normalizes to relu(beta) = 0.5 on the border too."""
    args = _inputs((2, 6, 6, 8, 8), 2, zero_gamma=True)
    got = _port(*args)
    xla = _jax(spike.normconv_xla, *args)
    dy, rs, rq = _agree(got, xla)
    assert dy <= 1.0 and rs < SUM_RTOL and rq < SUM_RTOL, (dy, rs, rq)
    pallas = _jax(spike.normconv, *args, tile_b=2, interpret=True)
    border = np.ones((6, 6), bool)
    border[1:-1, 1:-1] = False
    y = got[0].float().numpy()
    # inside the image all three agree; on the border Pallas does not
    ulp = 2.0 ** (np.floor(np.log2(np.abs(xla[0]).max())) - 7)
    assert np.abs(y[:, ~border] - pallas[0][:, ~border]).max() <= ulp
    assert np.abs(y[:, border] - pallas[0][:, border]).max() > 4 * ulp


def test_fold_bn_is_the_spike_fold():
    x, mean, var, gamma, beta, _ = _inputs((2, 4, 4, 8, 8), 3)
    scale, shift = k4.fold_bn(*(torch.from_numpy(a)
                                for a in (mean, var, gamma, beta)))
    want_scale = gamma / np.sqrt(var + k4.EPS)
    np.testing.assert_allclose(scale.numpy(), want_scale, rtol=1e-6)
    np.testing.assert_allclose(shift.numpy(), beta - mean * want_scale,
                               rtol=1e-6, atol=1e-7)


def test_cpu_path_launches_no_kernel_and_other_devices_are_refused():
    k4.reset_launch_count()
    args = tool.make_inputs((2, 4, 4, 8, 8), 0, torch.device("cpu"))
    k4.normconv(*args)
    assert k4.launch_count() == 0
    with pytest.raises(ValueError, match="cuda or cpu"):
        k4.normconv(*(a.to("meta") for a in args))


@pytest.mark.parametrize("bad, match", [
    (lambda x, s, t, w: (x[..., :4], s[:4], t[:4], w[:, :, :4]),
     "multiples of 8"),
    (lambda x, s, t, w: (x.float(), s, t, w), "bf16 x and w"),
    (lambda x, s, t, w: (x, s, t, w[:, :, :4]), r"\(3, 3, Cin, Cout\)"),
    (lambda x, s, t, w: (x.transpose(1, 2), s, t, w), "contiguous"),
    (lambda x, s, t, w: (torch.zeros(1, 1, 1, 1032, dtype=torch.bfloat16),
                         torch.ones(1032), torch.zeros(1032),
                         torch.zeros(3, 3, 1032, 8, dtype=torch.bfloat16)),
     "Cin up to 1024"),
    (lambda x, s, t, w: (x, s, t, w[:, :, :, :4]), "multiples of 8"),
    (lambda x, s, t, w: (torch.zeros(1, 2, 33, 8, dtype=torch.bfloat16), s,
                         t, w), "W up to 32"),
], ids=["cin-4", "float-x", "cin-mismatch", "strided", "cin-1032",
        "cout-4", "width-33"])
def test_kernel_wrapper_checks_what_the_kernel_takes(bad, match):
    args = tool.make_inputs((2, 4, 4, 8, 8), 0, torch.device("cpu"))
    with pytest.raises(ValueError, match=match):
        k4._check(*bad(*args))


@pytest.mark.parametrize("shape", [(2, 5, 6, 8, 8), (3, 4, 4, 136, 264)],
                         ids=["cin-8", "cin-136-cout-264"])
def test_packed_weights_are_the_kernels_b_operand(shape):
    """The kernel's GEMM through :func:`pack_weights`: row n of the packed
    weights, read as 9 * Cin values (tap-major, Cin innermost), against the
    im2col rows of the zero-padded normalized x gives the convolution."""
    b, h, w, cin, cout = shape
    rs = np.random.RandomState(4)
    xn = torch.from_numpy(rs.randn(b, h, w, cin)).relu()
    wt = torch.from_numpy(rs.randn(3, 3, cin, cout))
    packed = k4.pack_weights(wt)
    assert tuple(packed.shape) == (cout, 3, 3, cin) and packed.is_contiguous()
    pad = torch.nn.functional.pad(xn, (0, 0, 1, 1, 1, 1))
    a = torch.stack([pad[:, dy:dy + h, dx:dx + w] for dy in range(3)
                     for dx in range(3)], dim=3).reshape(b * h * w, 9 * cin)
    got = torch.matmul(a, packed.reshape(cout, 9 * cin).T)
    want = torch.nn.functional.conv2d(xn.permute(0, 3, 1, 2),
                                      wt.permute(3, 2, 0, 1), padding=1)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).reshape(
        b * h * w, cout).numpy(), rtol=1e-12, atol=1e-10)


def test_tool_check_on_the_cpu(capsys):
    assert tool.main(["--device", "cpu", "--check"]) == 0
    out = capsys.readouterr().out
    assert out.count("|dy|max=") == len(tool.CHECK_SHAPES)
    assert "CHECK OK" in out


def test_tool_bench_needs_the_card():
    with pytest.raises(SystemExit, match="times the card"):
        tool.main(["--device", "cpu"])


def test_bound_at_the_hot_shapes():
    """Operations bound all three: 2.13e11 flops of in-image taps at the
    first (2.32e11 counting all 9 taps a pixel), 0.216 ms."""
    got = [tool.bound(shape) for _, *shape in tool.HOT_SHAPES]
    assert all(by == "operations" for _, by, _, _ in got)
    flops = got[0][2]
    assert flops == 2.0 * 384 * 46 * 46 * 512 * 256
    np.testing.assert_allclose(got[0][0], flops / 989e12 * 1e3)
