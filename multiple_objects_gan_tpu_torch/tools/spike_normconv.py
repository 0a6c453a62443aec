"""K4 at the spike's shapes: the port's counterpart of tools/spike_normconv.py.

    python -m multiple_objects_gan_tpu_torch.tools.spike_normconv           # check + bench
    python -m multiple_objects_gan_tpu_torch.tools.spike_normconv --check   # check only
    python -m multiple_objects_gan_tpu_torch.tools.spike_normconv --device cpu --check

``--check`` holds K4 (``ops/normconv.py:normconv``) against its plain
version at the spike's two check shapes with the spike's bounds: max |dy|
under 5 % of max |y|, the sums within 2 % relative. On the CPU ``normconv``
is the plain version, so ``--device cpu --check`` runs the plain path only.
The bench times K4 at the spike's three hot shapes of the bf16 Multi-MNIST
train step (batch 128, GF_DIM 128) beside two yardsticks, each a median of
50 runs by CUDA events: the plain chain, and cuDNN's bf16 ``F.conv2d`` alone
on an NCHW input of the same shape (timed here only; the port never calls
it in K4's place). Each line gives the bound: the larger of the operations
the in-image taps need over the 989 TFLOP/s bf16 rate and the bytes read
and written over 3.35 TB/s (H100 SXM). The bench needs a card, and raises
without one. Inputs are drawn from fixed seeds.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import torch
import torch.nn.functional as F

from multiple_objects_gan_tpu_torch import resolve_device
from multiple_objects_gan_tpu_torch.ops import normconv as k4

BF16_OPS_PER_S = 989e12     # H100 SXM, dense bf16, NVIDIA data sheet
HBM_BYTES_PER_S = 3.35e12   # H100 SXM

# (name, B, H, W, Cin, Cout): tools/spike_normconv.py:176-177 and :196-202
CHECK_SHAPES = [("check 16x16 128->128", 8, 16, 16, 128, 128),
                ("check 8x8 256->128", 8, 8, 8, 256, 128)]
HOT_SHAPES = [("local2 16x16 512->256 (B*O=384)", 384, 16, 16, 512, 256),
              ("up3-ish 32x32 256->128", 128, 32, 32, 256, 128),
              ("16x16 512->256", 128, 16, 16, 512, 256)]
CHECK_REL_Y = 0.05          # the spike's bounds (spike_normconv.py:190)
CHECK_REL_SUM = 0.02
WARMUP, RUNS = 5, 50        # the bench's calls of each yardstick a shape


def make_inputs(shape, seed: int, device):
    """x (B, H, W, Cin) bf16 and the spike's BatchNorm of it (mean and
    variance of x, gamma ~ 1 + 0.1 N, beta ~ 0.1 N) folded to scale and
    shift, and w (3, 3, Cin, Cout) bf16 ~ 0.05 N, as the spike's
    ``_make_inputs`` draws them, from a torch generator on ``device``."""
    b, h, w, cin, cout = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*size):
        return torch.randn(size, generator=gen, device=device)

    x = randn(b, h, w, cin)
    var, mean = torch.var_mean(x, dim=(0, 1, 2), unbiased=False)
    scale, shift = k4.fold_bn(mean, var, 1.0 + 0.1 * randn(cin),
                              0.1 * randn(cin))
    weight = (randn(3, 3, cin, cout) * 0.05).to(torch.bfloat16)
    return x.to(torch.bfloat16), scale, shift, weight


def bound(shape):
    """(bound_ms, bound_by, flops, bytes) of K4 at ``shape``: two flops per
    multiply-add of the taps inside the image, and each input read and each
    output written once."""
    b, h, w, cin, cout = shape
    taps = (3 * h - 2) * (3 * w - 2)      # in-image taps over all pixels
    flops = 2.0 * b * taps * cin * cout
    nbytes = (b * h * w * (cin + cout) * 2 + 9 * cin * cout * 2
              + 2 * cin * 4 + 2 * cout * 4)
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes)


def disagreement(got, want):
    """(max |dy|, max |y| of ``want``, relative sum and sum-of-squares
    errors) between two (y, sum, sq) results, the spike's measures."""
    y1, s1, q1 = got
    y2, s2, q2 = want
    dy = float((y1.float() - y2.float()).abs().max())
    scale = float(y2.float().abs().max())
    rs = float((s1 - s2).abs().max()) / (float(s2.abs().max()) + 1e-6)
    rq = float((q1 - q2).abs().max()) / (float(q2.abs().max()) + 1e-6)
    return dy, scale, rs, rq


def cuda_ms(fn, warmup: int = WARMUP, runs: int = RUNS) -> float:
    """Median time of one call of ``fn``, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(device, seed: int = 0) -> None:
    """K4 (the plain version on the CPU) against the plain version at the
    check shapes; raises if the spike's bounds are not met."""
    for name, *shape in CHECK_SHAPES:
        args = make_inputs(shape, seed, device)
        dy, scale, rs, rq = disagreement(k4.normconv(*args),
                                         k4.normconv_plain(*args))
        print(f"{name} {tuple(shape)}: |dy|max={dy:.4g} (|y|max={scale:.4g}),"
              f" rel dsum={rs:.2e} dsq={rq:.2e}", flush=True)
        if not (dy <= CHECK_REL_Y * scale and rs < CHECK_REL_SUM
                and rq < CHECK_REL_SUM):
            raise RuntimeError(f"K4 check failed at {name}")
    print("CHECK OK", flush=True)


def bench(device, seed: int = 1) -> list[dict]:
    """K4, the plain chain and bf16 ``F.conv2d`` at the hot shapes, on the
    card. Returns one record a shape. K4 launches WARMUP + RUNS times a
    shape; the plain chain and ``F.conv2d`` launch it never."""
    rows = []
    for name, *shape in HOT_SHAPES:
        x, scale, shift, w = make_inputs(shape, seed, device)
        ms = cuda_ms(lambda: k4.normconv(x, scale, shift, w))
        plain_ms = cuda_ms(lambda: k4.normconv_plain(x, scale, shift, w))
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        conv_ms = cuda_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1))
        bound_ms, bound_by, flops, nbytes = bound(shape)
        rows.append({"shape": name, "dims": list(shape), "ms": ms,
                     "plain_ms": plain_ms, "library_ms": conv_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"{name:34s} K4 {ms:8.4f} ms ({bound_ms / ms:6.1%} of the "
              f"{bound_ms:.4f} ms {bound_by} bound, {flops / ms / 1e9:.1f} "
              f"TFLOP/s); plain chain {plain_ms:8.4f} ms; F.conv2d bf16 "
              f"{conv_ms:8.4f} ms (K4 takes {ms / conv_ms:.2f}x its time)",
              flush=True)
    return rows


def run(device, check_only: bool = False) -> list[dict]:
    """What the tool does: :func:`check`, then :func:`bench` unless
    ``check_only``; returns the bench's records."""
    check(device)
    return [] if check_only else bench(device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--check", action="store_true",
                   help="only hold K4 against its plain version")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"{torch.cuda.get_device_name(device)}, torch "
              f"{torch.__version__}", flush=True)
    if not args.check and device.type != "cuda":
        raise SystemExit("the bench times the card: run it without "
                         "--device cpu")
    run(device, check_only=args.check)
    return 0


if __name__ == "__main__":
    sys.exit(main())
