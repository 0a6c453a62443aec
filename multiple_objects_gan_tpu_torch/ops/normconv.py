"""K4: relu(BatchNorm-normalize(x)) -> conv3x3 -> the next BatchNorm's sums.

Replaces the Pallas TPU kernel ``tools/spike_normconv.py:normconv`` (body
``_normconv_kernel``), a forward-only bf16 fusion of one link of the
Stage-1 step's conv chain. :func:`normconv` launches the CUDA kernel of
``csrc/normconv.cu`` (CUDA C++ for ``sm_90a``, a pipelined implicit GEMM
on the bf16 tensor cores through ``wgmma``, bound with ctypes) for a CUDA
tensor, and runs :func:`normconv_plain` for a CPU tensor; nothing else is
accepted and nothing falls back. Each kernel launch adds one to
:func:`launch_count`.

Layout is the spike's: x (B, H, W, Cin) NHWC and w (3, 3, Cin, Cout) HWIO,
bf16. The kernel reads the weights as (Cout, 3, 3, Cin), K-major rows of
its TMA boxes: :func:`pack_weights` repacks them on each call. No model
of the port calls K4: its caller is the port's spike tool,
``multiple_objects_gan_tpu_torch/tools/spike_normconv.py``.

Padding follows the function the spike states (and its XLA baseline): the
normalized tensor is zero-padded. The Pallas wrapper instead pads x with
-shift/scale rounded to bf16, so its border taps are only near zero, and
relu(beta) in a channel whose gamma is 0.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from multiple_objects_gan_tpu_torch.ops import _build

EPS = 1e-5
VEC = 8          # csrc/normconv.cu:kVec, Cin and Cout are multiples of it
MAX_CIN = 1024   # csrc/normconv.cu:kMaxCin, scale and shift in shared memory
MAX_WIDTH = 32   # csrc/normconv.cu:kMaxWidth, the halo in shared memory

_count_lock = threading.Lock()
_launches = 0


def launch_count() -> int:
    """K4 launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def _count() -> None:
    global _launches
    with _count_lock:
        _launches += 1


def fold_bn(mean, var, gamma, beta):
    """The folded f32 affine of a BatchNorm: scale = gamma / sqrt(var + eps)
    and shift = beta - mean * scale (spike_normconv.py:108-109)."""
    mean, var, gamma, beta = (t.float() for t in (mean, var, gamma, beta))
    scale = gamma / torch.sqrt(var + EPS)
    return scale, beta - mean * scale


def normconv_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   w: torch.Tensor):
    """Plain PyTorch version of K4 (the CPU path and the card's oracle):
    the spike's idiomatic chain.

    x (B, H, W, Cin) bf16, scale and shift (Cin,) f32, w (3, 3, Cin, Cout)
    bf16 -> y (B, H, W, Cout) bf16, sum and sq (Cout,) f32. Normalizes with
    the folded affine in f32, relu, rounds to bf16; convolves in bf16 with
    ``F.conv2d`` (NCHW, padding 1: the normalized tensor is zero-padded),
    which sums the bf16 products in f32 and rounds y once. ``F.conv2d``
    hands back no f32 result, so the sums are taken in f32 from the bf16 y;
    the kernel takes them from its f32 accumulator before rounding.
    """
    xn = torch.relu(x.float() * scale + shift).to(torch.bfloat16)
    y = F.conv2d(xn.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1)
    yf = y.float()
    return y, yf.sum(dim=(0, 1, 2)), yf.square().sum(dim=(0, 1, 2))


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO weights (3, 3, Cin, Cout) -> (Cout, 3, 3, Cin), contiguous: the
    layout the kernel's B tiles read, each output channel's 9 * Cin values
    in a row with Cin innermost (K-major for ``wgmma``)."""
    return w.permute(3, 0, 1, 2).contiguous()


def _check(x, scale, shift, w) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != x.shape[3]:
        raise ValueError(f"x must be (B, H, W, Cin) and w (3, 3, Cin, Cout), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    cin, cout = w.shape[2], w.shape[3]
    if tuple(scale.shape) != (cin,) or tuple(shift.shape) != (cin,):
        raise ValueError(f"scale and shift must be ({cin},)")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 \
            or scale.dtype != torch.float32 or shift.dtype != torch.float32:
        raise ValueError(f"K4 takes bf16 x and w and f32 scale and shift, "
                         f"got {x.dtype}, {w.dtype}, {scale.dtype}, "
                         f"{shift.dtype}")
    if cin % VEC or cout % VEC:
        raise ValueError(f"K4 takes Cin and Cout in multiples of {VEC}, got "
                         f"{cin} and {cout}")
    if cin > MAX_CIN:
        raise ValueError(f"K4 takes Cin up to {MAX_CIN}, got {cin}")
    if x.shape[2] > MAX_WIDTH:
        raise ValueError(f"K4 takes W up to {MAX_WIDTH}, got {x.shape[2]}")
    if x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if x.shape[0] * x.shape[1] * x.shape[2] >= 2 ** 31:
        raise ValueError(f"too many pixels: {tuple(x.shape)}")
    for name, t in (("x", x), ("scale", scale), ("shift", shift), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _kernel():
    lib = _build.build("normconv").lib
    fn = lib.normconv_bf16
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows = lib.normconv_row_blocks
    rows.argtypes = [ctypes.c_int] * 3
    rows.restype = ctypes.c_int
    return fn, rows


def normconv(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
             w: torch.Tensor):
    """K4: x (B, H, W, Cin) bf16, the folded scale and shift (Cin,) f32
    (:func:`fold_bn`), w (3, 3, Cin, Cout) bf16 -> y (B, H, W, Cout) bf16,
    and the per-channel sum and sum of squares (Cout,) f32 of the f32
    accumulator before rounding.

    A CUDA tensor launches the kernel on the current stream (or raises); a
    CPU tensor runs :func:`normconv_plain`.
    """
    if x.device.type == "cpu":
        return normconv_plain(x, scale, shift, w)
    if x.device.type != "cuda":
        raise ValueError(f"normconv runs on cuda or cpu, not {x.device}")
    _check(x, scale, shift, w)
    b, h, wd, _ = x.shape
    cout = w.shape[3]
    fn, rows = _kernel()
    dev = x.device
    w_packed = pack_weights(w)
    y = torch.empty((b, h, wd, cout), dtype=torch.bfloat16, device=dev)
    part = torch.empty((2, rows(b, h, wd), cout), dtype=torch.float32,
                       device=dev)
    sums = torch.empty((2, cout), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                 w_packed.data_ptr(), y.data_ptr(), part[0].data_ptr(),
                 part[1].data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(),
                 b, h, wd, x.shape[3], cout,
                 _build.current_stream(dev.index))
    if err != 0:
        raise RuntimeError(f"normconv_bf16 launch failed with CUDA error "
                           f"{err}")
    _count()
    return y, sums[0], sums[1]
