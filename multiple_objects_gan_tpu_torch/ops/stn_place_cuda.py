"""K1, the STN place-and-accumulate: CUDA kernel wrapper and plain version.

Replaces the Pallas TPU kernel
``multiple_objects_gan_tpu/ops/stn_pallas.py:stn_place_multi_pallas``. The
kernel is ``csrc/stn_place.cu`` (CUDA C++ for ``sm_90a``, bound with
ctypes). Its bound on the card is bytes: each input value it needs is read
once and each output written once, and it does a few operations per byte.
Design: one block per (batch, channel) output plane of the NCHW layout the
model holds; each output value is a sum over objects of a 2x2-tap bilinear
gather, since a row of a hat-weight matrix has at most two non-zeros.

:func:`stn_place_multi_nchw` launches the kernel for a CUDA tensor and runs
:func:`stn_place_multi_plain` for a CPU tensor; nothing else is accepted
and nothing falls back. Each launch adds one to a plain launch count, so a
run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from multiple_objects_gan_tpu_torch.ops import _build
from multiple_objects_gan_tpu_torch.ops.stn import place_weights

MAX_OBJECTS = 16  # csrc/stn_place.cu:kMaxObjects

_count_lock = threading.Lock()
_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def stn_place_multi_plain(features: torch.Tensor, bbox: torch.Tensor,
                          out_hw: tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in f32.

    features (B, O, C, h, w), bbox (B, O, 4) -> (B, C, Ho, Wo): per object
    Wy @ F @ Wx^T with the hat weights of its place affine, summed over
    objects, as the Pallas kernel computes it.
    """
    b, o, c, hi, wi = features.shape
    wy, wx = place_weights(bbox.reshape(b * o, 4), out_hw, (hi, wi))
    f = features.float().reshape(b * o, c, hi, wi)
    tmp = torch.einsum("nip,ncpq->nciq", wy, f)
    out = torch.einsum("nciq,njq->ncij", tmp, wx)
    return out.reshape(b, o, c, out_hw[0], out_hw[1]).sum(dim=1)


def _check(features: torch.Tensor, bbox: torch.Tensor,
           out_hw: tuple[int, int]) -> None:
    if features.dim() != 5:
        raise ValueError(f"features must be (B, O, C, h, w), got "
                         f"{tuple(features.shape)}")
    b, o, c, hi, wi = features.shape
    if tuple(bbox.shape) != (b, o, 4):
        raise ValueError(f"bbox must be {(b, o, 4)}, got {tuple(bbox.shape)}")
    if features.dtype != torch.float32 or bbox.dtype != torch.float32:
        raise ValueError(f"the kernel takes float32, got {features.dtype} "
                         f"and {bbox.dtype}")
    if bbox.device != features.device:
        raise ValueError(f"bbox on {bbox.device}, features on "
                         f"{features.device}")
    if not (features.is_contiguous() and bbox.is_contiguous()):
        raise ValueError("features and bbox must be contiguous")
    if not 1 <= o <= MAX_OBJECTS:
        raise ValueError(f"1..{MAX_OBJECTS} objects supported, got {o}")
    if min(b, c, hi, wi, *out_hw) < 1 or b * c >= 2 ** 31:
        raise ValueError(f"unsupported shape {tuple(features.shape)} -> "
                         f"{tuple(out_hw)}")


def _kernel():
    fn = _build.build("stn_place").lib.stn_place_multi_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def stn_place_multi_nchw(features: torch.Tensor, bbox: torch.Tensor,
                         out_hw: tuple[int, int]) -> torch.Tensor:
    """features (B, O, C, h, w) f32, bbox (B, O, 4) f32 -> (B, C, Ho, Wo).

    A CUDA tensor launches the kernel on the current stream (or raises); a
    CPU tensor runs :func:`stn_place_multi_plain`.
    """
    global _launches
    if features.device.type == "cpu":
        return stn_place_multi_plain(features, bbox, out_hw)
    if features.device.type != "cuda":
        raise ValueError(f"stn_place_multi_nchw runs on cuda or cpu, not "
                         f"{features.device}")
    _check(features, bbox, out_hw)
    b, o, c, hi, wi = features.shape
    ho, wo = (int(v) for v in out_hw)
    out = torch.empty((b, c, ho, wo), dtype=torch.float32,
                      device=features.device)
    fn = _kernel()
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(features.data_ptr(), bbox.data_ptr(), out.data_ptr(),
                 b, o, c, hi, wi, ho, wo, stream)
    if err != 0:
        raise RuntimeError(f"stn_place_multi_f32 launch failed with CUDA "
                           f"error {err}")
    with _count_lock:
        _launches += 1
    return out
