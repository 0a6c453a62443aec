"""PyTorch/CUDA port of the multiple-objects GAN, beside the JAX package.

The port runs on an NVIDIA H100. Its hand-written kernels are CUDA C++ for
``sm_90a``: the STN place-and-accumulate and its backward
(``ops/stn_place_cuda.py``, float32 and bf16) and the BatchNorm-fused conv
link of the JAX package's spike (``ops/normconv.py``). It imports nothing of
JAX and nothing of ``multiple_objects_gan_tpu``: the JAX package is the
reference the port's tests hold it against.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``.
Without a card it raises; it runs on the CPU only when asked to. Float32
work on the card computes in float32: the train and serve entries turn
TF32 off through :func:`float32_policy`; a metric's forward (FID, IS)
computes in float32 under :func:`float32_pinned` whatever the process's
settings are.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it names CUDA and there is
    no usable card. The CPU is used only when the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or "
                         "'cpu'")
    return dev


def float32_policy(device: torch.device, compute_dtype) -> None:
    """The port's one float32 policy, which ``cli/main.py`` (training) and
    ``cli/serve.py`` (serving) apply: float32 work on the card
    (``compute_dtype`` None) turns TF32 off for matmuls and cuDNN in the
    process, so that it computes in float32, as the JAX package's float32
    path does; bf16 work and the CPU leave both settings as they are."""
    if torch.device(device).type == "cuda" and compute_dtype is None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def float32_pinned():
    """TF32 off for matmuls and cuDNN inside the block, the caller's
    settings restored after it: the FID and IS encoders' forwards compute
    in float32 in a ``--bf16`` process too, as the JAX package pins
    ``Precision.HIGHEST`` there (``nn/fid_inception.py``)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
