"""PyTorch/CUDA port of the multiple-objects GAN, beside the JAX package.

The port runs on an NVIDIA H100. Its hand-written kernels are CUDA C++ for
``sm_90a``: the STN place-and-accumulate and its backward
(``ops/stn_place_cuda.py``, float32 and bf16) and the BatchNorm-fused conv
link of the JAX package's spike (``ops/normconv.py``). It imports nothing of
JAX and nothing of ``multiple_objects_gan_tpu``: the JAX package is the
reference the port's tests hold it against.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``.
Without a card it raises; it runs on the CPU only when asked to.
"""

from __future__ import annotations

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
