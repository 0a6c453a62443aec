"""The canonical pytorch-fid Inception-v3 up to pool3 (the port's copy of
the JAX package's ``nn/fid_inception.py``), for FID comparable with
published numbers.

pytorch-fid's network differs from the torchvision backbone behind the
DAMSM image encoder (``nn/encoders.py:CNNEncoder``) in its weights
(pt_inception-2015-12-05, a 1008-class head FID does not read) and in
three of its modules:

* every stride-1 3x3 average pool of a pool branch (InceptionA, InceptionC
  and Mixed_7b's InceptionE) divides by the count of real elements at
  the border (``count_include_pad=False``);
* Mixed_7c's pool branch is a 3x3 stride-1 max pool.

The input is the port's model image, (B, 3, H, W) in [-1, 1] at any size,
resized to 299 bilinearly with half-pixel centres and no antialiasing
(pytorch-fid's ``F.interpolate(align_corners=False)``, JAX's
``jax.image.resize(antialias=False)``); both are linear maps, so resizing
in [-1, 1] equals pytorch-fid's resize in [0, 1] then normalising.

The network computes in float32 whatever the process's compute dtype, and
its forward runs under :func:`~multiple_objects_gan_tpu_torch.
float32_pinned` (TF32 off for matmuls and cuDNN, the caller's settings
restored), as the JAX package pins ``Precision.HIGHEST``.

Weights come from a pt_inception ``.pth`` or a torchvision inception_v3
state dict (the same keys) through :func:`import_fid_inception`, which
skips the heads and checks coverage: a key that maps nowhere, or a
module left without weights, raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multiple_objects_gan_tpu_torch import float32_pinned, resolve_device
from multiple_objects_gan_tpu_torch.io.pycompat import torch_load
from multiple_objects_gan_tpu_torch.nn.encoders import (
    BasicConv2d, InceptionA, InceptionB, InceptionC, InceptionD, InceptionE,
    _max_pool3_s2)

SKIPPED_PREFIXES = ("AuxLogits.", "fc.")


def _avg_pool3_nopad_count(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 pad-1 average pool over the real elements only."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool3_s1(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=1, padding=1)


class FIDInceptionA(InceptionA):
    """InceptionA with pytorch-fid's pool branch."""

    pool = staticmethod(_avg_pool3_nopad_count)


class FIDInceptionC(InceptionC):
    """InceptionC with pytorch-fid's pool branch."""

    pool = staticmethod(_avg_pool3_nopad_count)


class FIDInceptionE(InceptionE):
    """InceptionE whose pool branch is ``"avg_nopad"`` (Mixed_7b) or
    ``"max"`` (Mixed_7c): pytorch-fid's FIDInceptionE_1 and _2."""

    def __init__(self, cin: int, pool: str):
        super().__init__(cin)
        if pool not in ("avg_nopad", "max"):
            raise ValueError(f"pool {pool!r}: 'avg_nopad' or 'max'")
        self.pool = (_max_pool3_s1 if pool == "max"
                     else _avg_pool3_nopad_count)


class FIDInceptionV3(nn.Module):
    """pytorch-fid's InceptionV3 up to pool3: (B, 3, H, W) in [-1, 1] ->
    (B, 2048) float32. With ``return_pool`` (the default) it returns
    ``(None, None, pool)``, CNNEncoder's ``return_pool`` shape, so that
    ``utils/metrics.py:inception_activations`` drives either encoder."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = FIDInceptionA(192, 32)
        self.Mixed_5c = FIDInceptionA(256, 64)
        self.Mixed_5d = FIDInceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = FIDInceptionC(768, 128)
        self.Mixed_6c = FIDInceptionC(768, 160)
        self.Mixed_6d = FIDInceptionC(768, 160)
        self.Mixed_6e = FIDInceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = FIDInceptionE(1280, "avg_nopad")
        self.Mixed_7c = FIDInceptionE(2048, "max")

    def forward(self, x: torch.Tensor, return_pool: bool = True):
        with float32_pinned():
            x = F.interpolate(x.float(), size=(299, 299), mode="bilinear",
                              align_corners=False, antialias=False)
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
            x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool3_s2(x)))
            x = _max_pool3_s2(x)
            for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                         "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                         "Mixed_7a", "Mixed_7b", "Mixed_7c"):
                x = getattr(self, name)(x)
            pool = x.mean(dim=(2, 3))                     # (B, 2048)
        return (None, None, pool) if return_pool else pool


def import_fid_inception(path: str, model: FIDInceptionV3) -> FIDInceptionV3:
    """Load a pt_inception / torchvision inception_v3 state dict at
    ``path`` into ``model`` (JAX ``import_fid_inception``): ``AuxLogits.*``,
    ``fc.*`` and ``num_batches_tracked`` are skipped; a shape that differs
    raises ValueError, a key that maps nowhere KeyError, and so does a
    weight or statistic the file leaves out."""
    sd = torch_load(path)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    own = model.state_dict()
    loaded = {}
    for key, val in sd.items():
        if key.startswith(SKIPPED_PREFIXES) or key.endswith(
                "num_batches_tracked"):
            continue
        if key not in own or key.split(".")[-2] not in ("conv", "bn"):
            raise KeyError(f"unmapped FID-inception state-dict key: {key}")
        val = torch.as_tensor(val, dtype=torch.float32)
        if tuple(val.shape) != tuple(own[key].shape):
            raise ValueError(f"{key}: shape {tuple(val.shape)} != expected "
                             f"{tuple(own[key].shape)}")
        loaded[key] = val
    missing = [k for k in own if k not in loaded
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"FID-inception import left {len(missing)} leaves "
                       f"uninitialized (file {path!r} incomplete?): "
                       f"{missing[:5]}")
    model.load_state_dict(loaded, strict=False)
    return model


def create_fid_encoder(path: str, device="cuda") -> FIDInceptionV3:
    """FIDInceptionV3 with the weights of ``path``, in eval mode on
    ``device``, without gradients."""
    dev = resolve_device(device)
    model = import_fid_inception(path, FIDInceptionV3())
    return model.to(dev).eval().requires_grad_(False)
