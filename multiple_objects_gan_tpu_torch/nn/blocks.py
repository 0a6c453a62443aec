"""Stage-1 building blocks, NCHW, as the reference defines them
(code/multi-mnist/model.py:9-22).

The JAX package's ``TorchBatchNorm`` and ``Dense`` are ``nn.BatchNorm1d/2d``
(eps 1e-5) and ``nn.Linear`` here. Its ``UpConv3x3`` computes nearest-2x
upsample + conv3x3 as one dilated conv, a TPU layout choice and not a Pallas
kernel, so :class:`UpBlock` is the plain upsample + conv.
"""

from __future__ import annotations

from torch import nn


class Conv3x3(nn.Conv2d):
    """3x3 conv, pad 1, no bias (model.py:9-12)."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1):
        super().__init__(in_planes, out_planes, kernel_size=3, stride=stride,
                         padding=1, bias=False)


class UpBlock(nn.Sequential):
    """Nearest 2x upsample + conv3x3 + BN + ReLU (model.py:16-22); the
    children's indices give the reference's state-dict keys (``.1.weight``,
    ``.2.running_mean``, ...)."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"),
                         Conv3x3(in_planes, out_planes),
                         nn.BatchNorm2d(out_planes),
                         nn.ReLU(True))
