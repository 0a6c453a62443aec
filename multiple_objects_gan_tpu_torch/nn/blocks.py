"""Stage-1 building blocks, NCHW, as the reference defines them
(code/multi-mnist/model.py:9-22).

The JAX package's ``TorchBatchNorm`` and ``Dense`` are ``nn.BatchNorm1d/2d``
(eps 1e-5, momentum 0.1) and ``nn.Linear`` here; its ``object_fold`` path
is :class:`ObjectBatchNorm2d`. Its ``UpConv3x3`` computes nearest-2x
upsample + conv3x3 as one dilated conv, a TPU layout choice and not a
Pallas kernel, so :class:`UpBlock` is the plain upsample + conv.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


class Conv3x3(nn.Conv2d):
    """3x3 conv, pad 1, no bias (model.py:9-12)."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1):
        super().__init__(in_planes, out_planes, kernel_size=3, stride=stride,
                         padding=1, bias=False)


class ObjectBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d of an object pathway, whose batch axis folds (B, O)
    with O minor.

    The reference runs its object pathways as a loop over objects that
    calls the same conv and BatchNorm once per object
    (code/multi-mnist/model.py:162-169,227-234). In train mode that gives
    per-object statistics, and O running-stat updates per forward. This
    module computes the same on the folded batch, as the JAX package's
    ``TorchBatchNorm`` does under ``object_fold`` (nn/blocks.py:295-351):
    each object's slice is normalized with its own mean and biased
    variance, and the running buffers take the O updates in object order,
    with the unbiased variance. Eval mode is plain ``BatchNorm2d``. The
    state-dict keys are BatchNorm2d's.
    """

    def __init__(self, num_features: int, n_objects: int, **kwargs):
        super().__init__(num_features, **kwargs)
        self.n_objects = int(n_objects)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        o = self.n_objects
        bo, c, h, w = x.shape
        if bo % o:
            raise ValueError(f"{o} objects do not divide the folded batch "
                             f"({bo})")
        xg = x.reshape(bo // o, o, c, h, w)
        var, mean = torch.var_mean(xg, dim=(0, 3, 4), unbiased=False,
                                   keepdim=True)                # (1, O, C, 1, 1)
        inv = torch.rsqrt(var + self.eps) * self.weight.view(1, 1, c, 1, 1)
        y = (xg - mean) * inv + self.bias.view(1, 1, c, 1, 1)
        n = (bo // o) * h * w
        with torch.no_grad():
            unbiased = var.view(o, c) * (n / max(n - 1, 1))
            for i in range(o):
                self.running_mean.lerp_(mean.view(o, c)[i], self.momentum)
                self.running_var.lerp_(unbiased[i], self.momentum)
            self.num_batches_tracked.add_(o)
        return y.reshape(bo, c, h, w)


class UpBlock(nn.Sequential):
    """Nearest 2x upsample + conv3x3 + BN + ReLU (model.py:16-22); the
    children's indices give the reference's state-dict keys (``.1.weight``,
    ``.2.running_mean``, ...). ``norm`` builds the BN from the channel
    count: ``nn.BatchNorm2d``, or :class:`ObjectBatchNorm2d` in an object
    pathway."""

    def __init__(self, in_planes: int, out_planes: int,
                 norm: Callable[[int], nn.Module] = nn.BatchNorm2d):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"),
                         Conv3x3(in_planes, out_planes),
                         norm(out_planes),
                         nn.ReLU(True))
