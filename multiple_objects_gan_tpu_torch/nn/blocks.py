"""Stage-1 building blocks, NCHW, as the reference defines them
(code/multi-mnist/model.py:9-22).

The JAX package's ``TorchBatchNorm`` and ``Dense`` are :class:`BatchNorm1d`,
:class:`BatchNorm2d` (eps 1e-5, momentum 0.1) and :class:`Linear` here; its
``object_fold`` path is :class:`ObjectBatchNorm2d`. Its ``UpConv3x3``
computes nearest-2x upsample + conv3x3 as one dilated conv, a TPU layout
choice and not a Pallas kernel, so :class:`UpBlock` is the plain upsample +
conv.

Two settings of the JAX package's trace-time knobs are explicit arguments
here, carried from the model config:

* ``compute_dtype`` (``set_compute_dtype``, nn/blocks.py:69-83 of the JAX
  package): a conv or linear casts its input, weight and bias to it on
  every call, and its output stays in it. The parameters stay float32, so
  their gradients and the optimizer's state are float32 (flax's ``dtype=``).
  ``None``, the default, casts nothing: the module computes in its
  parameters' dtype (float32, or float64 where a test evaluates exactly).
* ``groups`` (``BN_GROUPS``, nn/blocks.py:104-118): train-mode BatchNorm
  statistics per contiguous batch chunk, the chunks as ``torch.chunk``
  cuts them (ceil-sized, a short tail), as ``nn.DataParallel`` over
  ``groups`` GPUs gives them; the running statistics take chunk 0's update
  only, as the master replica's buffers are the module's.

BatchNorm on bf16 input follows the JAX ``TorchBatchNorm``
(nn/blocks.py:213-226): statistics in float32 with var = E[x^2] - E[x]^2,
the normalize in bf16 with the float32 per-channel terms cast down; in eval
mode it normalizes in float32 and casts back. Float32 (or float64) input
with one group takes torch's own BatchNorm, as before; with more groups its
statistics are ``torch.var_mean``'s. The running statistics keep the
parameters' dtype.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (module docstring)."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Conv3x3(Conv2d):
    """3x3 conv, pad 1, no bias (model.py:9-12)."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_planes, out_planes, kernel_size=3, stride=stride,
                         padding=1, bias=False, compute_dtype=compute_dtype)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (module docstring)."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def _channel(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-channel (C,) tensor shaped to broadcast over (N, C, ...)."""
    return t.view((1, -1) + (1,) * (ndim - 2))


def _bf16(x: torch.Tensor) -> bool:
    """Whether ``x`` is in the bf16 compute dtype."""
    return x.dtype == torch.bfloat16


def _normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * weight + bias, the terms shaped to
    broadcast. Float32 input normalizes in float32; bf16 input in bf16,
    with the float32 terms cast down (JAX ``TorchBatchNorm``)."""
    inv = torch.rsqrt(var + eps) * weight
    if not _bf16(x):
        return (x - mean) * inv + bias
    dt = x.dtype
    return (x - mean.to(dt)) * inv.to(dt) + bias.to(dt)


def _stats(x: torch.Tensor, dims: tuple[int, ...]):
    """Biased variance and mean over ``dims``, kept dims. Float32 input as
    ``torch.var_mean``; bf16 input as E[x^2] - E[x]^2 in float32 (JAX
    ``TorchBatchNorm``)."""
    if not _bf16(x):
        return torch.var_mean(x, dim=dims, unbiased=False, keepdim=True)
    mean = torch.mean(x, dim=dims, keepdim=True, dtype=torch.float32)
    sq = torch.mean(x.float().square(), dim=dims, keepdim=True)
    return sq - mean.square(), mean


class _GroupedBatchNorm:
    """The train and eval forward shared by :class:`BatchNorm1d` and
    :class:`BatchNorm2d`: torch's own for float32 with one group, else the
    JAX ``TorchBatchNorm``'s (dtype and groups, module docstring)."""

    groups: int

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not _bf16(x) and (self.groups == 1 or not self.training):
            return super().forward(x)
        nd = x.dim()
        w, b = _channel(self.weight, nd), _channel(self.bias, nd)
        if not self.training:
            y = _normalize(x.float(), _channel(self.running_mean, nd),
                           _channel(self.running_var, nd), w, b, self.eps)
            return y.to(x.dtype)
        dims = (0,) + tuple(range(2, nd))
        outs, first = [], None
        for chunk in torch.chunk(x, self.groups, dim=0):
            var, mean = _stats(chunk, dims)
            outs.append(_normalize(chunk, mean, var, w, b, self.eps))
            if first is None:
                first = (mean, var, chunk.numel() // chunk.shape[1])
        mean, var, n = first
        with torch.no_grad():
            self.running_mean.lerp_(mean.flatten(), self.momentum)
            self.running_var.lerp_(var.flatten() * (n / max(n - 1, 1)),
                                   self.momentum)
            self.num_batches_tracked.add_(1)
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


class BatchNorm1d(_GroupedBatchNorm, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with the JAX package's dtype and BN-groups
    semantics (module docstring). State-dict keys are BatchNorm1d's."""

    def __init__(self, num_features: int, groups: int = 1, **kwargs):
        super().__init__(num_features, **kwargs)
        self.groups = _check_groups(groups)


class BatchNorm2d(_GroupedBatchNorm, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with the JAX package's dtype and BN-groups
    semantics (module docstring). State-dict keys are BatchNorm2d's."""

    def __init__(self, num_features: int, groups: int = 1, **kwargs):
        super().__init__(num_features, **kwargs)
        self.groups = _check_groups(groups)


def _check_groups(groups: int) -> int:
    if int(groups) < 1:
        raise ValueError(f"BatchNorm groups must be at least 1, got {groups}")
    return int(groups)


class ObjectBatchNorm2d(BatchNorm2d):
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
    with the unbiased variance. With ``groups`` > 1 each contiguous chunk of
    the B axis runs its own loop over objects, as each DataParallel replica
    does, and the running buffers take chunk 0's; ``groups`` must divide B,
    as the JAX package requires (object pathways always see the full
    batch). Eval mode is :class:`BatchNorm2d`'s. The state-dict keys are
    BatchNorm2d's.
    """

    def __init__(self, num_features: int, n_objects: int, groups: int = 1,
                 **kwargs):
        super().__init__(num_features, groups=groups, **kwargs)
        self.n_objects = int(n_objects)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        o, g = self.n_objects, self.groups
        bo, c, h, w = x.shape
        if bo % o:
            raise ValueError(f"{o} objects do not divide the folded batch "
                             f"({bo})")
        b = bo // o
        if b % g:
            raise ValueError(f"{g} BatchNorm groups must divide the "
                             f"object-pathway batch ({b}): object pathways "
                             "always see the full batch")
        xg = x.reshape(g, b // g, o, c, h, w)
        var, mean = _stats(xg, (1, 4, 5))                 # (G, 1, O, C, 1, 1)
        y = _normalize(xg, mean, var, self.weight.view(1, 1, 1, c, 1, 1),
                       self.bias.view(1, 1, 1, c, 1, 1), self.eps)
        n = (b // g) * h * w
        with torch.no_grad():
            unbiased = var[0].view(o, c) * (n / max(n - 1, 1))
            for i in range(o):
                self.running_mean.lerp_(mean[0].view(o, c)[i], self.momentum)
                self.running_var.lerp_(unbiased[i], self.momentum)
            self.num_batches_tracked.add_(o)
        return y.reshape(bo, c, h, w)


class UpBlock(nn.Sequential):
    """Nearest 2x upsample + conv3x3 + BN + ReLU (model.py:16-22); the
    children's indices give the reference's state-dict keys (``.1.weight``,
    ``.2.running_mean``, ...). ``norm`` builds the BN from the channel
    count: :class:`BatchNorm2d`, or :class:`ObjectBatchNorm2d` in an
    object pathway."""

    def __init__(self, in_planes: int, out_planes: int,
                 norm: Callable[[int], nn.Module] = BatchNorm2d,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"),
                         Conv3x3(in_planes, out_planes,
                                 compute_dtype=compute_dtype),
                         norm(out_planes),
                         nn.ReLU(True))
