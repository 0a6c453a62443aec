"""Building blocks, NCHW, as the reference defines them: stage 1's
(code/multi-mnist/model.py:9-22), AttnGAN's GLU forms
(code/coco/attngan/model.py:24-81) and its discriminators' blocks
(model.py:586-613).

The JAX package's ``TorchBatchNorm`` and ``Dense`` are :class:`BatchNorm1d`,
:class:`BatchNorm2d` (eps 1e-5, momentum 0.1) and :class:`Linear` here; its
``object_fold`` path is :class:`ObjectBatchNorm2d` and
:class:`ObjectBatchNorm1d`. Its ``UpConv3x3``
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

The JAX package also reads both knobs from the environment when it is
imported (``MOG_COMPUTE_DTYPE``, ``MOG_BN_GROUPS``; nn/blocks.py:40-43
and :104). The port's entries read them through
:func:`env_compute_dtype` and :func:`env_bn_groups` when they parse their
arguments, never at import.

Under a process group of more than one rank (``parallel/``), train-mode
statistics are those of the global batch, as XLA's sync-BN computes them
over a sharded batch: each rank's count, mean and sum of squared
deviations, gathered with autograd and combined (Chan et al.), so that
local counts may differ (the wrong pair's last rank holds one row fewer)
and no E[x^2] - E[x]^2 loses digits across ranks. ``groups`` G then
counts the global batch's chunks, as JAX groups them whatever the device
count (nn/blocks.py:95-104 of the JAX package): chunk k is the rows
torch.chunk gives it of the global batch, and a rank holds rows
[r N / W, (r + 1) N / W). When G is a multiple of the world size W, every
chunk a rank touches lies inside it: each rank normalizes its G / W
chunks and no statistic is gathered. Otherwise a chunk spans ranks: each
rank gathers the row counts (its offset), computes count, mean and sum
of squared deviations for its rows of every chunk (count 0 for a chunk it
does not touch), and the ranks combine them per chunk as above. Either
way the running buffers take global chunk 0's update and are broadcast
from rank 0. At world size 1 the code path is the one described above.

A checkpointed region (``train/remat.py``, ``MOG_REMAT``) runs its
forward again in the backward. Those runs happen under
:func:`running_stats_frozen`: they normalize exactly as the first run did
(the same statistics, the same collectives on every rank) and leave the
running statistics and ``num_batches_tracked`` as the first run left
them, as the JAX package's functional BatchNorm updates them once.

BatchNorm on bf16 input follows the JAX ``TorchBatchNorm``
(nn/blocks.py:213-226): statistics in float32 with var = E[x^2] - E[x]^2,
the normalize in bf16 with the float32 per-channel terms cast down; in eval
mode it normalizes in float32 and casts back. Float32 (or float64) input
with one group takes torch's own BatchNorm, as before; with more groups its
statistics are ``torch.var_mean``'s. The running statistics keep the
parameters' dtype.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from multiple_objects_gan_tpu_torch.parallel import mesh
from multiple_objects_gan_tpu_torch.parallel.multihost import (
    rank, world_size)

# > 0 while a checkpointed region runs its forward again (train/remat.py)
_RECOMPUTING = 0


def env_compute_dtype() -> Optional[torch.dtype]:
    """``MOG_COMPUTE_DTYPE`` as the JAX package reads it (nn/blocks.py:40-43
    there): ``bf16`` or ``bfloat16``, in any case, gives torch.bfloat16;
    anything else, or no value, None (float32)."""
    value = os.environ.get("MOG_COMPUTE_DTYPE", "").lower()
    return torch.bfloat16 if value in ("bf16", "bfloat16") else None


def env_bn_groups() -> int:
    """``MOG_BN_GROUPS`` as the JAX package reads it (nn/blocks.py:104
    there): an int, 1 when it is unset or empty; a value that is not an
    int raises a ValueError naming the variable."""
    value = os.environ.get("MOG_BN_GROUPS", "") or "1"
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"MOG_BN_GROUPS must be an int, got "
                         f"{value!r}") from None


@contextlib.contextmanager
def running_stats_frozen():
    """Train-mode BatchNorm inside normalizes as usual but updates no
    running statistic and no ``num_batches_tracked``: the context of a
    checkpointed region's second and later runs (module docstring)."""
    global _RECOMPUTING
    _RECOMPUTING += 1
    try:
        yield
    finally:
        _RECOMPUTING -= 1


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


def _moments(x: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """(count, mean, count x biased var) of ``x`` over ``dims``, stacked on
    a new leading axis, kept dims (:func:`_stats`); zeros without rows."""
    n = 1
    for d in dims:
        n *= x.shape[d]
    if n:
        var, mean = _stats(x, dims)
    else:
        shape = [1 if d in dims else s for d, s in enumerate(x.shape)]
        var = mean = x.new_zeros(shape, dtype=torch.float32 if _bf16(x)
                                 else x.dtype)
    return torch.stack([torch.full_like(mean, float(n)), mean, var * n])


def _combined(local: torch.Tensor):
    """(biased var, mean, count) of every rank's :func:`_moments`
    ``local`` (3, ...), gathered with autograd and combined by Chan et
    al.'s pairwise rule. A rank with no rows adds nothing."""
    counts, means, m2s = mesh.all_gather(local).unbind(1)
    total = counts.sum(0)
    mean_g = (counts * means).sum(0) / total
    m2 = m2s.sum(0) + (counts * (means - mean_g).square()).sum(0)
    return m2 / total, mean_g, total


def _synced_stats(x: torch.Tensor, dims: tuple[int, ...]):
    """(biased var, mean, count) over ``dims`` of the global batch."""
    return _combined(_moments(x, dims))


def _chunk_rows(rows: list[int], groups: int) -> tuple[list, int]:
    """torch.chunk's ``groups`` chunks of a global leading axis held by
    ranks with ``rows`` rows each, in rank order: this rank's part of each
    chunk it touches, [(chunk, first, end)] in its own rows, and the number
    of chunks."""
    total, offset = sum(rows), sum(rows[:rank()])
    size = -(-total // groups)
    n_chunks = -(-total // size)
    parts = []
    for k in range(n_chunks):
        lo = max(k * size, offset)
        hi = min((k + 1) * size, offset + rows[rank()])
        if lo < hi:
            parts.append((k, lo - offset, hi - offset))
    return parts, n_chunks


def _spanning_stats(x: torch.Tensor, dims: tuple[int, ...], parts: list,
                    n_chunks: int):
    """(biased var, mean, count), each (n_chunks, ...), of every chunk of
    the global batch (:func:`_chunk_rows`), this rank's rows of a chunk
    the leading-axis slices of ``x`` in ``parts``."""
    mine = {k: (lo, hi) for k, lo, hi in parts}
    local = [_moments(x[slice(*mine[k])] if k in mine else x[:0], dims)
             for k in range(n_chunks)]
    return _combined(torch.stack(local, dim=1))


def _spans_ranks(groups: int, world: int) -> bool:
    """Whether a chunk of ``groups`` may span ranks: G > 1 chunks over a
    world size that does not divide them."""
    return world > 1 and groups > 1 and groups % world != 0


def _local_groups(groups: int) -> int:
    """A rank's share of ``groups`` global BatchNorm chunks when the world
    size divides them (one group is the global batch's statistics,
    whatever the world size)."""
    return 1 if groups == 1 else groups // world_size()


class _GroupedBatchNorm:
    """The train and eval forward shared by :class:`BatchNorm1d` and
    :class:`BatchNorm2d`: torch's own for float32 with one group, else the
    JAX ``TorchBatchNorm``'s (dtype and groups, module docstring)."""

    groups: int

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        world = world_size() if self.training else 1
        if not _bf16(x) and world == 1 and (self.groups == 1
                                            or not self.training):
            if self.training and _RECOMPUTING:
                # torch's own with momentum 0, which leaves the buffers as
                # they are: the first run's ops and saved tensors, which
                # a checkpoint's recompute must repeat
                return F.batch_norm(x, self.running_mean, self.running_var,
                                    self.weight, self.bias, True, 0.0,
                                    self.eps)
            return super().forward(x)
        nd = x.dim()
        w, b = _channel(self.weight, nd), _channel(self.bias, nd)
        if not self.training:
            y = _normalize(x.float(), _channel(self.running_mean, nd),
                           _channel(self.running_var, nd), w, b, self.eps)
            return y.to(x.dtype)
        dims = (0,) + tuple(range(2, nd))
        if world > 1 and self.groups == 1:
            var, mean, n = _synced_stats(x, dims)
            self._update_running(mean.flatten(), var.flatten(), n.flatten())
            return _normalize(x, mean, var, w, b, self.eps)
        if _spans_ranks(self.groups, world):
            counts = mesh.all_gather(torch.tensor(x.shape[0],
                                                  device=x.device))
            parts, n_chunks = _chunk_rows(counts.tolist(), self.groups)
            var, mean, n = _spanning_stats(x, dims, parts, n_chunks)
            outs = [_normalize(x[lo:hi], mean[k], var[k], w, b, self.eps)
                    for k, lo, hi in parts]
            self._update_running(mean[0].flatten(), var[0].flatten(),
                                 n[0].flatten())
            return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
        outs, first = [], None
        for chunk in torch.chunk(x, _local_groups(self.groups), dim=0):
            var, mean = _stats(chunk, dims)
            outs.append(_normalize(chunk, mean, var, w, b, self.eps))
            if first is None:
                first = (mean, var, chunk.numel() // chunk.shape[1])
        mean, var, n = first
        self._update_running(mean.flatten(), var.flatten(), n)
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    def _update_running(self, mean, var, n) -> None:
        """One running-statistic update from a batch of ``n`` values a
        channel (unbiased variance); with groups under a process group,
        rank 0's chunk 0 gives it and the replicas take rank 0's
        buffers."""
        if _RECOMPUTING:
            return
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var * (n / _at_least_one(n - 1)),
                                   self.momentum)
            self.num_batches_tracked.add_(1)
            if self.groups > 1:
                mesh.broadcast_([self.running_mean, self.running_var])


def _at_least_one(n):
    """max(n, 1) for an int or a tensor of counts."""
    return n.clamp(min=1) if isinstance(n, torch.Tensor) else max(n, 1)


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


def set_bn_groups(module: nn.Module, groups: int) -> nn.Module:
    """Every BatchNorm of ``module`` (:class:`BatchNorm1d`,
    :class:`BatchNorm2d` and the object pathways') takes ``groups``, as
    the JAX package's ``set_bn_groups`` reaches every ``TorchBatchNorm``.
    Returns ``module``."""
    groups = _check_groups(groups)
    for m in module.modules():
        if isinstance(m, _GroupedBatchNorm):
            m.groups = groups
    return module


def _check_groups(groups: int) -> int:
    if int(groups) < 1:
        raise ValueError(f"BatchNorm groups must be at least 1, got {groups}")
    return int(groups)


class _ObjectBatchNorm:
    """Train-mode BatchNorm of an object pathway, whose batch axis folds
    (B, O) with O minor.

    The reference runs its object pathways as a loop over objects that
    calls the same module once per object (code/multi-mnist/
    model.py:162-169,227-234; the label embedding of code/coco/stackgan/
    model.py:201-214). In train mode that gives per-object statistics, and
    O running-stat updates per forward. The subclasses compute the same on
    the folded batch, as the JAX package's ``TorchBatchNorm`` does under
    ``object_fold`` (nn/blocks.py:295-351): each object's slice is
    normalized with its own mean and biased variance, and the running
    buffers take the O updates in object order, with the unbiased
    variance. With ``groups`` > 1 each contiguous chunk of the B axis runs
    its own loop over objects, as each DataParallel replica does, and the
    running buffers take chunk 0's; ``groups`` must divide the global B, as
    the JAX package requires (object pathways always see the full batch).
    Under a process group the per-object statistics are the global batch's,
    or its chunks', which may span ranks, as the module docstring says of
    the plain BatchNorm. Eval mode is the plain BatchNorm's. The state-dict
    keys are BatchNorm's.
    """

    groups: int

    def __init__(self, num_features: int, n_objects: int, groups: int = 1,
                 **kwargs):
        super().__init__(num_features, groups=groups, **kwargs)
        self.n_objects = int(n_objects)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        o, world = self.n_objects, world_size()
        bo, c = x.shape[:2]
        if bo % o:
            raise ValueError(f"{o} objects do not divide the folded batch "
                             f"({bo})")
        b = bo // o
        total = b * world if self.groups > 1 else b
        if total % self.groups:
            raise ValueError(f"{self.groups} BatchNorm groups must divide "
                             f"the object-pathway batch ({total}): object "
                             "pathways always see the full batch")
        spatial = x.shape[2:]
        ones = (1,) * len(spatial)
        if _spans_ranks(self.groups, world):
            # every rank holds b rows: the chunks follow without a gather
            xr = x.reshape((b, o, c) + spatial)
            parts, n_chunks = _chunk_rows([b] * world, self.groups)
            var, mean, n = _spanning_stats(
                xr, (0,) + tuple(range(3, xr.dim())), parts, n_chunks)
            w, bias = (t.view((1, 1, c) + ones)
                       for t in (self.weight, self.bias))
            y = torch.cat([_normalize(xr[lo:hi], mean[k], var[k], w, bias,
                                      self.eps) for k, lo, hi in parts])
            n = n[0].view(o, c)
        else:
            g = _local_groups(self.groups)
            xg = x.reshape((g, b // g, o, c) + spatial)
            dims = (1,) + tuple(range(4, xg.dim()))
            n = (b // g) * spatial.numel()
            if world > 1 and self.groups == 1:
                var, mean, n = _synced_stats(xg, dims)   # per object, global
                n = n[0].view(o, c)
            else:
                var, mean = _stats(xg, dims)             # (G, 1, O, C, 1...)
            w, bias = (t.view((1, 1, 1, c) + ones)
                       for t in (self.weight, self.bias))
            y = _normalize(xg, mean, var, w, bias, self.eps)
        if not _RECOMPUTING:
            self._update_objects(mean[0].view(o, c), var[0].view(o, c), n)
        return y.reshape(x.shape)

    def _update_objects(self, mean, var, n) -> None:
        """The O running-statistic updates, in object order, from global
        chunk 0's per-object ``mean`` and biased ``var`` (O, C) over ``n``
        values each; the replicas take rank 0's buffers."""
        with torch.no_grad():
            unbiased = var * (n / _at_least_one(n - 1))
            for i in range(self.n_objects):
                self.running_mean.lerp_(mean[i], self.momentum)
                self.running_var.lerp_(unbiased[i], self.momentum)
            self.num_batches_tracked.add_(self.n_objects)
            if self.groups > 1:
                mesh.broadcast_([self.running_mean, self.running_var])


class ObjectBatchNorm2d(_ObjectBatchNorm, BatchNorm2d):
    """BatchNorm2d of an object pathway (:class:`_ObjectBatchNorm`): the
    BatchNorms of the G and D object pathways."""


class ObjectBatchNorm1d(_ObjectBatchNorm, BatchNorm1d):
    """BatchNorm1d of an object pathway (:class:`_ObjectBatchNorm`): the
    label embedding's, whose statistics are per object, not pooled over
    B * O (the JAX ``LabelEmbed`` runs under ``object_fold``)."""


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


class ResBlock(nn.Module):
    """conv3x3 + BN + ReLU + conv3x3 + BN, the skip added, then ReLU
    (code/coco/stackgan/model.py:25-41; JAX ``nn/blocks.py:ResBlock``).
    Keys ``block.{0,1,3,4}``, as the reference's Sequential numbers them."""

    def __init__(self, channels: int,
                 compute_dtype: Optional[torch.dtype] = None,
                 bn_groups: int = 1):
        super().__init__()
        self.block = nn.Sequential(
            Conv3x3(channels, channels, compute_dtype=compute_dtype),
            BatchNorm2d(channels, groups=bn_groups),
            nn.ReLU(True),
            Conv3x3(channels, channels, compute_dtype=compute_dtype),
            BatchNorm2d(channels, groups=bn_groups))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.block(x) + x)


def glu(x: torch.Tensor) -> torch.Tensor:
    """Gated linear unit over the channel axis (dim 1): the first half
    times the sigmoid of the second (attngan model.py:24-32)."""
    c = x.shape[1] // 2
    return x[:, :c] * torch.sigmoid(x[:, c:])


class GLU(nn.Module):
    """:func:`glu` as a module, a child of the reference's Sequentials."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return glu(x)


class UpBlockGLU(nn.Sequential):
    """AttnGAN's upBlock: nearest 2x upsample + conv3x3 to twice
    ``out_planes`` + BN + GLU (model.py:48-55; JAX ``UpBlockGLU``). Keys
    ``.1.weight`` and ``.2.*``; ``norm`` builds the BN as for
    :class:`UpBlock`."""

    def __init__(self, in_planes: int, out_planes: int,
                 norm: Callable[[int], nn.Module] = BatchNorm2d,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"),
                         Conv3x3(in_planes, out_planes * 2,
                                 compute_dtype=compute_dtype),
                         norm(out_planes * 2),
                         GLU())


class ResBlockGLU(nn.Module):
    """AttnGAN's ResBlock: conv3x3 to 2c + BN + GLU + conv3x3 + BN, the
    skip added, with no final ReLU, unlike :class:`ResBlock`
    (model.py:67-81; JAX ``ResBlockGLU``). Keys ``block.{0,1,3,4}``."""

    def __init__(self, channels: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.block = nn.Sequential(
            Conv3x3(channels, channels * 2, compute_dtype=compute_dtype),
            BatchNorm2d(channels * 2),
            GLU(),
            Conv3x3(channels, channels, compute_dtype=compute_dtype),
            BatchNorm2d(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x) + x


def _leaky() -> nn.Module:
    return nn.LeakyReLU(0.2, inplace=True)


class Block3x3LeakReLU(nn.Sequential):
    """AttnGAN's Block3x3_leakRelu: conv3x3 + BN + LeakyReLU 0.2
    (model.py:586-593; JAX ``Block3x3LeakReLU``). Keys ``.0.weight`` and
    ``.1.*``."""

    def __init__(self, in_planes: int, out_planes: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(Conv3x3(in_planes, out_planes,
                                 compute_dtype=compute_dtype),
                         BatchNorm2d(out_planes), _leaky())


def _down_conv(in_planes: int, out_planes: int,
               compute_dtype: Optional[torch.dtype]) -> Conv2d:
    """conv4x4, stride 2, pad 1, no bias: half the side."""
    return Conv2d(in_planes, out_planes, kernel_size=4, stride=2, padding=1,
                  bias=False, compute_dtype=compute_dtype)


class DownBlock(nn.Sequential):
    """AttnGAN's downBlock: conv4x4/s2 + BN + LeakyReLU 0.2
    (model.py:596-603; JAX ``DownBlock``). Keys ``.0.weight`` and
    ``.1.*``."""

    def __init__(self, in_planes: int, out_planes: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(_down_conv(in_planes, out_planes, compute_dtype),
                         BatchNorm2d(out_planes), _leaky())


class EncodeImageBy16Times(nn.Sequential):
    """AttnGAN's encode_image_by_16times: four conv4x4/s2 with LeakyReLU
    0.2, the last three with BN, 3 -> 8 * ndf channels (model.py:606-613;
    JAX ``EncodeImageBy16Times``). Keys ``.{0,2,5,8}.weight`` (the convs)
    and ``.{3,6,9}.*`` (the BNs)."""

    def __init__(self, ndf: int,
                 compute_dtype: Optional[torch.dtype] = None):
        dt = compute_dtype
        layers = [_down_conv(3, ndf, dt), _leaky()]
        for mult in (1, 2, 4):
            layers += [_down_conv(ndf * mult, ndf * mult * 2, dt),
                       BatchNorm2d(ndf * mult * 2), _leaky()]
        super().__init__(*layers)
