"""The data-parallel layer over ``torch.distributed``: the torch
counterparts of the JAX package's SPMD pieces (``parallel/mesh.py``).

The JAX package shards the leading (batch) axis of one global batch over a
1-D mesh, replicates parameters and optimizer state, and lets XLA insert
the collectives: the gradient psum, the BatchNorm statistics over the
global batch, and the collective-permute of the wrong pair. Here each rank
holds its contiguous slice of the global batch and the collectives are
explicit:

* :func:`make_mesh_for_batch` checks that the global batch divides over
  the ranks; :func:`shard_batch` keeps a rank's contiguous slice, the
  chunk of the leading axis that JAX's sharding gives a device;
* :func:`replicate_state` broadcasts parameters, buffers and optimizer
  state from rank 0;
* :func:`all_reduce_grads` sums the gradients of an optimizer's
  parameters over the ranks in one flat buffer, after each backward and
  before each optimizer step. Every loss a rank differentiates is its
  local sum over the GLOBAL count (:func:`share`), so the sum is the
  gradient of JAX's mean;
* :func:`all_gather` and :func:`gather_rows` gather with autograd: the
  backward sums each rank's gradient back to the rank that owns the rows
  (the sync-BN statistics of ``nn/blocks.py``, the DAMSM scores);
* :func:`shifted_pair` is a rank's part of the global wrong pair
  ``feat[:B-1]`` against ``cond[1:]``, whose row at a rank boundary comes
  from the next rank;
* :func:`draw` draws noise for the global batch from the shared generator
  and keeps the rank's rows, so that a world-2 run draws what a world-1
  run of the same global batch draws;
* :func:`reduce_metrics` sums the ranks' shares of the losses.

Every collective is an all-reduce or a broadcast, which gloo runs on CUDA
tensors as well as NCCL does. With world size 1 every helper is the
identity and no collective runs, so a run without a process group is what
it was before this layer existed. ``torch.nn.parallel.
DistributedDataParallel`` is not used: the D update runs D three times
before its one backward, and the G update backpropagates through D.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist

from multiple_objects_gan_tpu_torch.parallel.multihost import (
    backend, rank, world_size)

# the gradient all-reduce's calls and host seconds, synchronised on the
# card, while TIMING is on (tools/dist_steps.py reads them)
TIMING = False
ALLREDUCE = {"calls": 0, "seconds": 0.0}


def make_mesh_for_batch(global_batch: int) -> int:
    """The world size the global batch shards over; it must divide the
    batch (no prefix-clamping across processes)."""
    world = world_size()
    if global_batch % world:
        raise ValueError(
            f"global batch {global_batch} must divide over {world} "
            "processes on a multi-process mesh (no prefix-clamping across "
            "hosts)")
    return world


def rank_rows(n: int) -> slice:
    """This rank's contiguous rows of a global leading axis of ``n``."""
    world = world_size()
    b = n // world
    return slice(rank() * b, (rank() + 1) * b)


def shard_batch(batch: dict) -> dict:
    """A rank's contiguous slice of every array of a global batch; the
    batch itself at world size 1."""
    if world_size() == 1:
        return batch
    n = len(next(iter(batch.values())))
    make_mesh_for_batch(n)
    rows = rank_rows(n)
    return {k: v[rows] for k, v in batch.items()}


def _collective_device(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend can reduce it: NCCL takes CUDA tensors only
    (an Adam ``step`` counter lives on the CPU)."""
    if backend() == "nccl" and t.device.type != "cuda":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def broadcast_(tensors: Iterable[torch.Tensor]) -> None:
    """Overwrite every tensor with rank 0's, in place."""
    if world_size() == 1:
        return
    for t in tensors:
        moved = _collective_device(t)
        dist.broadcast(moved, src=0)
        if moved is not t:
            t.copy_(moved)


def _state_tensors(value) -> list:
    if isinstance(value, torch.nn.Module):
        return list(value.state_dict().values())
    if isinstance(value, torch.optim.Optimizer):
        return [v for s in value.state.values() for v in s.values()
                if isinstance(v, torch.Tensor)]
    if isinstance(value, dict):
        return [t for v in value.values() for t in _state_tensors(v)]
    if isinstance(value, torch.Tensor):
        return [value]
    return []


def replicate_state(state) -> None:
    """Broadcast a train state's parameters, buffers, optimizer state and
    tensors (AttnGAN's EMA) from rank 0, in place."""
    with torch.no_grad():
        broadcast_([t for v in vars(state).values()
                    for t in _state_tensors(v)])


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum the gradients of ``params`` over the ranks, in one flat buffer;
    a parameter without a gradient (on every rank alike) is skipped."""
    if world_size() == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    t0 = _tick()
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    if TIMING:
        ALLREDUCE["calls"] += 1
        ALLREDUCE["seconds"] += _tick() - t0


def _tick() -> float:
    if TIMING and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter()


def _gathered(x: torch.Tensor) -> torch.Tensor:
    """(...) -> (world, ...): every rank's tensor, by an all-reduce of a
    zero buffer holding each rank's in its slot (exact: x + 0 = x)."""
    buf = x.new_zeros((world_size(),) + tuple(x.shape))
    buf[rank()] = x
    dist.all_reduce(buf)
    return buf


class _AllGather(torch.autograd.Function):
    """:func:`_gathered`, whose backward sums the gradient over the ranks
    and gives each rank its slot."""

    @staticmethod
    def forward(ctx, x):
        return _gathered(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad[rank()]


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on every rank), stacked on a new
    leading axis, with autograd."""
    if world_size() == 1:
        return x[None]
    if x.requires_grad:
        return _AllGather.apply(x)
    return _gathered(x)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch of a rank-sharded ``x``: every rank's rows in rank
    order, with autograd."""
    return all_gather(x).flatten(0, 1)


def shifted_pair(feat: torch.Tensor, cond: torch.Tensor):
    """This rank's rows of the global wrong pair ``feat[:B-1]`` against
    ``cond[1:]``: every rank but the last pairs all its rows with its
    ``cond[1:]`` and the next rank's first row; the last drops its last
    feature."""
    world = world_size()
    if world == 1:
        return feat[:feat.shape[0] - 1], cond[1:]
    firsts = all_gather(cond[:1])       # every rank takes part
    if rank() == world - 1:
        return feat[:feat.shape[0] - 1], cond[1:]
    return feat, torch.cat([cond[1:], firsts[rank() + 1]])


def share(loss: torch.Tensor, n: int, total: int) -> torch.Tensor:
    """A mean over this rank's ``n`` rows as its share of the mean over
    the global ``total``: summed over the ranks, it is the global mean."""
    return loss if n == total else loss * (n / total)


def global_rows(n: int) -> int:
    """The global batch of ranks holding ``n`` rows each."""
    return n * world_size()


def draw(fn: Callable, shape: tuple, generator: Optional[torch.Generator],
         device) -> torch.Tensor:
    """``fn(shape)`` (``torch.randn`` or ``torch.rand``) for the global
    batch from ``generator``, this rank's rows kept: every rank draws the
    same global tensor."""
    world = world_size()
    if world == 1:
        return fn(shape, generator=generator, device=device)
    full = fn((shape[0] * world,) + tuple(shape[1:]), generator=generator,
              device=device)
    return full[rank_rows(full.shape[0])]


def reduce_metrics(metrics: dict, replicated: tuple = ()) -> dict:
    """The losses summed over the ranks (each rank's value is its share),
    in one all-reduce; keys in ``replicated`` hold one value on every rank
    and are left as they are."""
    if world_size() == 1:
        return metrics
    keys = [k for k in metrics if k not in replicated]
    if not keys:
        return metrics
    flat = torch.stack([metrics[k].detach().float().reshape(())
                        for k in keys])
    flat = _collective_device(flat)
    dist.all_reduce(flat)
    out = dict(metrics)
    out.update({k: flat[i].to(metrics[k].device) for i, k in enumerate(keys)})
    return out


def gather_objects(obj) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out
