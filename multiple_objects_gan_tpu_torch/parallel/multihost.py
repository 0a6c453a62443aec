"""Multi-process data parallelism over ``torch.distributed`` (the port's
counterpart of the JAX package's ``parallel/multihost.py``).

The reference is one process (``nn.parallel.data_parallel`` inside it);
the JAX package joins its distributed runtime from the environment and
shards the global batch over a mesh of every process's devices. Here each
process is one rank of a ``torch.distributed`` process group:

* :func:`maybe_initialize_distributed` joins the group from the same
  environment as the JAX package (``MOG_COORDINATOR=host:port
  MOG_NUM_PROCESSES=n MOG_PROCESS_ID=i``), or from torchrun's (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), the
  counterpart of ``MOG_MULTIHOST=1``'s auto-detection. The init method
  is always an explicit ``tcp://`` address.
* The backend is NCCL when every rank of a host owns a card of its own,
  and gloo on the CPU or when ranks share a card (NCCL takes one rank a
  card). The choice and its reason are printed. An NCCL that fails to
  start raises; nothing falls back to gloo.
* Each rank runs on ``cuda:LOCAL_RANK % device_count`` (:func:`rank_device`).
* cfg batch sizes stay GLOBAL, as in the reference, where one process was
  the whole world: :func:`local_batch_size` is a rank's share and
  :func:`shard_loader_kwargs` gives the ``Loader`` its share and its shard
  of the seeded order.

Without the environment nothing starts: world size 1, rank 0, and every
helper of ``parallel/mesh.py`` is the identity.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_LOCAL_RANK = 0


def _launch_env() -> Optional[tuple]:
    """(address ``host:port``, world size, rank, local rank, ranks on this
    host) from the ``MOG_*`` or torchrun environment, or None."""
    env = os.environ
    if env.get("MOG_COORDINATOR"):
        world = int(env["MOG_NUM_PROCESSES"])
        rank = int(env["MOG_PROCESS_ID"])
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        local_rank = int(env.get("LOCAL_RANK", rank % local_world))
        return env["MOG_COORDINATOR"], world, rank, local_rank, local_world
    if env.get("WORLD_SIZE") and env.get("RANK") and env.get("MASTER_ADDR"):
        world = int(env["WORLD_SIZE"])
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        return (f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}",
                world, int(env["RANK"]), int(env.get("LOCAL_RANK", 0)),
                local_world)
    return None


def choose_backend(device: torch.device, local_world: int) -> tuple:
    """(backend, why): ``nccl`` when each of the ``local_world`` ranks of
    this host has a card of its own, else ``gloo``."""
    if device.type != "cuda":
        return "gloo", "ranks on the CPU"
    n = torch.cuda.device_count()
    if local_world > n:
        return "gloo", (f"{local_world} ranks share {n} card(s) of this "
                        "host; NCCL takes one rank a card")
    return "nccl", f"one card a rank ({local_world} ranks, {n} cards)"


def maybe_initialize_distributed(device="cuda") -> bool:
    """Join the process group the environment describes, for a run on
    ``device``; a no-op without that environment or when the group
    exists. Returns whether a group is up."""
    global _LOCAL_RANK
    if dist.is_initialized():
        return True
    launch = _launch_env()
    if launch is None:
        return False
    address, world, rank, local_rank, local_world = launch
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    backend, why = choose_backend(dev, local_world)
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world, rank=rank)
    _LOCAL_RANK = local_rank
    print(f"torch.distributed: rank {rank} of {world}, backend {backend} "
          f"({why})", flush=True)
    return True


def destroy_distributed() -> None:
    """Leave the process group, when there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """True on the rank that owns logging, images and checkpoint files."""
    return rank() == 0


def backend() -> Optional[str]:
    """The process group's backend, or None without one."""
    return dist.get_backend() if dist.is_initialized() else None


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK % device_count`` on the card,
    the CPU as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or not dist.is_initialized():
        return dev
    return torch.device("cuda", _LOCAL_RANK % torch.cuda.device_count())


def local_batch_size(global_batch: int) -> int:
    """The per-process share of a global batch (cfg batch sizes are GLOBAL,
    like the reference's: one process was the whole world there)."""
    pc = world_size()
    if global_batch % pc:
        raise ValueError(
            f"global batch {global_batch} must divide evenly over "
            f"{pc} processes")
    return global_batch // pc


def shard_loader_kwargs(global_batch: int) -> dict:
    """Loader kwargs for multi-process data sharding: each process batches
    its per-process share of the global batch from a disjoint slice of
    the (identically seeded) shuffled order. Single process: the whole
    batch and shard (0, 1)."""
    return {"batch_size": local_batch_size(global_batch),
            "shard": (rank(), world_size())}


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()
