"""Stage-1 training: the epoch loop and the run around it (the port's copy
of the JAX package's ``train/loop.py``).

Parity target: GANTrainer.train (code/multi-mnist/trainer.py:75-206):

* both learning rates are halved every ``lr_decay_epochs`` epochs,
  computed from the epoch index, so a resumed run lands where a fresh run
  would be (trainer.py:105-111), or set by an ``lr_fn(epoch)`` (DAMSM's
  x0.98 an epoch);
* scalars at the first step of every epoch and every ``LOG_EVERY`` steps
  within it, keyed by the global step (``utils/logging.py``);
* one line an epoch, with the mean of each loss over its steps;
* after each epoch, the eval-mode generator's batch-64 grid on the last
  batch's layouts (``images/fake_samples_epoch_NNN.png``), and the real
  images of that batch once, at the first epoch
  (``images/real_samples.png``);
* a checkpoint every ``snapshot_every`` epochs and always after the last
  (``io/checkpoint.py``, newest five kept);
* with ``profile_dir`` (``--profile``), a torch.profiler trace of steps
  2-5 of the first epoch (JAX ``train/loop.py:84-112``): CPU activity, and
  CUDA's on the card, written there as a Chrome trace.

Under a process group (``parallel/``) every rank runs the same steps on
its shard of the data; rank 0 owns the scalar log and the epoch lines (the
step's losses are already summed over the ranks), writes the checkpoints
(every rank gives its reader's draws to them: :func:`data_rng_extra`) and
alone takes a ``--profile`` trace. The image hooks (epoch grids, montages)
run only in a single-process run, as in the JAX loop (``train/loop.py:
68-69``): a multi-process run renders its grids offline from the
checkpoints.

Batches come from a loader (``data/datasets.py``: ``Loader`` for the sets
on disk, ``MemoryLoader`` for a set held on the device). A batch of numpy
arrays is copied to the device from pinned memory as uint8 and normalised
there by the step (``utils/images.py:as_model_image``); the loader's
prefetch thread keeps the reading off the step's path.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from multiple_objects_gan_tpu_torch.config.config import train_settings
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.io.weights import warm_start
from multiple_objects_gan_tpu_torch.models.common import Stage1Config
from multiple_objects_gan_tpu_torch.parallel import mesh
from multiple_objects_gan_tpu_torch.parallel.multihost import (
    is_main_process, rank, world_size)
from multiple_objects_gan_tpu_torch.train.state import (
    GANTrainState, create_state)
from multiple_objects_gan_tpu_torch.train.step import (
    make_sample_fn, make_train_step)
from multiple_objects_gan_tpu_torch.utils.images import save_grid
from multiple_objects_gan_tpu_torch.utils.logging import MetricWriter

GRID_BATCH = 64          # the epoch grid's batch (JAX train/loop.py:189)
LOG_EVERY = 500          # steps between scalar records within an epoch
PROFILE_STEPS = (2, 5)   # the traced steps of the first epoch (JAX :84-112)


def to_device(batch: dict, device: torch.device) -> dict:
    """A loader's batch on ``device``: numpy arrays go through pinned
    memory to the card; tensors already there stay."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if t.device != device:
            if t.device.type == "cpu" and device.type == "cuda":
                t = t.pin_memory()
            t = t.to(device, non_blocking=True)
        out[k] = t
    return out


def run_epochs(state: GANTrainState, loader, step_fn: Callable,
               generator: Optional[torch.Generator], *, lr_g: float,
               lr_d: float, n_epochs: int, start_epoch: int = 0,
               lr_decay_epochs: int = 0, snapshot_every: int = 0,
               ckpt: Optional[CheckpointManager] = None,
               writer: Optional[MetricWriter] = None,
               epoch_end_fn: Optional[Callable] = None,
               step_hook: Optional[Callable] = None,
               checkpoint_extra: Optional[Callable] = None,
               lr_fn: Optional[Callable] = None,
               profile_dir: Optional[str] = None) -> list[dict]:
    """Train epochs ``start_epoch`` .. ``n_epochs - 1`` over
    ``loader.epoch(epoch)``. ``step_fn(state, batch, generator, lr_g,
    lr_d) -> metrics`` updates ``state`` in place; ``step_hook(state,
    batch, step)`` runs after every step, with the global step it took;
    ``epoch_end_fn(state, last_batch, epoch)`` runs after each epoch;
    ``checkpoint_extra()`` gives a checkpoint's ``extra``; ``lr_fn(epoch)
    -> (lr_g, lr_d)``, when given, replaces ``lr_g``, ``lr_d`` and their
    halving. With ``profile_dir``, steps 2-5 of the first epoch (or 2 to
    its end, when it has fewer) are traced with torch.profiler (CPU, and
    CUDA on the card; a sync before it stops) into a Chrome trace there.
    Returns one dict of mean losses (floats) per epoch, with its step
    count and wall time."""
    if len(loader) == 0:
        raise ValueError(f"the loader makes no batch of {loader.bs}: no "
                         "training would run")
    device = state_device(state)
    main = is_main_process()
    history = []
    prof = None
    for epoch in range(start_epoch, n_epochs):
        t0 = time.perf_counter()
        if lr_fn is not None:
            lr_g_e, lr_d_e = lr_fn(epoch)
        else:
            f = 0.5 ** (epoch // lr_decay_epochs) if lr_decay_epochs else 1.0
            lr_g_e, lr_d_e = lr_g * f, lr_d * f
        sums: dict = {}
        last_batch, n_steps = None, 0
        for i, batch in enumerate(loader.epoch(epoch)):
            batch = to_device(batch, device)
            if (profile_dir and main and epoch == start_epoch
                    and i == PROFILE_STEPS[0]):
                prof = _start_trace(device)
            step = state.step
            metrics = step_fn(state, batch, generator, lr_g_e, lr_d_e)
            if prof is not None and i == PROFILE_STEPS[1]:
                prof = _stop_trace(prof, device, profile_dir)
            if writer is not None and main and i % LOG_EVERY == 0:
                writer.scalars(step, {k: float(v)
                                      for k, v in metrics.items()})
            if step_hook is not None:
                step_hook(state, batch, step)
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
            last_batch, n_steps = batch, n_steps + 1
        if prof is not None:      # the epoch had fewer steps than the trace
            prof = _stop_trace(prof, device, profile_dir)
        means = {k: float(v) / n_steps for k, v in sums.items()}
        means["steps"] = n_steps
        means["seconds"] = time.perf_counter() - t0
        history.append(means)
        if main:
            print(f"[{epoch}/{n_epochs}] "
                  + " ".join(f"{k}={means[k]:.4f}" for k in sorted(sums))
                  + f" lr_g={lr_g_e:g} lr_d={lr_d_e:g} steps={n_steps}"
                  f" time={means['seconds']:.1f}s", flush=True)
        if epoch_end_fn is not None:
            epoch_end_fn(state, last_batch, epoch)
        if ckpt is not None and snapshot_every and (
                (epoch + 1) % snapshot_every == 0 or epoch == n_epochs - 1):
            ckpt.save(epoch, state, generator,     # every rank takes part
                      None if checkpoint_extra is None
                      else checkpoint_extra())
    return history


def single_process(hook: Optional[Callable]) -> Optional[Callable]:
    """An image hook for :func:`run_epochs`: itself in a single-process
    run, None under a process group of more ranks (module docstring)."""
    return hook if world_size() == 1 else None


def _start_trace(device: torch.device):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_trace(prof, device: torch.device, profile_dir: str) -> None:
    """Sync, stop ``prof`` and write its Chrome trace into
    ``profile_dir``; returns None (no trace open)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir,
                                          f"trace_{os.getpid()}.json"))
    print(f"profiler trace written to {profile_dir}", flush=True)
    return None


def state_device(state) -> torch.device:
    """The device of a train state: that of the first module it holds."""
    for value in vars(state).values():
        if isinstance(value, torch.nn.Module):
            return next(value.parameters()).device
    raise ValueError(f"{type(state).__name__} holds no module")


def grid_noise(seed: int, epoch: int, b: int, z_dim: int,
               device: torch.device) -> torch.Tensor:
    """The epoch grid's z: its own draw from (seed, epoch), as the JAX
    loop folds the epoch into its key, so a grid neither moves the step's
    generator nor differs between a resumed and an uninterrupted run."""
    z = np.random.RandomState([seed, epoch]).standard_normal((b, z_dim))
    return torch.from_numpy(z.astype(np.float32)).to(device)


def rng_extra(**sets) -> dict:
    """A checkpoint's ``extra`` for readers that carry their draws'
    ``RandomState`` (the COCO readers' ``rng_state``), keyed as given:
    each key holds this rank's state (rank 0's where rank 0 writes), and,
    under a process group, ``<key>_ranks`` every rank's, so that each rank
    of a resumed run draws what it would have drawn. Every rank calls it.
    """
    out = {}
    for key, ds in sets.items():
        out[key] = ds.rng_state()
        if world_size() > 1:
            out[f"{key}_ranks"] = mesh.gather_objects(out[key])
    return out


def restore_rng(ds, extra: dict, key: str) -> None:
    """Put this rank's state of ``extra[key]`` (:func:`rng_extra`) back
    into ``ds``: its own from ``<key>_ranks`` when the checkpoint has one
    a rank, else the one ``key`` holds."""
    ranks = extra.get(f"{key}_ranks")
    ds.set_rng_state(ranks[rank()] if ranks and len(ranks) == world_size()
                     else extra[key])


def data_rng_extra(loader):
    """``run_epochs``'s ``checkpoint_extra`` for a loader whose set carries
    its draws' ``RandomState`` (:func:`rng_extra` under ``data_rng``), so
    that a resumed run draws what an uninterrupted one draws; None
    otherwise."""
    ds = getattr(loader, "ds", None)
    if not hasattr(ds, "rng_state"):
        return None
    return lambda: rng_extra(data_rng=ds)


def restore_data_rng(loader, extra: dict) -> None:
    """Put a checkpoint's ``data_rng`` (:func:`data_rng_extra`) back."""
    ds = getattr(loader, "ds", None)
    if extra and "data_rng" in extra and hasattr(ds, "set_rng_state"):
        restore_rng(ds, extra, "data_rng")


def train(cfg, mcfg: Stage1Config, loader, output_dir: str, *, device,
          seed: int = 0, max_epochs: Optional[int] = None,
          resume_dir: Optional[str] = None,
          profile_dir: Optional[str] = None
          ) -> tuple[GANTrainState, list[dict]]:
    """The whole stage-1 run of JAX ``train/loop.py:train``: the state from
    the seed, warm-started from cfg ``NET_G``/``NET_D`` ``.pth`` files,
    then restored from ``resume_dir``'s latest checkpoint when there is one
    (training continues at the epoch after it), and replicated from rank
    0 under a process group; logs, grids and checkpoints under
    ``output_dir``; a torch.profiler trace into ``profile_dir`` when
    given. Returns the final state and the per-epoch history."""
    device = torch.device(device)
    os.makedirs(output_dir, exist_ok=True)
    img_dir = os.path.join(output_dir, "images")
    settings = train_settings(cfg)
    state = create_state(mcfg, seed=seed, device=device)
    for path in warm_start(state, cfg.get("NET_G", ""), cfg.get("NET_D", "")):
        print(f"Load from: {path}", flush=True)
    generator = torch.Generator(device=device).manual_seed(seed)
    start_epoch = 0
    if resume_dir:
        prev = CheckpointManager(os.path.join(resume_dir, "models"))
        if prev.latest_epoch() is not None:
            epoch, extra = prev.restore(state, generator)
            restore_data_rng(loader, extra)
            start_epoch = epoch + 1
            print(f"resumed from {resume_dir} at epoch {start_epoch}",
                  flush=True)
    mesh.replicate_state(state)
    n_epochs = settings.max_epoch if max_epochs is None else int(max_epochs)
    sample = make_sample_fn(mcfg)

    def epoch_grids(state, last_batch, epoch):
        b = min(GRID_BATCH, last_batch["image"].shape[0])
        text = last_batch.get("text_embedding")
        fake = sample(state.g, grid_noise(seed, epoch, b, mcfg.z_dim, device),
                      last_batch["bbox"][:b], last_batch["label_onehot"][:b],
                      None if text is None else text[:b])
        save_grid(fake.permute(0, 2, 3, 1).cpu().numpy(),
                  os.path.join(img_dir, f"fake_samples_epoch_{epoch:03d}.png"))
        if epoch == start_epoch:
            save_grid(last_batch["image"][:b].cpu().numpy(),
                      os.path.join(img_dir, "real_samples.png"))

    writer = MetricWriter(os.path.join(output_dir, "logs"))
    try:
        history = run_epochs(
            state, loader, make_train_step(mcfg, settings.kl_coeff),
            generator, lr_g=settings.generator_lr,
            lr_d=settings.discriminator_lr, n_epochs=n_epochs,
            start_epoch=start_epoch, lr_decay_epochs=settings.lr_decay_epoch,
            snapshot_every=int(cfg.TRAIN.SNAPSHOT_INTERVAL),
            ckpt=CheckpointManager(os.path.join(output_dir, "models")),
            writer=writer, epoch_end_fn=single_process(epoch_grids),
            checkpoint_extra=data_rng_extra(loader),
            profile_dir=profile_dir)
    finally:
        writer.close()
    return state, history
