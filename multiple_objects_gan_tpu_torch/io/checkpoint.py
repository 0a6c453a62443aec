"""Checkpoints of a training run, newest five kept (the port's counterpart
of the JAX package's orbax ``io/checkpoint.py:CheckpointManager``), for
the stage-1 and stage-2 state, AttnGAN's and DAMSM pretraining's.

Parity target: the reference's save_model with its keep-newest-5 rotation
(code/multi-mnist/miscc/utils.py:160-174). As in the JAX package the whole
training state is saved, so a resume continues exactly: G and D with every
BatchNorm buffer, both Adam states, the step and the epoch, and the state
of the train step's ``torch.Generator``; for AttnGAN every D and its Adam,
and G's EMA (``train/state.py:AttnGanTrainState``); for DAMSM both
encoders, the frozen backbone's buffers included, and the one Adam
(``DamsmTrainState``). ``extra`` holds what else the run needs back, such
as the AttnGAN train set's random state (and DAMSM's eval split's). The JAX step draws its noise from
``fold_in(rng, step)``, so a resumed JAX run draws what an uninterrupted
one draws; the port's generator is carried from step to step instead, and
its state is what makes the resumed run draw the same noise.

Each epoch's checkpoint is ``<directory>/<epoch>/state.pth``, written
under a temporary name and renamed, so a crash while saving never leaves a
half-written file under the name a restore reads. Under a process group
(``parallel/``) rank 0 writes and every rank waits at a barrier until the
file is there; on resume every rank loads the same file (each reader's
state is its own: ``train/loop.py:data_rng_extra``).
"""

from __future__ import annotations

import os
import shutil
from typing import Optional, Union

import torch

from multiple_objects_gan_tpu_torch.io.pycompat import torch_load
from multiple_objects_gan_tpu_torch.parallel.multihost import (
    barrier, is_main_process)
from multiple_objects_gan_tpu_torch.train.state import (
    AttnGanTrainState, DamsmTrainState, GANTrainState)

TrainState = Union[GANTrainState, AttnGanTrainState, DamsmTrainState]

STATE_FILE = "state.pth"
MAX_TO_KEEP = 5             # the newest checkpoints a run keeps


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, str(epoch), STATE_FILE)

    def epochs(self) -> list[int]:
        """The epochs with a complete checkpoint, oldest first."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(self._path(int(d))))

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def save(self, epoch: int, state: TrainState,
             generator: Optional[torch.Generator] = None,
             extra: Optional[dict] = None) -> str:
        """Write ``epoch``'s checkpoint, then drop all but the newest
        ``MAX_TO_KEEP`` (on rank 0; every rank waits for it). Returns its
        path."""
        path = self._path(epoch)
        if is_main_process():
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            torch.save({"epoch": epoch, **state.checkpoint_dict(),
                        "generator": (None if generator is None
                                      else generator.get_state()),
                        "extra": extra or {}}, tmp)
            os.replace(tmp, path)
            for old in self.epochs()[:-MAX_TO_KEEP]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        barrier()
        return path

    def load(self, epoch: Optional[int] = None) -> tuple[dict, int]:
        """The raw checkpoint of ``epoch`` (default the latest) on the CPU,
        and its epoch."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch_load(self._path(epoch)), epoch

    def restore(self, state: TrainState,
                generator: Optional[torch.Generator] = None,
                epoch: Optional[int] = None) -> tuple[int, dict]:
        """Load ``epoch``'s checkpoint (default the latest) into ``state``
        and ``generator`` in place, strictly; returns the epoch and the
        checkpoint's ``extra``."""
        ckpt, epoch = self.load(epoch)
        state.load_checkpoint_dict(ckpt)
        if generator is not None and ckpt["generator"] is not None:
            generator.set_state(ckpt["generator"])
        return epoch, ckpt.get("extra", {})
