"""Training state of the Stage-1 GAN (port of the JAX ``train/state.py``).

The JAX package keeps one immutable pytree; here the state is the two
modules, their two Adams and the step counter. The optimizers update the
modules' parameters in place, and the BatchNorm running statistics live in
the modules' buffers, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch

from multiple_objects_gan_tpu_torch.models.common import Stage1Config
from multiple_objects_gan_tpu_torch.models.stage1 import (
    Stage1D, Stage1G, build_stage1_d, build_stage1_g)


@dataclasses.dataclass
class GANTrainState:
    g: Stage1G
    d: Stage1D
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    step: int = 0


def make_optimizer(params: Iterable[torch.nn.Parameter]) -> torch.optim.Adam:
    """Adam(betas=(0.5, 0.999), eps=1e-8), as the reference
    (code/multi-mnist/trainer.py:98-99) and the JAX ``make_optimizer``
    (train/step.py:85-88). The learning rate is set by the train step on
    every call, so the epoch-halving schedule is a plain argument."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.5, 0.999), eps=1e-8)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = float(lr)


def create_state(cfg: Stage1Config, *, seed: int = 0, device="cuda",
                 g_state_dict: Optional[dict] = None,
                 d_state_dict: Optional[dict] = None) -> GANTrainState:
    """G and D on ``device`` in train mode, from the given state dicts or
    the reference's random init (G from ``seed``, D from ``seed + 1``),
    with fresh Adams and step 0."""
    g = build_stage1_g(cfg, g_state_dict, seed=seed, device=device).train()
    d = build_stage1_d(cfg, d_state_dict, seed=seed + 1,
                       device=device).train()
    return GANTrainState(g=g, d=d, g_opt=make_optimizer(g.parameters()),
                         d_opt=make_optimizer(d.parameters()))
