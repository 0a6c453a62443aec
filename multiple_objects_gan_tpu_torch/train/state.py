"""Training state of the GAN, either stage (port of the JAX
``train/state.py``).

The JAX package keeps one immutable pytree; here the state is the two
modules, their two Adams and the step counter. The optimizers update the
modules' parameters in place, and the BatchNorm running statistics live in
the modules' buffers, as in the reference. Stage 2's state holds the
stage-2 G and D only: the frozen stage-1 G stays outside it, as in the JAX
package (``train/step.py:303-336``), so a checkpoint holds stage 2 alone.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Union

import torch

from multiple_objects_gan_tpu_torch.models.common import Stage1Config
from multiple_objects_gan_tpu_torch.models.stage1 import (
    Stage1D, Stage1G, build_stage1_d, build_stage1_g)
from multiple_objects_gan_tpu_torch.models.stage2 import (
    Stage2D, Stage2G, build_stage2_d, build_stage2_g)


@dataclasses.dataclass
class GANTrainState:
    g: Union[Stage1G, Stage2G]
    d: Union[Stage1D, Stage2D]
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


def _with_adams(g: torch.nn.Module, d: torch.nn.Module) -> GANTrainState:
    g.train()
    d.train()
    return GANTrainState(g=g, d=d, g_opt=make_optimizer(g.parameters()),
                         d_opt=make_optimizer(d.parameters()))


def create_state(cfg: Stage1Config, *, seed: int = 0, device="cuda",
                 g_state_dict: Optional[dict] = None,
                 d_state_dict: Optional[dict] = None) -> GANTrainState:
    """G and D on ``device`` in train mode, from the given state dicts or
    the reference's random init (G from ``seed``, D from ``seed + 1``),
    with fresh Adams and step 0."""
    return _with_adams(
        build_stage1_g(cfg, g_state_dict, seed=seed, device=device),
        build_stage1_d(cfg, d_state_dict, seed=seed + 1, device=device))


def create_state_stage2(cfg: Stage1Config, *, seed: int = 0,
                        device="cuda") -> GANTrainState:
    """Stage 2's G2 and D2 (``cfg`` the stage-2 config) from the
    reference's random init (G2 from ``seed``, D2 from ``seed + 1``), with
    fresh Adams and step 0 (JAX ``create_state_stage2``)."""
    return _with_adams(build_stage2_g(cfg, seed=seed, device=device),
                       build_stage2_d(cfg, seed=seed + 1, device=device))
