"""Training state of the GAN, either stage and AttnGAN (port of the JAX
``train/state.py`` and ``train/attngan_step.py:create_attngan_state``).

The JAX package keeps one immutable pytree; here the state is the two
modules, their two Adams and the step counter. The optimizers update the
modules' parameters in place, and the BatchNorm running statistics live in
the modules' buffers, as in the reference. Stage 2's state holds the
stage-2 G and D only: the frozen stage-1 G stays outside it, as in the JAX
package (``train/step.py:303-336``), so a checkpoint holds stage 2 alone.

AttnGAN's state (:class:`AttnGanTrainState`) holds G, one D a branch
(``d64``, ``d128``, ``d256``), G's Adam and one Adam a D (the reference's
per-D optimizers, code/coco/attngan/trainer.py:137-159), and the EMA of
G's parameters (trainer.py:341-342); the frozen DAMSM encoders stay
outside it.

DAMSM pretraining's state (:class:`DamsmTrainState`, JAX
``train/damsm_step.py:DAMSMTrainState``) holds the text encoder, the whole
image encoder (its frozen Inception backbone and BatchNorm buffers too, so
that a checkpoint restores it byte for byte) and one Adam over the text
encoder's parameters and the image encoder's two heads alone
(:data:`TRAINABLE_IMAGE_KEYS`). Each state gives its checkpoint contents
(:meth:`checkpoint_dict`) and takes them back
(:meth:`load_checkpoint_dict`).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Union

import torch

from multiple_objects_gan_tpu_torch.models.attngan import (
    D_NAMES, AttnGanConfig, GNet, build_attngan_d, build_attngan_g)
from multiple_objects_gan_tpu_torch.models.common import Stage1Config
from multiple_objects_gan_tpu_torch.models.stage1 import (
    Stage1D, Stage1G, build_stage1_d, build_stage1_g)
from multiple_objects_gan_tpu_torch.models.stage2 import (
    Stage2D, Stage2G, build_stage2_d, build_stage2_g)
from multiple_objects_gan_tpu_torch.nn.encoders import CNNEncoder, RNNEncoder

# the image encoder's modules DAMSM pretraining trains (upstream
# pretrain_DAMSM.py re-enables these two; JAX damsm_step.py:41)
TRAINABLE_IMAGE_KEYS = ("emb_features", "emb_cnn_code")


@dataclasses.dataclass
class GANTrainState:
    g: Union[Stage1G, Stage2G]
    d: Union[Stage1D, Stage2D]
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    step: int = 0

    def checkpoint_dict(self) -> dict:
        return {"step": self.step, "g": self.g.state_dict(),
                "d": self.d.state_dict(), "g_opt": self.g_opt.state_dict(),
                "d_opt": self.d_opt.state_dict()}

    def load_checkpoint_dict(self, ckpt: dict) -> None:
        """Strict, in place."""
        self.g.load_state_dict(ckpt["g"])
        self.d.load_state_dict(ckpt["d"])
        self.g_opt.load_state_dict(ckpt["g_opt"])
        self.d_opt.load_state_dict(ckpt["d_opt"])
        self.step = int(ckpt["step"])


@dataclasses.dataclass
class AttnGanTrainState:
    g: GNet
    ds: dict                         # name ("d64", ...) -> D
    g_opt: torch.optim.Adam
    d_opts: dict                     # name -> that D's Adam
    g_ema: dict                      # G's parameter name -> its EMA
    step: int = 0

    def checkpoint_dict(self) -> dict:
        return {"step": self.step, "g": self.g.state_dict(),
                "d": {n: d.state_dict() for n, d in self.ds.items()},
                "g_opt": self.g_opt.state_dict(),
                "d_opt": {n: o.state_dict() for n, o in self.d_opts.items()},
                "g_ema": dict(self.g_ema)}

    def load_checkpoint_dict(self, ckpt: dict) -> None:
        """Strict, in place; the EMA tensors are copied into place."""
        self.g.load_state_dict(ckpt["g"])
        if sorted(ckpt["d"]) != sorted(self.ds):
            raise KeyError(f"checkpoint Ds {sorted(ckpt['d'])}, state Ds "
                           f"{sorted(self.ds)}")
        for n, d in self.ds.items():
            d.load_state_dict(ckpt["d"][n])
            self.d_opts[n].load_state_dict(ckpt["d_opt"][n])
        self.g_opt.load_state_dict(ckpt["g_opt"])
        if sorted(ckpt["g_ema"]) != sorted(self.g_ema):
            raise KeyError("checkpoint EMA keys differ from G's parameters")
        with torch.no_grad():
            for k, v in self.g_ema.items():
                v.copy_(ckpt["g_ema"][k])
        self.step = int(ckpt["step"])


@dataclasses.dataclass
class DamsmTrainState:
    text: RNNEncoder
    image: CNNEncoder
    opt: torch.optim.Adam
    step: int = 0

    def checkpoint_dict(self) -> dict:
        return {"step": self.step, "text": self.text.state_dict(),
                "image": self.image.state_dict(),
                "opt": self.opt.state_dict()}

    def load_checkpoint_dict(self, ckpt: dict) -> None:
        """Strict, in place."""
        self.text.load_state_dict(ckpt["text"])
        self.image.load_state_dict(ckpt["image"])
        self.opt.load_state_dict(ckpt["opt"])
        self.step = int(ckpt["step"])


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


def ema_of(g: torch.nn.Module) -> dict:
    """A copy of every parameter of ``g``, the EMA's start."""
    return {k: p.detach().clone() for k, p in g.named_parameters()}


def create_attngan_state(cfg: AttnGanConfig, *, seed: int = 0,
                         device="cuda") -> AttnGanTrainState:
    """G (from ``seed``) and a D a branch (``d64`` from ``seed + 1``,
    ``d128`` from ``seed + 2``, ``d256`` from ``seed + 3``) on ``device``
    in train mode, from AttnGAN's orthogonal init, with fresh Adams, step 0
    and the EMA equal to G's parameters (JAX ``create_attngan_state``)."""
    g = build_attngan_g(cfg, seed=seed, device=device).train()
    ds = {name: build_attngan_d(cfg, 64 * 2 ** i, seed=seed + 1 + i,
                                device=device).train()
          for i, name in enumerate(D_NAMES[:cfg.branch_num])}
    return AttnGanTrainState(
        g=g, ds=ds, g_opt=make_optimizer(g.parameters()),
        d_opts={n: make_optimizer(d.parameters()) for n, d in ds.items()},
        g_ema=ema_of(g))


def create_damsm_state(text: RNNEncoder, image: CNNEncoder
                       ) -> DamsmTrainState:
    """DAMSM pretraining's state over the given encoders (JAX
    ``create_damsm_state``): every parameter of ``text`` and of the image
    encoder's :data:`TRAINABLE_IMAGE_KEYS` heads takes a gradient, the
    backbone none; one fresh Adam over those, step 0."""
    text.requires_grad_(True)
    image.requires_grad_(False)
    heads = [p for k in TRAINABLE_IMAGE_KEYS
             for p in getattr(image, k).requires_grad_(True).parameters()]
    return DamsmTrainState(text=text, image=image,
                           opt=make_optimizer([*text.parameters(), *heads]))
