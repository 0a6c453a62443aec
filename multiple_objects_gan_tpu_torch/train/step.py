"""The alternating D-then-G train step of Stage 1 (port of the JAX
``train/step.py:make_train_step``).

It follows the reference hot loop (code/multi-mnist/trainer.py:113-157):

  1. one G forward makes the fakes; its graph is kept for step 3;
  2. D update: BCE over the real, wrong and fake pairs with the fakes
     detached, D forwards in the reference's order (real, fake, then the
     heads on real, wrong and fake), which sets the BatchNorm running
     statistics; one backward and one Adam step;
  3. G update through the UPDATED D: D(fake) and its head in train mode,
     then the gradients of G's parameters alone. The JAX step
     differentiates the loss with respect to the image and pulls that back
     through G, so D's parameters get no gradient here;
     ``torch.autograd.grad`` over G's parameters does the same.

The D condition is the label sum for mnist (miscc/utils.py:78), clamped at
0 for clevr, and for coco-stackgan-1 the CA net's mu, detached in both the
D and the G loss (JAX ``train/step.py:91-99``); under the CA net the G loss
adds ``kl_coeff`` times the KL of (mu, logvar) (JAX ``train/step.py:230-
233``), reported as ``kl_loss``. Noise is drawn from the caller's
``torch.Generator`` on the device, or passed in: ``z``, and the CA net's
``eps`` (the tests replay the JAX step's z and ``rng_ca`` draws). There is
one G forward a step.

Under a bf16 compute dtype (``Stage1Config.compute_dtype``) the modules
compute in bf16 and the step does not change: the losses take the logits
in float32 (``losses/gan.py``), the parameters, their gradients, the Adam
state and the BatchNorm running statistics stay float32, and the losses the
step returns are float32.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from multiple_objects_gan_tpu_torch.losses.gan import (
    discriminator_loss, generator_adv_loss, kl_loss)
from multiple_objects_gan_tpu_torch.models.common import Stage1Config
from multiple_objects_gan_tpu_torch.models.stage1 import Stage1G
from multiple_objects_gan_tpu_torch.train.state import GANTrainState, set_lr
from multiple_objects_gan_tpu_torch.utils.images import as_model_image


def _cond(cfg: Stage1Config, label_onehot: torch.Tensor,
          mu: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The condition of the D head (JAX ``train/step.py:_cond``)."""
    if cfg.use_ca:
        return mu.detach()
    cond = label_onehot.sum(dim=1)
    if cfg.variant == "clevr":
        cond = cond.clamp(min=0.0)
    return cond


def make_train_step(cfg: Stage1Config, kl_coeff: float = 2.0) -> Callable:
    """``train_step(state, batch, generator, lr_g, lr_d, z=None, eps=None)
    -> metrics``.

    ``batch`` holds ``image`` (B, H, W, C) uint8 or float, ``bbox``
    (B, O, 4), ``label_onehot`` (B, O, L) and, under the CA net,
    ``text_embedding`` (B, text_dim), on the modules' device. ``kl_coeff``
    is TRAIN.COEFF.KL (``config.train_settings``), read only under the CA
    net. The step updates ``state`` in place and returns its losses as 0-d
    tensors on the device, so the host does not wait for the card.
    """

    def train_step(state: GANTrainState, batch: dict,
                   generator: Optional[torch.Generator], lr_g: float,
                   lr_d: float, z: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None) -> dict:
        g, d = state.g, state.d
        g.train()
        d.train()
        image = as_model_image(batch["image"])
        labels, bbox = batch["label_onehot"], batch["bbox"]
        text = batch.get("text_embedding")
        b = image.shape[0]
        if z is None:
            z = torch.randn((b, cfg.z_dim), generator=generator,
                            device=image.device)
        if cfg.use_ca and eps is None:
            eps = torch.randn((b, cfg.condition_dim), generator=generator,
                              device=image.device)

        fake, mu, logvar = g.outputs(z, bbox, labels, text,
                                     eps if cfg.use_ca else None)
        cond = _cond(cfg, labels, mu)

        # ---- D update
        feat_real = d(image, labels, bbox)
        feat_fake = d(fake.detach(), labels, bbox)
        real_logits = d.cond_logits(feat_real, cond)
        wrong_logits = d.cond_logits(feat_real[:b - 1], cond[1:])
        fake_logits = d.cond_logits(feat_fake, cond)
        u_real = u_fake = None
        if cfg.use_uncond_head:
            u_real = d.uncond_logits(feat_real)
            u_fake = d.uncond_logits(feat_fake)
        err_d, d_parts = discriminator_loss(real_logits, wrong_logits,
                                            fake_logits, u_real, u_fake)
        set_lr(state.d_opt, lr_d)
        state.d_opt.zero_grad(set_to_none=True)
        err_d.backward()
        state.d_opt.step()

        # ---- G update through the updated D
        feat_fake = d(fake, labels, bbox)
        fake_logits = d.cond_logits(feat_fake, cond)
        u_fake = d.uncond_logits(feat_fake) if cfg.use_uncond_head else None
        err_g = generator_adv_loss(fake_logits, u_fake)
        total = err_g
        if cfg.use_ca:
            kl = kl_loss(mu, logvar)
            total = err_g + kl * kl_coeff
        params = [p for p in g.parameters() if p.requires_grad]
        grads = torch.autograd.grad(total, params, allow_unused=True)
        for p, grad in zip(params, grads):
            p.grad = grad      # None for the reference's unused label module
        set_lr(state.g_opt, lr_g)
        state.g_opt.step()
        state.step += 1

        metrics = {"d_loss": err_d, **d_parts, "g_loss": err_g,
                   "g_loss_total": total}
        if cfg.use_ca:
            metrics["kl_loss"] = kl
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_sample_fn(cfg: Stage1Config) -> Callable:
    """``sample(g, z, bbox, labels, text=None) -> image (B, C, H, W)``
    float32: an eval-mode generator forward without autograd (JAX
    ``train/step.py:make_sample_fn``). Under the CA net ``text`` is the
    text embedding and the condition is c = mu (the JAX sampling without a
    CA rng). The image comes back float32 under any compute dtype, as the
    JAX package hands it back (``train/step.py:397-401``), so PNG encoding
    and host reductions never see bf16."""

    def sample(g: Stage1G, z: torch.Tensor, bbox: torch.Tensor,
               labels: torch.Tensor,
               text: Optional[torch.Tensor] = None) -> torch.Tensor:
        g.eval()
        with torch.inference_mode():
            return g(z, bbox, labels, text if cfg.use_ca else None).float()

    return sample
