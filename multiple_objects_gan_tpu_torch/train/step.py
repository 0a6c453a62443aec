"""The alternating D-then-G train steps of Stage 1 and Stage 2 (port of the
JAX ``train/step.py:make_train_step`` and ``make_stage2_train_step``).

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
``torch.Generator`` on the device, or passed in (the rank's rows): ``z``,
and the CA net's ``eps`` (the tests replay the JAX step's z and ``rng_ca``
draws). There is
one G forward a step.

Stage 2 shares the D-then-G core (:func:`_alternating_step`, the JAX
``_fused_alternating_step``): the frozen stage-1 G makes a 64px image, the
stage-2 G refines it to 256px, and D works on 256px with the stage-2 boxes
(:func:`make_stage2_train_step`).

Under a process group of more than one rank (``parallel/``) each rank
holds its contiguous slice of the global batch and the step keeps JAX's
semantics of one global batch: BatchNorm statistics over the global batch
(``nn/blocks.py``), the wrong pair across the rank boundary
(``parallel/mesh.py:shifted_pair``), every loss term a rank's share of
the global mean (a local sum over the global count: B, or B - 1 for the
wrong pair), the gradients summed over the ranks before each Adam step,
the noise drawn for the global batch and sliced, and the losses returned
summed over the ranks. At world size 1 none of this runs.

Under a bf16 compute dtype (``Stage1Config.compute_dtype``) the modules
compute in bf16 and the step does not change: the losses take the logits
in float32 (``losses/gan.py``), the parameters, their gradients, the Adam
state and the BatchNorm running statistics stay float32, and the losses the
step returns are float32.

``MOG_REMAT`` (``train/remat.py``), read when a step is built, wraps the
regions the JAX step wraps in ``maybe_remat``: the stage-1 G forward, the
D update's forwards, heads and loss, and the G update's D forward, heads,
adversarial and KL loss. Stage 2's G2 forward stays unwrapped, as in the
JAX step. Every mode gives mode 0's losses, updates and running
statistics.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from multiple_objects_gan_tpu_torch.losses.gan import (
    discriminator_loss, generator_adv_loss, kl_loss)
from multiple_objects_gan_tpu_torch.models.common import Stage1Config
from multiple_objects_gan_tpu_torch.models.stage1 import Stage1G
from multiple_objects_gan_tpu_torch.parallel import mesh
from multiple_objects_gan_tpu_torch.train.remat import Remat
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


def _alternating_step(state: GANTrainState, g_fwd: Callable,
                      image: torch.Tensor, d_args: tuple, cond_fn: Callable,
                      *, use_uncond: bool, kl_coeff: Optional[float],
                      lr_g: float, lr_d: float, remat: Remat) -> dict:
    """The D-then-G update both stages share (JAX
    ``train/step.py:_fused_alternating_step``).

    ``g_fwd(g) -> (fake, mu, logvar)`` is the one G forward of the step;
    ``d(image, *d_args)`` the D feature forward; ``cond_fn(mu)`` the
    condition of the D head. ``kl_coeff`` None leaves the KL out of the G
    loss. ``remat`` wraps the D-update and G-update regions
    (``train/remat.py:Remat``). Updates ``state`` in place; returns
    the losses, detached."""
    g, d = state.g, state.d
    g.train()
    d.train()
    b = image.shape[0]
    n = mesh.global_rows(b)
    fake, mu, logvar = g_fwd(g)
    cond = cond_fn(mu)

    def d_region(image, fake, cond):
        feat_real = d(image, *d_args)
        feat_fake = d(fake, *d_args)
        real_logits = d.cond_logits(feat_real, cond)
        feat_wrong, cond_wrong = mesh.shifted_pair(feat_real, cond)
        wrong_logits = d.cond_logits(feat_wrong, cond_wrong)
        fake_logits = d.cond_logits(feat_fake, cond)
        u_real = u_fake = None
        if use_uncond:
            u_real = d.uncond_logits(feat_real)
            u_fake = d.uncond_logits(feat_fake)
        return discriminator_loss(
            real_logits, wrong_logits, fake_logits, u_real, u_fake,
            share=lambda loss: mesh.share(loss, b, n),
            wrong_share=lambda loss: mesh.share(loss, feat_wrong.shape[0],
                                                n - 1))

    def g_region(fake, cond, mu, logvar):
        feat_fake = d(fake, *d_args)
        fake_logits = d.cond_logits(feat_fake, cond)
        u_fake = d.uncond_logits(feat_fake) if use_uncond else None
        err_g = mesh.share(generator_adv_loss(fake_logits, u_fake), b, n)
        if kl_coeff is None:
            return err_g, err_g, None
        kl = mesh.share(kl_loss(mu, logvar), b, n)
        return err_g, err_g + kl * kl_coeff, kl

    # ---- D update
    err_d, d_parts = remat(d_region)(image, fake.detach(), cond)
    set_lr(state.d_opt, lr_d)
    state.d_opt.zero_grad(set_to_none=True)
    err_d.backward()
    mesh.all_reduce_grads(d.parameters())
    state.d_opt.step()

    # ---- G update through the updated D
    err_g, total, kl = remat(g_region)(fake, cond, mu, logvar)
    params = [p for p in g.parameters() if p.requires_grad]
    grads = torch.autograd.grad(total, params, allow_unused=True)
    for p, grad in zip(params, grads):
        p.grad = grad      # None for the reference's unused label module
    mesh.all_reduce_grads(params)
    set_lr(state.g_opt, lr_g)
    state.g_opt.step()
    state.step += 1

    metrics = {"d_loss": err_d, **d_parts, "g_loss": err_g,
               "g_loss_total": total}
    if kl_coeff is not None:
        metrics["kl_loss"] = kl
    return mesh.reduce_metrics({k: v.detach() for k, v in metrics.items()})


def make_train_step(cfg: Stage1Config, kl_coeff: float = 2.0) -> Callable:
    """``train_step(state, batch, generator, lr_g, lr_d, z=None, eps=None)
    -> metrics``.

    ``batch`` holds ``image`` (B, H, W, C) uint8 or float, ``bbox``
    (B, O, 4), ``label_onehot`` (B, O, L) and, under the CA net,
    ``text_embedding`` (B, text_dim), on the modules' device. ``kl_coeff``
    is TRAIN.COEFF.KL (``config.train_settings``), read only under the CA
    net. The step updates ``state`` in place and returns its losses as 0-d
    tensors on the device, so the host does not wait for the card.
    ``MOG_REMAT`` is read here (module docstring).
    """
    remat = Remat()

    def train_step(state: GANTrainState, batch: dict,
                   generator: Optional[torch.Generator], lr_g: float,
                   lr_d: float, z: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None) -> dict:
        image = as_model_image(batch["image"])
        labels, bbox = batch["label_onehot"], batch["bbox"]
        text = batch.get("text_embedding")
        b = image.shape[0]
        if z is None:
            z = mesh.draw(torch.randn, (b, cfg.z_dim), generator,
                          image.device)
        if cfg.use_ca and eps is None:
            eps = mesh.draw(torch.randn, (b, cfg.condition_dim), generator,
                            image.device)
        with remat.step((state.g, state.d)):
            return _alternating_step(
                state,
                remat(lambda g: g.outputs(z, bbox, labels, text,
                                          eps if cfg.use_ca else None)),
                image, (labels, bbox), lambda mu: _cond(cfg, labels, mu),
                use_uncond=cfg.use_uncond_head,
                kl_coeff=kl_coeff if cfg.use_ca else None, lr_g=lr_g,
                lr_d=lr_d, remat=remat)

    return train_step


def frozen_forward(g1: Stage1G, *args) -> torch.Tensor:
    """The frozen stage-1 G's image inside the stage-2 step: a train-mode
    forward (batch statistics) without autograd whose running-statistic
    updates are thrown away, as the JAX step discards them
    (``train/step.py:362-365``). The forward runs on clones of the
    buffers (``torch.func.functional_call``), so G1's parameters and
    buffers stay bit-identical; its mode is restored after."""
    was_training = g1.training
    g1.train()
    buffers = {k: v.clone() for k, v in g1.named_buffers()}
    try:
        with torch.no_grad():
            return torch.func.functional_call(g1, buffers, args).detach()
    finally:
        g1.train(was_training)


def make_stage2_train_step(s2_cfg: Stage1Config, s1_cfg: Stage1Config,
                           g1: Stage1G, kl_coeff: float = 2.0) -> Callable:
    """``train_step(state, batch, generator, lr_g, lr_d, z=None, eps1=None,
    eps2=None) -> metrics``: the stage-2 step (code/coco/stackgan/
    trainer.py:155-235, STAGE=2; JAX ``make_stage2_train_step``).

    ``batch`` holds the 256px ``image``, ``bbox`` (the stage-1 boxes),
    ``bbox_s2``, ``label_onehot`` and ``text_embedding``. The frozen
    stage-1 G ``g1`` makes the 64px image from ``z`` and its CA noise
    ``eps1`` (:func:`frozen_forward`); ``state.g``, a Stage2G, refines it
    with its own CA noise ``eps2``; D sees the 256px images with the
    stage-2 boxes. The condition is G2's mu, detached; the unconditional
    head is always on, and KL x ``kl_coeff`` joins the G loss. Noise not
    passed is drawn from ``generator`` in the order z, eps1, eps2.
    ``MOG_REMAT`` is read here; G2's forward stays unwrapped.
    """
    remat = Remat()

    def train_step(state: GANTrainState, batch: dict,
                   generator: Optional[torch.Generator], lr_g: float,
                   lr_d: float, z: Optional[torch.Tensor] = None,
                   eps1: Optional[torch.Tensor] = None,
                   eps2: Optional[torch.Tensor] = None) -> dict:
        image = as_model_image(batch["image"])
        labels, text = batch["label_onehot"], batch["text_embedding"]
        bbox_s1, bbox_s2 = batch["bbox"], batch["bbox_s2"]
        b, dev = image.shape[0], image.device
        if z is None:
            z = mesh.draw(torch.randn, (b, s1_cfg.z_dim), generator, dev)
        if eps1 is None:
            eps1 = mesh.draw(torch.randn, (b, s1_cfg.condition_dim),
                             generator, dev)
        if eps2 is None:
            eps2 = mesh.draw(torch.randn, (b, s2_cfg.condition_dim),
                             generator, dev)
        stage1_img = frozen_forward(g1, z, bbox_s1, labels, text, eps1)
        with remat.step((state.g, state.d)):
            return _alternating_step(
                state,
                lambda g: g.outputs(stage1_img, bbox_s1, bbox_s2, labels,
                                    text, eps2),
                image, (labels, bbox_s2), lambda mu: mu.detach(),
                use_uncond=True, kl_coeff=kl_coeff, lr_g=lr_g, lr_d=lr_d,
                remat=remat)

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
