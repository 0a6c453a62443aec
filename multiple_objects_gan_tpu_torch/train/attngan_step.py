"""The AttnGAN train step: one update of each D, then G's with the DAMSM
loss, then G's EMA (port of the JAX ``train/attngan_step.py``).

Reference: condGANTrainer.train (code/coco/attngan/trainer.py:264-354)
and miscc/losses.py:136-226:

  1. the frozen text encoder (eval mode) embeds the captions; its outputs
     take no gradient (trainer.py:284-289);
  2. one G forward in train mode makes an image a branch (64, 128, 256px),
     and its graph is kept for step 4;
  3. each D (``d64``, ``d128``, ``d256``, in that order) takes one update
     with its own Adam (:func:`d_loss_one_scale`): feat(real),
     feat(fake.detach()), then the conditional head on real, fake and wrong
     (``feat_real[:B-1]`` against the sentences ``[1:]``), then the
     unconditional head on real and fake. This order sets the BatchNorm
     running statistics;
  4. G's update through the *updated* Ds: for each D in the same order
     feat(fake), its conditional and unconditional head, BCE towards real;
     plus LAMBDA times the DAMSM word and sentence losses of the 256px image
     through the frozen image encoder (eval mode; the gradient flows through
     it to the image), plus the CA net's KL. The gradients of G's
     parameters alone are taken (``torch.autograd.grad``), as the JAX step
     pulls the image gradient back through G;
  5. the EMA of G's parameters, not its buffers, with decay 0.999
     (trainer.py:341-342).

The D heads give probabilities, so the losses are ``F.binary_cross_entropy``
of them in float32: its log is clamped at -100 and its backward
denominator p (1 - p) at 1e-12, which the JAX step emulates
(``train/attngan_step.py:35-62``). ``z`` and the CA net's ``eps`` are drawn
from the caller's generator in that order, or passed in (the tests replay
the JAX step's draws). ``class_ids`` feeds the DAMSM class mask. The
learning rates are set on every call; the AttnGAN runner never decays them.
Under a process group of more than one rank the step is the stage-1
step's over the ranks (``train/step.py``): sync-BN, the wrong pair across
the rank boundary, each loss term the rank's share of the global mean,
the DAMSM scores over the global batch (``losses/damsm.py``), the
gradients of each D and of G summed before their Adam steps, the noise
drawn for the global batch and sliced; the EMA and the Adams stay
replicated. Under a bf16 compute dtype the modules compute in bf16; the losses, the
parameters, their gradients, the Adam states, the EMA and the BatchNorm
running statistics stay float32. ``MOG_REMAT`` (``train/remat.py``), read
when the step is built, wraps the regions the JAX step wraps: G's forward,
each D's loss, and the G loss with its DAMSM terms.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from multiple_objects_gan_tpu_torch.losses.damsm import sent_loss, words_loss
from multiple_objects_gan_tpu_torch.losses.gan import kl_loss
from multiple_objects_gan_tpu_torch.models.attngan import AttnGanConfig
from multiple_objects_gan_tpu_torch.parallel import mesh
from multiple_objects_gan_tpu_torch.train.remat import Remat
from multiple_objects_gan_tpu_torch.train.state import (
    AttnGanTrainState, set_lr)
from multiple_objects_gan_tpu_torch.utils.images import as_model_image

SMOOTH = {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0, "LAMBDA": 50.0}
EMA_DECAY = 0.999


def bce_probs(p: torch.Tensor, target: float, total: int = 0
              ) -> torch.Tensor:
    """torch BCELoss of probabilities ``p`` against a constant target, in
    float32; with ``total`` the global rows of ``p``, this rank's share
    of the global mean (``parallel/mesh.py:share``)."""
    p = p.float()
    loss = F.binary_cross_entropy(p, torch.full_like(p, target))
    return mesh.share(loss, p.shape[0], total or p.shape[0])


def d_loss_one_scale(d: torch.nn.Module, real: torch.Tensor,
                     fake: torch.Tensor, cond: torch.Tensor,
                     labels: torch.Tensor, bbox: torch.Tensor
                     ) -> torch.Tensor:
    """One D's loss (miscc/losses.py:136-174; JAX ``_d_loss_one_scale``):
    (real + u_real) / 2 + (fake + wrong + u_fake) / 3, with its forwards
    in the reference's order. ``fake`` is detached here. Under a process
    group, the rank's share, the wrong pair across the rank boundary."""
    n = mesh.global_rows(real.shape[0])
    feat_real = d(real, labels, bbox)
    feat_fake = d(fake.detach(), labels, bbox)
    p_real = d.cond_logits(feat_real, cond)
    p_fake = d.cond_logits(feat_fake, cond)
    p_wrong = d.cond_logits(*mesh.shifted_pair(feat_real, cond))
    pu_real = d.uncond_logits(feat_real)
    pu_fake = d.uncond_logits(feat_fake)
    return ((bce_probs(p_real, 1.0, n) + bce_probs(pu_real, 1.0, n)) / 2.0
            + (bce_probs(p_fake, 0.0, n) + bce_probs(p_wrong, 0.0, n - 1)
               + bce_probs(pu_fake, 0.0, n)) / 3.0)


def update_ema(state: AttnGanTrainState) -> None:
    """ema = ema * EMA_DECAY + (1 - EMA_DECAY) * param, for every parameter
    of G (JAX ``train/attngan_step.py:291-293``)."""
    names = list(state.g_ema)
    params = dict(state.g.named_parameters())
    with torch.no_grad():
        ema = [state.g_ema[k] for k in names]
        torch._foreach_mul_(ema, EMA_DECAY)
        torch._foreach_add_(ema, [params[k] for k in names],
                            alpha=1.0 - EMA_DECAY)


def make_attngan_train_step(cfg: AttnGanConfig, text_encoder: torch.nn.Module,
                            image_encoder: torch.nn.Module,
                            smooth: Optional[dict] = None) -> Callable:
    """``train_step(state, batch, generator, lr_g, lr_d, z=None, eps=None)
    -> metrics``.

    ``text_encoder`` and ``image_encoder`` are the frozen DAMSM encoders
    (``RNNEncoder``, ``CNNEncoder`` or a stand-in with its contract); they
    are kept in eval mode. ``smooth`` is TRAIN.SMOOTH (GAMMA1-3, LAMBDA;
    :data:`SMOOTH` fills what it lacks). ``batch`` holds ``image64``,
    ``image128``, ``image256`` (B, H, W, 3) uint8 or float in [-1, 1]
    (those of the state's branches), ``captions`` (B, T) zero-padded,
    ``cap_lens`` (B,), ``class_ids`` (B,) or None, ``bbox`` (B, O, 4) and
    ``label_onehot`` (B, O, 81), on the modules' device. The step updates
    ``state`` in place and returns the JAX step's metrics (``d_loss_d64``
    ..., ``g_loss_d64`` ..., ``w_loss``, ``s_loss``, ``kl_loss``,
    ``g_loss_total``) as 0-d tensors on the device.
    """
    sm = dict(SMOOTH, **{k: float(v) for k, v in (smooth or {}).items()})
    text_encoder.eval()
    image_encoder.eval()
    remat = Remat()

    def g_loss(imgs, mu, logvar, words, sent, labels, bbox, cap_lens,
               class_ids, ds, b, n):
        """G's loss through the updated Ds, the DAMSM terms and the KL:
        (total, {name: term})."""
        total, terms = 0.0, {}
        for i, (name, d) in enumerate(ds.items()):
            feat = d(imgs[i], labels, bbox)
            g_i = (bce_probs(d.cond_logits(feat, sent), 1.0, n)
                   + bce_probs(d.uncond_logits(feat), 1.0, n))
            terms[f"g_loss_{name}"] = g_i
            total = total + g_i
        region, code = image_encoder(imgs[-1])
        w0, w1, _ = words_loss(region, words, cap_lens, class_ids,
                               sm["GAMMA1"], sm["GAMMA2"], sm["GAMMA3"])
        s0, s1 = sent_loss(code, sent, class_ids, sm["GAMMA3"])
        terms["w_loss"] = (w0 + w1) * sm["LAMBDA"]
        terms["s_loss"] = (s0 + s1) * sm["LAMBDA"]
        terms["kl_loss"] = mesh.share(kl_loss(mu, logvar), b, n)
        return (total + terms["w_loss"] + terms["s_loss"]
                + terms["kl_loss"]), terms

    def train_step(state: AttnGanTrainState, batch: dict,
                   generator: Optional[torch.Generator], lr_g: float,
                   lr_d: float, z: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None) -> dict:
        with remat.step((state.g, *state.ds.values(), image_encoder)):
            return _step(state, batch, generator, lr_g, lr_d, z, eps)

    def _step(state, batch, generator, lr_g, lr_d, z, eps) -> dict:
        g = state.g
        g.train()
        captions, cap_lens = batch["captions"], batch["cap_lens"]
        labels, bbox = batch["label_onehot"], batch["bbox"]
        class_ids = batch.get("class_ids")
        b, dev = captions.shape[0], captions.device
        n = mesh.global_rows(b)
        if z is None:
            z = mesh.draw(torch.randn, (b, cfg.z_dim), generator, dev)
        if eps is None:
            eps = mesh.draw(torch.randn, (b, cfg.condition_dim), generator,
                            dev)
        with torch.no_grad():
            words, sent = text_encoder(captions, cap_lens)
        mask = captions == 0
        out = remat(g.outputs)(z, sent, words, mask, bbox, labels, eps)

        metrics = {}
        for i, (name, d) in enumerate(state.ds.items()):
            d.train()
            real = as_model_image(batch[f"image{64 * 2 ** i}"])
            err = remat(d_loss_one_scale)(d, real, out.imgs[i], sent, labels,
                                          bbox)
            opt = state.d_opts[name]
            set_lr(opt, lr_d)
            opt.zero_grad(set_to_none=True)
            err.backward()
            mesh.all_reduce_grads(d.parameters())
            opt.step()
            metrics[f"d_loss_{name}"] = err

        total, terms = remat(g_loss)(
            out.imgs, out.mu, out.logvar, words, sent, labels, bbox,
            cap_lens, class_ids, state.ds, b, n)
        params = [p for p in g.parameters() if p.requires_grad]
        grads = torch.autograd.grad(total, params)
        for p, grad in zip(params, grads):
            p.grad = grad
        mesh.all_reduce_grads(params)
        set_lr(state.g_opt, lr_g)
        state.g_opt.step()
        update_ema(state)
        state.step += 1
        metrics.update(terms, g_loss_total=total)
        return mesh.reduce_metrics(
            {k: v.detach() for k, v in metrics.items()})

    return train_step
