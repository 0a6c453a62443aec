"""The DAMSM pretraining step and its eval-split loss (port of the JAX
``train/damsm_step.py``).

Upstream AttnGAN's pretrain_DAMSM.py trains the text encoder and the
image encoder's two projection heads with the same word and sentence
losses the AttnGAN generator later consumes (``losses/damsm.py``):

* one Adam(betas=(0.5, 0.999)) over the whole text encoder and the image
  encoder's ``emb_features`` and ``emb_cnn_code`` (``train/state.py:
  DamsmTrainState``); the Inception-v3 backbone is frozen;
* loss = w_loss0 + w_loss1 + s_loss0 + s_loss1, with GAMMA1-3 from the
  cfg's TRAIN.SMOOTH;
* the text encoder's gradients alone are clipped to a global norm of
  TRAIN.RNN_GRAD_CLIP before the Adam step, as JAX computes it
  (``damsm_step.py:127-131``): scale = min(1, clip / max(norm, 1e-12)),
  the norm over those gradients only. ``torch.nn.utils.clip_grad_norm_``
  scales by clip / (norm + 1e-6), another number, so it is not used. The
  metrics report the norm before the clip as ``rnn_grad_norm``.

Under a process group of more than one rank each rank holds its slice of
the global batch: the losses are the global batch's (``losses/damsm.py``),
each rank's its share, the gradients are summed over the ranks before the
clip, so the clip's norm is that of the global gradient, the dropout mask
is drawn for the global batch and sliced, and the metrics are summed over
the ranks (``rnn_grad_norm``, the same on every rank, is not).

The backbone runs in ``eval()`` mode, on its running statistics, as the
JAX package runs it (``damsm_step.py:22-25``: a frozen feature extractor
whose batch statistics would only make its features drift between train
and eval); upstream pretrain_DAMSM.py puts the image encoder in
``train()`` mode instead. Its parameters take no gradient and its input
none, so autograd records nothing before the two heads. The text encoder
is in ``train()`` mode during the step: its embedding dropout acts, and
cuDNN's LSTM backward runs only in training mode. The input image is the
batch's largest ``image<size>``. Under a bf16 compute dtype the backbone's
convolutions compute in bf16; the heads, the text encoder, the losses,
the gradients and the Adam state stay float32.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from multiple_objects_gan_tpu_torch.losses.damsm import sent_loss, words_loss
from multiple_objects_gan_tpu_torch.nn.encoders import DROP_PROB
from multiple_objects_gan_tpu_torch.parallel import mesh
from multiple_objects_gan_tpu_torch.parallel.multihost import world_size
from multiple_objects_gan_tpu_torch.train.state import (
    DamsmTrainState, set_lr)
from multiple_objects_gan_tpu_torch.utils.images import as_model_image

SMOOTH = {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0}
NORM_FLOOR = 1e-12          # the clip's floor under the norm (JAX :129)


def top_image(batch: dict) -> torch.Tensor:
    """The batch's largest ``image<size>`` as the model's (B, 3, H, W)."""
    key = max((k for k in batch if k.startswith("image")),
              key=lambda k: int(k[5:]))
    return as_model_image(batch[key])


def damsm_losses(state: DamsmTrainState, batch: dict, sm: dict,
                 keep: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> dict:
    """The words and sentence losses of ``batch`` through both encoders in
    their current modes: ``w_loss``, ``s_loss`` and ``damsm_loss``. The
    image encoder runs first, as in the JAX step; the other order was no
    faster on the card (``tools/damsm_order.py``)."""
    captions, cap_lens = batch["captions"], batch["cap_lens"]
    region, code = state.image(top_image(batch))
    words, sent = state.text(captions, cap_lens, keep=keep,
                             generator=generator)
    class_ids = batch.get("class_ids")
    w0, w1, _ = words_loss(region, words, cap_lens, class_ids, sm["GAMMA1"],
                           sm["GAMMA2"], sm["GAMMA3"])
    s0, s1 = sent_loss(code, sent, class_ids, sm["GAMMA3"])
    return {"w_loss": w0 + w1, "s_loss": s0 + s1,
            "damsm_loss": w0 + w1 + s0 + s1}


def make_damsm_train_step(smooth: Optional[dict] = None,
                          grad_clip: float = 0.25) -> Callable:
    """``train_step(state, batch, generator, lr, lr_d=None, keep=None) ->
    metrics``.

    ``batch`` holds ``image<size>`` (B, H, W, 3) uint8 or float in [-1,
    1], ``captions`` (B, T) zero-padded, ``cap_lens`` (B,) and optionally
    ``class_ids`` (B,), on the encoders' device. The dropout mask is
    ``keep`` (B, T, ninput) when given, else drawn from ``generator``.
    ``lr_d`` is ignored: it is there so that the step fits
    ``train/loop.py:run_epochs``. The step updates ``state`` in place and
    returns ``w_loss``, ``s_loss``, ``damsm_loss`` and ``rnn_grad_norm``
    as 0-d float32 tensors on the device."""
    sm = dict(SMOOTH, **{k: float(v) for k, v in (smooth or {}).items()})

    def train_step(state: DamsmTrainState, batch: dict,
                   generator: Optional[torch.Generator], lr: float,
                   lr_d: Optional[float] = None,
                   keep: Optional[torch.Tensor] = None) -> dict:
        state.text.train()
        state.image.eval()
        if keep is None and world_size() > 1:
            captions = batch["captions"]
            keep = mesh.draw(
                torch.rand, tuple(captions.shape)
                + (state.text.encoder.embedding_dim,), generator,
                captions.device) < 1.0 - DROP_PROB
        metrics = damsm_losses(state, batch, sm, keep, generator)
        state.opt.zero_grad(set_to_none=True)
        metrics["damsm_loss"].backward()
        mesh.all_reduce_grads(p for group in state.opt.param_groups
                              for p in group["params"])
        grads = [p.grad for p in state.text.parameters()]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.clamp(grad_clip / torch.clamp(norm, min=NORM_FLOOR),
                            max=1.0)
        for g in grads:
            g.mul_(scale)
        set_lr(state.opt, lr)
        state.opt.step()
        state.step += 1
        metrics["rnn_grad_norm"] = norm
        return mesh.reduce_metrics({k: v.detach() for k, v in metrics.items()},
                                   replicated=("rnn_grad_norm",))

    return train_step


def make_damsm_eval_fn(smooth: Optional[dict] = None) -> Callable:
    """``eval_fn(state, batch) -> {w_loss, s_loss, damsm_loss}``, 0-d
    float32 tensors: the same losses with both encoders in ``eval()`` mode
    (no dropout) and no gradient (upstream pretrain_DAMSM.py evaluate();
    JAX ``make_damsm_eval_fn``). The text encoder is left in ``eval()``
    mode; the train step puts it back in ``train()``."""
    sm = dict(SMOOTH, **{k: float(v) for k, v in (smooth or {}).items()})

    def eval_fn(state: DamsmTrainState, batch: dict) -> dict:
        state.text.eval()
        state.image.eval()
        with torch.no_grad():
            return mesh.reduce_metrics(
                {k: v.float()
                 for k, v in damsm_losses(state, batch, sm).items()})

    return eval_fn
