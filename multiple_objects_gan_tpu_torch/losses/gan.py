"""Adversarial losses (matching-aware conditional BCE) and the CA-net KL
(port of the JAX ``losses/gan.py``).

Reference: compute_discriminator_loss / compute_generator_loss,
code/multi-mnist/miscc/utils.py:71-123, and KL_loss,
code/coco/stackgan/miscc/utils.py:68-71. They are functions of logits: the
D forwards, and the wrong pairs (real features [:-1] against conditions
[1:]), are the train step's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def _whole(loss: torch.Tensor) -> torch.Tensor:
    return loss


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean binary cross-entropy of ``logits`` against a constant target
    (torch ``BCEWithLogitsLoss``), in float32."""
    logits = logits.float()
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, target))


def discriminator_loss(real_logits: torch.Tensor, wrong_logits: torch.Tensor,
                       fake_logits: torch.Tensor,
                       uncond_real_logits: Optional[torch.Tensor] = None,
                       uncond_fake_logits: Optional[torch.Tensor] = None,
                       share: Callable = _whole, wrong_share: Callable = _whole):
    """Matching-aware D loss: real + (fake + wrong) / 2, or with the
    unconditional head (real + u_real) / 2 + (fake + wrong + u_fake) / 3.
    ``share`` and ``wrong_share`` turn a term's mean into a rank's share of
    the global mean (``parallel/mesh.py:share``): the wrong pair's, over
    B - 1 rows, and every other term's. Returns (errD, dict of its parts).
    """
    err_real = share(bce_with_logits(real_logits, 1.0))
    err_wrong = wrong_share(bce_with_logits(wrong_logits, 0.0))
    err_fake = share(bce_with_logits(fake_logits, 0.0))
    if uncond_real_logits is not None:
        u_real = share(bce_with_logits(uncond_real_logits, 1.0))
        u_fake = share(bce_with_logits(uncond_fake_logits, 0.0))
        err_d = (err_real + u_real) / 2.0 + (err_fake + err_wrong + u_fake) / 3.0
        parts = {"d_loss_real": (err_real + u_real) / 2.0,
                 "d_loss_wrong": err_wrong,
                 "d_loss_fake": (err_fake + u_fake) / 2.0}
    else:
        err_d = err_real + (err_fake + err_wrong) * 0.5
        parts = {"d_loss_real": err_real, "d_loss_wrong": err_wrong,
                 "d_loss_fake": err_fake}
    return err_d, parts


def generator_adv_loss(fake_logits: torch.Tensor,
                       uncond_fake_logits: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """G adversarial loss: fake + condition -> 1 (+ the unconditional
    term)."""
    err = bce_with_logits(fake_logits, 1.0)
    if uncond_fake_logits is not None:
        err = err + bce_with_logits(uncond_fake_logits, 1.0)
    return err


def kl_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL divergence of the CA-net's N(mu, exp(logvar)) to N(0, I):
    -0.5 * mean(1 + logvar - mu^2 - exp(logvar))."""
    mu, logvar = mu.float(), logvar.float()
    return -0.5 * torch.mean(1.0 + logvar - mu.square() - logvar.exp())
