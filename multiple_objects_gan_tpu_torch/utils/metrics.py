"""FID and Inception Score (the port's copy of the JAX package's
``utils/metrics.py``).

The features are Inception-v3's 2048 pooled ones: the canonical
pytorch-fid network (``nn/fid_inception.py``) when
``$FID_INCEPTION_WEIGHTS`` names its weights, else the DAMSM image
encoder's backbone (``nn/encoders.py:CNNEncoder``, ``return_pool``). They
are computed on the encoder's device in batches of 32 under
:func:`~multiple_objects_gan_tpu_torch.float32_pinned`; the statistics,
the matrix square root and the score are host numpy and scipy, as in the
JAX package. Each result carries its provenance, so that a placeholder
metric is never read as a published one.
"""

from __future__ import annotations

import inspect
import os

import numpy as np
import torch

from multiple_objects_gan_tpu_torch import float32_pinned
from multiple_objects_gan_tpu_torch.io.pycompat import torch_load
from multiple_objects_gan_tpu_torch.nn.fid_inception import (
    create_fid_encoder)

BATCH = 32                  # the forward's batch (JAX inception_activations)


def _device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def inception_activations(image_encoder, images, batch_size: int = BATCH
                          ) -> np.ndarray:
    """images (N, H, W, 3) in [-1, 1] (numpy, or a tensor on any device)
    -> (N, 2048) float32 numpy pooled features of ``image_encoder`` (a
    CNNEncoder or FIDInceptionV3, on its own device), in batches of
    ``batch_size``, the remainder padded with zeros and sliced off, as
    the JAX function batches them."""
    dev = _device(image_encoder)
    images = torch.as_tensor(images)
    n = images.shape[0]
    out = []
    with torch.no_grad(), float32_pinned():
        for i in range(0, n, batch_size):
            x = images[i:i + batch_size].to(dev, torch.float32)
            take = x.shape[0]
            if take < batch_size:
                x = torch.cat([x, x.new_zeros((batch_size - take,)
                                              + tuple(x.shape[1:]))])
            _, _, pool = image_encoder(x.permute(0, 3, 1, 2),
                                       return_pool=True)
            out.append(pool[:take].float().cpu().numpy())
    return np.concatenate(out, axis=0)


def _sqrtm_quiet(a: np.ndarray) -> np.ndarray:
    """scipy's matrix square root: up to scipy 1.17 ``sqrtm(a,
    disp=False)``, the JAX package's call (the root and an error
    estimate, nothing printed); scipy 1.18 removed ``disp`` and returns
    the root alone."""
    from scipy import linalg

    if "disp" in inspect.signature(linalg.sqrtm).parameters:
        return linalg.sqrtm(a, disp=False)[0]
    return linalg.sqrtm(a)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two Gaussians (Heusel et al.), with the eps offset
    when the square root is not finite."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = _sqrtm_quiet(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid_from_activations(act1: np.ndarray, act2: np.ndarray) -> float:
    mu1, mu2 = act1.mean(0), act2.mean(0)
    s1 = np.cov(act1, rowvar=False)
    s2 = np.cov(act2, rowvar=False)
    return frechet_distance(mu1, s1, mu2, s2)


def compute_fid(image_encoder, real_images, fake_images,
                batch_size: int = BATCH) -> float:
    return fid_from_activations(
        inception_activations(image_encoder, real_images, batch_size),
        inception_activations(image_encoder, fake_images, batch_size))


def resolve_fid_encoder(image_encoder=None, provenance: str = "random",
                        device=None):
    """The FID encoder and its provenance (JAX ``resolve_fid_encoder``):
    ``(FIDInceptionV3, "fid_canonical")`` when ``$FID_INCEPTION_WEIGHTS``
    names an existing file (on ``device``, else ``image_encoder``'s
    device); otherwise ``(image_encoder, provenance)``, the caller's
    DAMSM backbone (``"damsm"``) or a random one (``"random"``), after a
    WARNING when the variable names a path that does not exist."""
    path = os.environ.get("FID_INCEPTION_WEIGHTS", "")
    if path and os.path.exists(path):
        if device is None:
            device = (_device(image_encoder) if image_encoder is not None
                      else "cuda")
        return create_fid_encoder(path, device), "fid_canonical"
    if path:
        print(f"WARNING: $FID_INCEPTION_WEIGHTS={path!r} does not exist — "
              "falling back to the non-canonical FID encoder", flush=True)
    return image_encoder, provenance


def load_inception_fc(path: str):
    """The 1000-class head (W (2048, 1000), b (1000,)) float32 of a
    torchvision inception_v3 state dict (``.pth``, its ``fc.weight`` and
    ``fc.bias``) or an ``.npz`` with ``weight`` (1000, 2048) and
    ``bias``."""
    if path.endswith(".npz"):
        z = np.load(path)
        return np.asarray(z["weight"], np.float32).T, np.asarray(
            z["bias"], np.float32)
    sd = torch_load(path)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return (np.asarray(sd["fc.weight"], np.float32).T,
            np.asarray(sd["fc.bias"], np.float32))


def resolve_inception_fc(fc=None):
    """The IS head and its provenance (JAX ``resolve_inception_fc``):
    ``fc`` or ``$INCEPTION_V3_WEIGHTS``'s head, ``"imported"``; else, after
    a WARNING, JAX's deterministic placeholder ``RandomState(0).randn(2048,
    1000) * 0.05`` with zero bias, ``"random"``."""
    if fc is not None:
        return fc, "imported"
    env = os.environ.get("INCEPTION_V3_WEIGHTS", "")
    if env and os.path.exists(env):
        return load_inception_fc(env), "imported"
    print("WARNING: no Inception classifier head "
          "($INCEPTION_V3_WEIGHTS unset) — IS uses a random head; "
          "value is not comparable to published numbers", flush=True)
    rng = np.random.RandomState(0)
    return (rng.randn(2048, 1000).astype(np.float32) * 0.05,
            np.zeros(1000, np.float32)), "random"


def inception_score(image_encoder=None, images=None,
                    batch_size: int = BATCH, splits: int = 10, fc=None,
                    acts: np.ndarray = None) -> tuple[float, float]:
    """IS = exp(E_x KL(p(y|x) || p(y))) (Salimans et al.) of the head
    ``fc`` (:func:`resolve_inception_fc`) over the pooled features
    ``acts``, or those of ``images`` through ``image_encoder``: mean and
    std over ``splits`` splits, 1e-12 inside the logs."""
    if acts is None:
        acts = inception_activations(image_encoder, images, batch_size)
    fc, _ = resolve_inception_fc(fc)
    w, b = fc
    logits = acts @ w + b
    logits -= logits.max(axis=1, keepdims=True)
    probs = np.exp(logits)
    probs /= probs.sum(axis=1, keepdims=True)
    n = probs.shape[0]
    scores = []
    for k in range(splits):
        part = probs[k * n // splits:(k + 1) * n // splits]
        if part.shape[0] == 0:
            continue
        marginal = part.mean(axis=0, keepdims=True)
        kl = (part * (np.log(part + 1e-12)
                      - np.log(marginal + 1e-12))).sum(axis=1)
        scores.append(float(np.exp(kl.mean())))
    return float(np.mean(scores)), float(np.std(scores))
