"""The epoch loop of Stage-1 training (port of the JAX
``train/loop.py:run_epochs``, without snapshots, image grids, checkpoints
or the 500-step log).

It keeps the reference's learning-rate rule (code/multi-mnist/
trainer.py:105-111): both rates are halved every ``lr_decay_epochs``
epochs, computed from the epoch index. Each epoch visits the set in an
order shuffled from ``seed + epoch`` in batches of ``batch_size``, the
last partial batch dropped, as the JAX ``Loader`` does. The whole set
lives on the device, so a step moves no data from the host. One line per
epoch gives the mean of each loss over its steps (``kl_loss`` among them
under the CA net).

A set with caption embeddings (``text_embedding`` (n, captions, dim), the
COCO set) gives each item one of its captions each epoch, drawn from a
numpy RandomState seeded with ``seed`` and carried across epochs, as the
JAX COCO reader draws one per item visit (``data/coco.py:102-103``).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from multiple_objects_gan_tpu_torch.train.state import GANTrainState


def run_epochs(state: GANTrainState, data: dict, step_fn: Callable,
               generator: torch.Generator, *, batch_size: int, lr_g: float,
               lr_d: float, n_epochs: int, lr_decay_epochs: int = 0,
               seed: int = 0) -> list[dict]:
    """Train ``n_epochs`` epochs over ``data`` (arrays or tensors keyed
    ``image``, ``bbox``, ``label_onehot`` and, for the CA family,
    ``text_embedding`` with a caption axis). Returns one dict of mean
    losses (floats) per epoch, with its step count and wall time."""
    device = next(state.g.parameters()).device
    tensors = {k: torch.as_tensor(v).to(device) for k, v in data.items()}
    captions = tensors.pop("text_embedding", None)
    caption_rng = np.random.RandomState(seed)
    n = tensors["image"].shape[0]
    n_batches = n // batch_size
    if n_batches == 0:
        raise ValueError(f"{n} items make no batch of {batch_size}: no "
                         "training would run")
    history = []
    for epoch in range(n_epochs):
        t0 = time.perf_counter()
        f = 0.5 ** (epoch // lr_decay_epochs) if lr_decay_epochs else 1.0
        order = np.arange(n)
        np.random.RandomState(seed + epoch).shuffle(order)
        order = torch.from_numpy(order).to(device)
        if captions is not None:
            pick = caption_rng.randint(captions.shape[1], size=n)
            tensors["text_embedding"] = captions[
                torch.arange(n, device=device),
                torch.from_numpy(pick).to(device)]
        sums: dict = {}
        for i in range(n_batches):
            idx = order[i * batch_size:(i + 1) * batch_size]
            batch = {k: v.index_select(0, idx) for k, v in tensors.items()}
            metrics = step_fn(state, batch, generator, lr_g * f, lr_d * f)
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
        means = {k: float(v) / n_batches for k, v in sums.items()}
        means["steps"] = n_batches
        means["seconds"] = time.perf_counter() - t0
        history.append(means)
        print(f"[{epoch}/{n_epochs}] "
              + " ".join(f"{k}={means[k]:.4f}" for k in sorted(sums))
              + f" lr_g={lr_g * f:g} lr_d={lr_d * f:g} steps={n_batches}"
              f" time={means['seconds']:.1f}s", flush=True)
    return history
