"""Train Stage 1 with the PyTorch port (the port's counterpart of the JAX
package's ``cli/main.py``, Multi-MNIST only).

    python -m multiple_objects_gan_tpu_torch.cli.main --variant multi-mnist \\
        --cfg cfg/mnist_train.yml --synthetic [--max_epochs N] \\
        [--manualSeed N] [--device cuda|cpu] [--bf16] [--bn_groups G]

``--synthetic`` trains on the 512-item synthetic Multi-MNIST set the JAX
CLI writes (``cli/main.py:277``), built in memory from the seed; with
``cfg/mnist_train.yml`` (batch 128) that is 4 steps an epoch at full width.
The port has no on-disk dataset reader yet. The run is on the card unless
``--device cpu`` is given; without a card it raises. It prints one line per
epoch with the mean losses. ``--bf16`` and ``--bn_groups`` are the JAX
CLI's flags (its ``cli/main.py:55-64``), carried into the model config.
The JAX CLI's ``run_flags.json`` record and its resume check wait for the
port's checkpoints and output directory.
"""

from __future__ import annotations

import argparse
import random
import sys

import numpy as np
import torch

from multiple_objects_gan_tpu_torch import resolve_device
from multiple_objects_gan_tpu_torch.config.config import (
    cfg_from_file, stage1_model_config)
from multiple_objects_gan_tpu_torch.data.synthetic import synthetic_multimnist
from multiple_objects_gan_tpu_torch.train.loop import run_epochs
from multiple_objects_gan_tpu_torch.train.state import create_state
from multiple_objects_gan_tpu_torch.train.step import make_train_step

SYNTHETIC_ITEMS = 512   # the JAX CLI's synthetic train split (cli/main.py:277)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variant", required=True, choices=["multi-mnist"])
    p.add_argument("--cfg", dest="cfg_file", required=True)
    p.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic Multi-MNIST set, in memory")
    p.add_argument("--max_epochs", type=int, default=None,
                   help="stop after this many epochs (default TRAIN.MAX_EPOCH)")
    p.add_argument("--manualSeed", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 activations: convs and linears compute in "
                        "bf16; weights, Adam state and BatchNorm running "
                        "statistics stay float32")
    p.add_argument("--bn_groups", type=int, default=1,
                   help="train-mode BatchNorm statistic groups: 1 = the "
                        "whole batch (default), G > 1 = per-replica "
                        "DataParallel statistics over G contiguous batch "
                        "chunks, as a G-GPU reference run computes them")
    return p.parse_args(argv)


def main(argv=None) -> list[dict]:
    """Run the training the arguments ask for; returns the per-epoch mean
    losses of :func:`~multiple_objects_gan_tpu_torch.train.loop.run_epochs`."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = cfg_from_file(args.cfg_file, args.variant)
    if not cfg.TRAIN.FLAG:
        raise SystemExit("TRAIN.FLAG is False: sampling is not ported yet")
    if not args.synthetic:
        raise SystemExit("the port has no on-disk Multi-MNIST reader yet; "
                         "pass --synthetic")
    seed = args.manualSeed
    if seed is None:
        seed = random.randint(1, 10000)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    mcfg = stage1_model_config(
        cfg, args.variant,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        bn_groups=args.bn_groups)
    train = cfg.TRAIN
    n_epochs = train.MAX_EPOCH if args.max_epochs is None else args.max_epochs
    state = create_state(mcfg, seed=seed, device=device)
    data = synthetic_multimnist(SYNTHETIC_ITEMS, seed=seed, imsize=cfg.IMSIZE)
    generator = torch.Generator(device=device).manual_seed(seed)
    print(f"multi-mnist stage 1 on {device}: ngf {mcfg.ngf}, ndf "
          f"{mcfg.df_dim}, batch {train.BATCH_SIZE}, {SYNTHETIC_ITEMS} synthetic "
          f"items, {n_epochs} epochs, seed {seed}, "
          f"{'bf16' if args.bf16 else 'float32'}, BatchNorm groups "
          f"{mcfg.bn_groups}", flush=True)
    return run_epochs(state, data, make_train_step(mcfg), generator,
                      batch_size=train.BATCH_SIZE, lr_g=train.GENERATOR_LR,
                      lr_d=train.DISCRIMINATOR_LR, n_epochs=n_epochs,
                      lr_decay_epochs=train.LR_DECAY_EPOCH, seed=seed)


if __name__ == "__main__":
    main(sys.argv[1:])
