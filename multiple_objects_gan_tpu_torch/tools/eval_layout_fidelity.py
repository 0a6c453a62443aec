"""Layout fidelity of a trained stage-1 G with the port (its counterpart
of the JAX package's ``tools/eval_layout_fidelity.py``): per-label recall
of a crop classifier over the STN crops of generated images, and a
localization IoU (``utils/layout_fidelity.py``).

    python -m multiple_objects_gan_tpu_torch.tools.eval_layout_fidelity \\
        --ckpt RUN_DIR_OR_NETG_PTH [--variant mnist|clevr] [--cfg CFG] \\
        [--n 256] [--seed 7] [--batch 64] [--device cuda|cpu]

G comes from a port run directory (its latest checkpoint's G; the
port's stage-1 runs keep no EMA, where the JAX tool prefers one) or a
reference-format ``NET_G`` ``.pth``, as ``cli/sample.py`` restores it. ``n`` fresh layouts are drawn from
``RandomState(seed)`` as the JAX tool draws them (boxes, labels, and the
text embeddings of a CA family); z is ``cli/sample.py:sample_noise``'s
draw from (seed, first item of the batch); the images come through the
stage-1 sample path (``train/step.py:make_sample_fn``). Prints one JSON
line: mnist {"recall", "per_label_recall", "loc_iou", "n_objects"},
clevr {"recall_shape", "recall_color", "recall_both", "loc_iou",
"n_objects"}. Recall near chance (0.1 digits; 1/3 shape, 1/8 colour)
means the labels do not steer identity; loc_iou near 0 that content
ignores the boxes.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from multiple_objects_gan_tpu_torch import resolve_device
from multiple_objects_gan_tpu_torch.cli.sample import (
    load_generator, sample_noise)
from multiple_objects_gan_tpu_torch.config.config import (
    cfg_from_file, stage1_model_config)
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.train.step import make_sample_fn
from multiple_objects_gan_tpu_torch.utils import layout_fidelity as lf

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
VARIANTS = {"mnist": "multi-mnist", "clevr": "clevr"}


def draw_layouts(rs: np.random.RandomState, b: int, mcfg, variant: str):
    """One batch of fresh layouts from ``rs`` (JAX tool, :86-108): boxes
    (b, O, 4); the conditioning one-hots (b, O, label_dim); the labels
    the score reads (ids for mnist, the two-hot rows for clevr); the text
    embeddings (b, text_dim) of a CA family, else None."""
    n_obj = mcfg.num_objects
    bbox = np.stack([rs.uniform(0.05, 0.6, (b, n_obj)),
                     rs.uniform(0.05, 0.6, (b, n_obj)),
                     rs.uniform(0.2, 0.33, (b, n_obj)),
                     rs.uniform(0.2, 0.33, (b, n_obj))], -1).astype(
                         np.float32)
    if variant == "mnist":
        labels = rs.randint(0, 10, (b, n_obj))
        cond = np.eye(10, dtype=np.float32)[labels]
    else:
        # the two-hot dataset encoding: shape [0:3] + colour [4:12]
        cond = np.zeros((b, n_obj, mcfg.label_dim), np.float32)
        ys = rs.randint(0, 3, (b, n_obj))
        yc = rs.randint(0, 8, (b, n_obj))
        for i in range(b):
            for j in range(n_obj):
                cond[i, j, ys[i, j]] = 1.0
                cond[i, j, 4 + yc[i, j]] = 1.0
        labels = cond
    text = (rs.randn(b, mcfg.text_dim).astype(np.float32)
            if mcfg.use_ca else None)
    return bbox, cond, labels, text


def generate(g, mcfg, variant: str, n: int, seed: int, batch: int,
             device) -> tuple:
    """``n`` images (n, H, W, C) float32 numpy in [-1, 1] of ``g`` on
    fresh layouts, with their boxes and labels."""
    sample = make_sample_fn(mcfg)
    rs = np.random.RandomState(seed)
    imgs, boxes, labs = [], [], []
    for start in range(0, n, batch):
        b = min(batch, n - start)
        bbox, cond, labels, text = draw_layouts(rs, b, mcfg, variant)
        z = torch.from_numpy(sample_noise(seed, start, b, mcfg.z_dim))
        out = sample(g, z.to(device), torch.from_numpy(bbox).to(device),
                     torch.from_numpy(cond).to(device),
                     None if text is None
                     else torch.from_numpy(text).to(device))
        imgs.append(out.permute(0, 2, 3, 1).cpu().numpy())
        boxes.append(bbox)
        labs.append(labels)
    return np.concatenate(imgs), np.concatenate(boxes), np.concatenate(labs)


def main(argv=None, details: bool = False):
    """Run the tool; returns the score dict, and with ``details`` also
    {"images", "bbox", "labels", "clf"}, what it was computed from."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True,
                   help="a port run directory (models/ inside) or a "
                        "NET_G .pth")
    p.add_argument("--variant", default="mnist", choices=sorted(VARIANTS))
    p.add_argument("--cfg", default="",
                   help="default: cfg/{mnist,clevr}_train.yml")
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    variant = VARIANTS[args.variant]
    cfg_file = args.cfg or os.path.join(
        ROOT, "cfg", f"{args.variant}_train.yml")
    mcfg = stage1_model_config(cfg_from_file(cfg_file, variant), variant)
    models = os.path.join(args.ckpt, "models")
    if not (os.path.isfile(args.ckpt) or (
            os.path.isdir(models)
            and CheckpointManager(models).latest_epoch() is not None)):
        raise SystemExit(f"no checkpoint under {args.ckpt}")
    g = load_generator(mcfg, args.ckpt, args.seed, device)
    if args.variant == "mnist":
        clf = lf.train_digit_classifier(seed=args.seed, device=device)
        score = lf.layout_fidelity
    else:
        clf = lf.train_clevr_classifier(seed=args.seed, device=device)
        score = lf.clevr_layout_fidelity
    imgs, bbox, labels = generate(g, mcfg, args.variant, args.n, args.seed,
                                  args.batch, device)
    out = score(imgs, bbox, labels, clf)
    print(json.dumps(out), flush=True)
    if details:
        return out, {"images": imgs, "bbox": bbox, "labels": labels,
                     "clf": clf}
    return out


if __name__ == "__main__":
    main()
