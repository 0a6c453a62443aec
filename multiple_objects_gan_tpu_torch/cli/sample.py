"""Sampling grids of the stage-1 Multi-MNIST and CLEVR generators (the
port's copy of the JAX package's ``cli/sample.py:sample_stage1``).

Parity target: GANTrainer.sample (code/multi-mnist/trainer.py:208-342,
code/clevr/trainer.py:203-301): load G, pick random test layouts, render 9
variations of each beside the real image, outline the boxes in white, add
a row of caption text and save 20-tile grids. Multi-MNIST's layout surgery
(num_digits_per_img, change_bbox_size) is kept as ``--num_objects`` and
``--bbox_scale``. The text row is drawn with the port's own bitmap font
(``utils/images.py:draw_text``), not PIL's default font, so only its text
pixels differ from the JAX grids.
"""

from __future__ import annotations

import os
import numpy as np
import torch

from multiple_objects_gan_tpu_torch.data.datasets import (
    MNIST_VARIANT, ClevrDataset, MultiMnistDataset)
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.io.pycompat import load_pickle
from multiple_objects_gan_tpu_torch.io.weights import load_reference_g
from multiple_objects_gan_tpu_torch.models.common import Stage1Config
from multiple_objects_gan_tpu_torch.models.stage1 import build_stage1_g
from multiple_objects_gan_tpu_torch.train.step import make_sample_fn
from multiple_objects_gan_tpu_torch.utils.images import (
    draw_text, save_grid)

CLEVR_SHAPE_NAMES = {0: "cube", 1: "cylinder", 2: "sphere"}
CLEVR_COLOR_NAMES = {0: "gray", 1: "red", 2: "blue", 3: "green", 4: "brown",
                     5: "purple", 6: "cyan", 7: "yellow"}
N_VARIATIONS = 9
TEXT_XY = (10, 10)       # where the caption strip's text starts


def load_validation_layouts(datapath: str):
    """(labels, bboxes) float32 of a split's pickles
    (code/multi-mnist/miscc/utils.py:59-68), py2 pickles included."""
    bboxes = np.array(
        load_pickle(os.path.join(datapath, MNIST_VARIANT, "bboxes.pickle")),
        np.float32)
    labels = np.array(
        load_pickle(os.path.join(datapath, MNIST_VARIANT, "labels.pickle")),
        np.float32)
    return labels, bboxes


def load_generator(mcfg: Stage1Config, net_g: str, seed: int, device):
    """The generator of ``net_g``: a reference-format ``.pth``, or an
    output directory of the port's training (its latest checkpoint);
    otherwise the seeded random init, with a warning, as the JAX sampler
    does."""
    if net_g and os.path.isdir(net_g):
        mgr = CheckpointManager(os.path.join(net_g, "models"))
        if mgr.latest_epoch() is not None:
            ckpt, epoch = mgr.load()
            print(f"restored G from {net_g} (epoch {epoch})", flush=True)
            return build_stage1_g(mcfg, ckpt["g"], device=device)
        print(f"WARNING: NET_G dir {net_g!r} holds no checkpoint; sampling "
              "from randomly initialized weights", flush=True)
    elif net_g and os.path.isfile(net_g):
        print(f"Load from: {net_g}", flush=True)
        return build_stage1_g(mcfg, load_reference_g(net_g), device=device)
    else:
        print(f"WARNING: NET_G={net_g!r} not found; sampling from randomly "
              "initialized weights", flush=True)
    return build_stage1_g(mcfg, seed=seed, device=device)


def sample_noise(seed: int, s: int, n: int, z_dim: int) -> np.ndarray:
    """Grid ``s``'s z (n, z_dim) float32: its own draw from (seed, s), as
    the JAX sampler folds ``s`` into its key."""
    return np.random.RandomState([seed, s]).standard_normal(
        (n, z_dim)).astype(np.float32)


def sample_stage1(args, cfg, mcfg: Stage1Config, output_dir: str,
                  variant: str, seed: int, num_samples: int = 25, g=None,
                  device="cuda") -> str:
    """Write ``num_samples`` 20-tile grids to ``<output_dir>/samples``:
    row 1 the real test image and 9 fakes of its layout, row 2 the caption
    text. ``args.num_objects`` and ``args.bbox_scale``, when set, reshape
    each layout. ``g`` defaults to :func:`load_generator` of cfg
    ``NET_G``. Returns the directory written to."""
    num_objects = getattr(args, "num_objects", None)
    bbox_scale = getattr(args, "bbox_scale", None)
    device = torch.device(device)
    if g is None:
        g = load_generator(mcfg, cfg.get("NET_G", ""), seed, device)
    sample = make_sample_fn(mcfg)
    if variant == "clevr":
        ds = ClevrDataset(cfg.DATA_DIR, split="test", imsize=int(cfg.IMSIZE),
                          hflip=False, seed=seed)
    else:
        ds = MultiMnistDataset(cfg.DATA_DIR, split="test",
                               imsize=int(cfg.IMSIZE))
    rnd = np.random.RandomState(seed)
    out_dir = os.path.join(output_dir, "samples")
    os.makedirs(out_dir, exist_ok=True)

    for s in range(num_samples):
        item = ds[rnd.randint(len(ds))]
        lab = item["label_onehot"].copy()
        bb = item["bbox"].copy()
        if num_objects is not None:
            lab, bb = _layout_surgery(lab, bb, num_objects, rnd,
                                      mcfg.label_dim)
        if bbox_scale is not None:
            bb[:, 2:] = np.clip(bb[:, 2:] * bbox_scale, 0.05, 1.0)
        n = N_VARIATIONS
        z = torch.tensor(sample_noise(seed, s, n, mcfg.z_dim), device=device)
        fakes = sample(
            g, z, torch.from_numpy(np.tile(bb[None], (n, 1, 1))).to(device),
            torch.from_numpy(np.tile(lab[None], (n, 1, 1))).to(device))
        fakes = fakes.permute(0, 2, 3, 1).cpu().numpy()
        imsize = fakes.shape[1]
        real = item["image"].astype(np.float32) / 127.5 - 1.0
        tiles = np.concatenate([real[None], fakes], axis=0)  # (10, H, W, C)
        if tiles.shape[-1] == 1:
            tiles = np.repeat(tiles, 3, axis=-1)
        _draw_white_bbox_edges(tiles, bb, imsize)
        text = _text_tiles(_caption_lines(lab, variant), imsize)
        save_grid(np.concatenate([tiles, text], axis=0),
                  os.path.join(out_dir, f"sample_{s:03d}.png"), nrow=10)
    print(f"wrote {num_samples} sample grids to {out_dir}", flush=True)
    return out_dir


def _draw_white_bbox_edges(tiles: np.ndarray, bb: np.ndarray,
                           imsize: int) -> None:
    """White 1-pixel box edges on every tile, in place (trainer.py:313-327;
    1.0 is white in [-1, 1]). A padded box (-1) is skipped."""
    for bbv in np.asarray(bb).reshape(-1, 4):
        x, y = int(imsize * bbv[0]), int(imsize * bbv[1])
        w = min(int(imsize * bbv[2]), imsize - 1)
        h = min(int(imsize * bbv[3]), imsize - 1)
        while x + w >= imsize:
            x -= 1
            w -= 1
        while y + h >= imsize:
            y -= 1
            h -= 1
        if x <= -1:
            continue
        tiles[:, y, x:x + w] = 1.0
        tiles[:, y:y + h, x] = 1.0
        tiles[:, y + h, x:x + w] = 1.0
        tiles[:, y:y + h, x + w] = 1.0


def _text_tiles(lines, imsize: int) -> np.ndarray:
    """(10, imsize, imsize, 3) caption row in [-1, 1]: one white strip with
    the labels, cut into 10 tiles (trainer.py:330-340)."""
    strip = np.full((imsize, imsize * 10, 3), 255, np.uint8)
    draw_text(strip, TEXT_XY, ", ".join(lines))
    arr = strip.astype(np.float32) / 127.5 - 1.0
    return np.stack([arr[:, i * imsize:(i + 1) * imsize] for i in range(10)])


def _layout_surgery(lab, bb, n_objects, rnd, label_dim):
    """Fewer or more objects than trained with (trainer.py:219-243), on the
    real objects only (CLEVR's padded rows are dropped first)."""
    valid = bb[:, 0] >= 0
    lab, bb = lab[valid], bb[valid]
    cur = lab.shape[0]
    if n_objects <= cur:
        return lab[:n_objects], bb[:n_objects]
    extra = n_objects - cur
    new_lab = np.zeros((extra, label_dim), np.float32)
    new_lab[np.arange(extra), rnd.randint(0, label_dim, extra)] = 1.0
    new_bb = np.stack([
        rnd.uniform(0.0, 0.7, extra), rnd.uniform(0.0, 0.7, extra),
        rnd.uniform(0.15, 0.3, extra), rnd.uniform(0.15, 0.3, extra)],
        axis=-1).astype(np.float32)
    return np.concatenate([lab, new_lab]), np.concatenate([bb, new_bb])


def _caption_lines(lab, variant):
    """The caption of a layout: the digits, or CLEVR's "colour shape" of
    each real object (a pad one-hots shape slot 3)."""
    if variant == "multi-mnist":
        return [str(int(np.argmax(row))) for row in lab if row.max() > 0]
    if variant == "clevr":
        lines = []
        for row in lab:
            if row.max() <= 0 or int(np.argmax(row[:4])) == 3:
                continue
            lines.append(
                f"{CLEVR_COLOR_NAMES.get(int(np.argmax(row[4:])), '?')} "
                f"{CLEVR_SHAPE_NAMES.get(int(np.argmax(row[:4])), '?')}")
        return lines
    return [f"label {int(np.argmax(row))}" for row in lab if row.max() > 0]
