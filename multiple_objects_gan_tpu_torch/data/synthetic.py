"""Synthetic data for the port (copies of the JAX package's generators).

* :func:`synthetic_batch` is ``data/synthetic.py:synthetic_batch``: one
  batch of any stage-1 variant, the batch ``bench.py`` times.
* :func:`synthetic_multimnist` is the numpy part of
  ``data/datasets.py:write_synthetic_multimnist``: the same uint8 images,
  boxes and one-hot labels from the same seed, held in memory. Nothing is
  written to disk, and no imaging library is needed.
"""

from __future__ import annotations

import numpy as np

from multiple_objects_gan_tpu_torch.models.common import Stage1Config


def synthetic_batch(cfg: Stage1Config, batch_size: int, seed: int = 0,
                    imsize: int = 64) -> dict:
    """One batch: float images (B, H, W, C) in [-1, 1] with blobs inside
    the boxes, boxes (B, O, 4), one-hot labels (B, O, L)."""
    rng = np.random.RandomState(seed)
    b, o = batch_size, cfg.num_objects

    x = rng.uniform(0.05, 0.55, size=(b, o)).astype(np.float32)
    y = rng.uniform(0.05, 0.55, size=(b, o)).astype(np.float32)
    w = rng.uniform(0.2, 0.4, size=(b, o)).astype(np.float32)
    h = rng.uniform(0.2, 0.4, size=(b, o)).astype(np.float32)
    bbox = np.stack([x, y, w, h], axis=-1)

    cls = rng.randint(0, cfg.label_dim, size=(b, o))
    onehot = np.zeros((b, o, cfg.label_dim), np.float32)
    onehot[np.arange(b)[:, None], np.arange(o)[None, :], cls] = 1.0

    img = np.full((b, imsize, imsize, cfg.img_channels), -1.0, np.float32)
    yy = np.linspace(0, 1, imsize, dtype=np.float32)
    for i in range(b):
        for j in range(o):
            mx = (yy[None, :] > x[i, j]) & (yy[None, :] < x[i, j] + w[i, j])
            my = (yy[:, None] > y[i, j]) & (yy[:, None] < y[i, j] + h[i, j])
            img[i, my & mx, :] = 1.0

    batch = {"image": img, "bbox": bbox, "label_onehot": onehot}
    if cfg.use_ca:
        batch["text_embedding"] = rng.randn(b, cfg.text_dim).astype(np.float32)
    return batch


# 3x5 bitmap glyphs, one per digit class (datasets.py:_DIGIT_GLYPHS)
_DIGIT_GLYPHS = np.array([
    [0b111, 0b101, 0b101, 0b101, 0b111],   # 0
    [0b010, 0b110, 0b010, 0b010, 0b111],   # 1
    [0b111, 0b001, 0b111, 0b100, 0b111],   # 2
    [0b111, 0b001, 0b111, 0b001, 0b111],   # 3
    [0b101, 0b101, 0b111, 0b001, 0b001],   # 4
    [0b111, 0b100, 0b111, 0b001, 0b111],   # 5
    [0b111, 0b100, 0b111, 0b101, 0b111],   # 6
    [0b111, 0b001, 0b010, 0b010, 0b010],   # 7
    [0b111, 0b101, 0b111, 0b101, 0b111],   # 8
    [0b111, 0b101, 0b111, 0b001, 0b111],   # 9
], np.uint8)


def _digit_patch(d: int, h: int, w: int) -> np.ndarray:
    """Nearest-neighbour scale of digit ``d``'s 3x5 glyph to (h, w) uint8."""
    rows = _DIGIT_GLYPHS[d]
    bits = ((rows[:, None] >> np.arange(2, -1, -1)[None, :]) & 1)  # (5, 3)
    yy = (np.arange(h) * 5 // max(h, 1)).clip(max=4)
    xx = (np.arange(w) * 3 // max(w, 1)).clip(max=2)
    return (bits[yy][:, xx] * 255).astype(np.uint8)


def synthetic_multimnist(n: int = 512, seed: int = 0,
                         imsize: int = 64) -> dict:
    """The Multi-MNIST-format set of ``write_synthetic_multimnist``:
    ``image`` (n, H, W, 1) uint8 with three glyph digits each, ``bbox``
    (n, 3, 4) float32 (x, y, w, h) in [0, 1], ``label_onehot`` (n, 3, 10)
    float32."""
    rng = np.random.RandomState(seed)
    images = np.zeros((n, imsize, imsize, 1), np.uint8)
    bboxes = np.zeros((n, 3, 4), np.float32)
    labels = np.zeros((n, 3, 10), np.float32)
    for i in range(n):
        img = images[i, :, :, 0]
        for j in range(3):
            d = rng.randint(10)
            w = rng.uniform(0.2, 0.33)
            h = rng.uniform(0.2, 0.33)
            x = rng.uniform(0.0, 1.0 - w)
            y = rng.uniform(0.0, 1.0 - h)
            x0, y0 = int(x * imsize), int(y * imsize)
            x1, y1 = int((x + w) * imsize), int((y + h) * imsize)
            patch = _digit_patch(d, y1 - y0, x1 - x0)
            img[y0:y1, x0:x1] = np.maximum(img[y0:y1, x0:x1], patch)
            bboxes[i, j] = [x, y, w, h]
            labels[i, j, d] = 1.0
    return {"image": images, "bbox": bboxes, "label_onehot": labels}
