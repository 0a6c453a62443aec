"""Layout fidelity of generated images (the port's copy of the JAX
package's ``utils/layout_fidelity.py``): the in-repo stand-in for the
paper's YOLOv3 check that objects appear where, and as what, the layout
asks.

* **per-label recall**: a small classifier, trained on the synthetic
  renderer's glyphs (or CLEVR shapes) seen through the same STN crop the
  discriminator's object pathway takes (``ops/stn.py:
  stn_extract_multi``, plain torch), reads each box's crop; its argmax is
  compared with the conditioned label;
* **localization IoU**: the tightest box of above-threshold luminance in
  a window around each conditioned box, IoU'd against it.

The renderers draw from the same ``RandomState`` stream as the JAX ones,
so they give the same pixels bit for bit; the classifiers' SGD takes the
same batches and the same ``0.1 * randn`` noise. Their initial weights
come from a ``torch.Generator`` (the JAX package draws them with
``jax.random``), or from ``init`` where a test replays JAX's draw. The
crops, the classifier and its training run on ``device``; the scores
are host numpy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from multiple_objects_gan_tpu_torch import resolve_device
from multiple_objects_gan_tpu_torch.data.synthetic import (
    _CLEVR_PALETTE, CLEVR_COLORS, CLEVR_SHAPES, _digit_patch)
from multiple_objects_gan_tpu_torch.ops.stn import stn_extract_multi

CROP = 16       # the canonical crop, the D object pathway's resolution
HIDDEN = 64     # the classifiers' hidden units


@dataclasses.dataclass
class DigitClassifier:
    """A 2-layer MLP over flattened crops: ``params`` w1 (crop², 64), b1,
    w2 (64, 10), b2, float32 tensors on one device."""

    params: dict
    crop: int = CROP

    def logits(self, crops: torch.Tensor) -> torch.Tensor:
        """(N, crop, crop) luminance in [-1, 1] -> (N, 10)."""
        p = self.params
        x = crops.reshape(crops.shape[0], -1).float()
        return torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


@dataclasses.dataclass
class ClevrClassifier:
    """A 2-layer MLP over flattened RGB crops with two heads: shape
    (3-way) and colour (8-way)."""

    params: dict
    crop: int = CROP

    def logits(self, crops: torch.Tensor) -> tuple:
        """(N, crop, crop, 3) in [-1, 1] -> ((N, 3), (N, 8))."""
        p = self.params
        x = crops.reshape(crops.shape[0], -1).float()
        out = torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
        return out[:, :3], out[:, 3:]


def _render_batch(rs: np.random.RandomState, n: int, imsize: int = 64):
    """n single-digit canvases drawn as the synthetic writer draws them:
    (images (n, s, s, 1) in [-1, 1], bbox (n, 1, 4), labels (n,))."""
    imgs = np.zeros((n, imsize, imsize, 1), np.float32)
    bbox = np.zeros((n, 1, 4), np.float32)
    labels = rs.randint(0, 10, n)
    for i in range(n):
        w = rs.uniform(0.2, 0.33)
        h = rs.uniform(0.2, 0.33)
        x = rs.uniform(0.0, 1.0 - w)
        y = rs.uniform(0.0, 1.0 - h)
        x0, y0 = int(x * imsize), int(y * imsize)
        x1, y1 = int((x + w) * imsize), int((y + h) * imsize)
        patch = _digit_patch(int(labels[i]), y1 - y0, x1 - x0)
        imgs[i, y0:y1, x0:x1, 0] = patch.astype(np.float32)
        bbox[i, 0] = [x, y, w, h]
    imgs = imgs / 127.5 - 1.0
    return imgs, bbox, labels


def _render_clevr_batch(rs: np.random.RandomState, n: int,
                        imsize: int = 64):
    """n single-object CLEVR-style canvases (palette colours; cube a
    filled box, sphere a disc, cylinder a capsule): (images (n, s, s, 3)
    in [-1, 1], bbox (n, 1, 4), shape_ids (n,), color_ids (n,))."""
    shapes = list(CLEVR_SHAPES)
    colors = list(CLEVR_COLORS)
    imgs = np.zeros((n, imsize, imsize, 3), np.float32)
    bbox = np.zeros((n, 1, 4), np.float32)
    shape_ids = rs.randint(0, len(shapes), n)
    color_ids = rs.randint(0, len(colors), n)
    for i in range(n):
        w = h = rs.randint(imsize // 6, imsize // 3)
        x0 = rs.randint(0, imsize - w)
        y0 = rs.randint(0, imsize - h)
        yy, xx = np.indices((h, w)).astype(np.float32)
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        shape = shapes[shape_ids[i]]
        if shape == "sphere":
            mask = (((yy - cy) / max(cy, 1)) ** 2
                    + ((xx - cx) / max(cx, 1)) ** 2) <= 1.0
        elif shape == "cylinder":
            mask = np.abs(xx - cx) <= (w * 0.3)
        else:  # cube
            mask = np.ones((h, w), bool)
        imgs[i, y0:y0 + h, x0:x0 + w][mask] = _CLEVR_PALETTE[
            colors[color_ids[i]]]
        bbox[i, 0] = [x0 / imsize, y0 / imsize, w / imsize, h / imsize]
    imgs = imgs / 127.5 - 1.0
    return imgs, bbox, shape_ids, color_ids


def initial_params(d_in: int, d_out: int, seed: int, device) -> dict:
    """He-scaled normal w1 (d_in, 64) and w2 (64, d_out) from
    ``torch.Generator().manual_seed(seed)``, zero biases."""
    gen = torch.Generator().manual_seed(seed)
    return {k: v.to(device) for k, v in {
        "w1": torch.randn(d_in, HIDDEN, generator=gen)
        * math.sqrt(2.0 / d_in),
        "b1": torch.zeros(HIDDEN),
        "w2": torch.randn(HIDDEN, d_out, generator=gen)
        * math.sqrt(2.0 / HIDDEN),
        "b2": torch.zeros(d_out)}.items()}


def _given(init: dict, device) -> dict:
    """``init``'s arrays (numpy, jax or torch) as float32 tensors."""
    return {k: torch.tensor(np.array(v, np.float32), device=device)
            for k, v in init.items()}


def _extract(images: np.ndarray, bbox: np.ndarray, crop: int,
             device) -> torch.Tensor:
    return stn_extract_multi(torch.as_tensor(images).to(device),
                             torch.as_tensor(bbox).to(device), (crop, crop))


def _sgd(params: dict, loss_fn, batches, lr: float) -> dict:
    """Plain SGD: p -= lr * grad for each batch of ``batches``."""
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in params.items()}
    for batch in batches:
        grads = torch.autograd.grad(loss_fn(params, *batch),
                                    list(params.values()))
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p.sub_(lr * g)
    return {k: v.detach() for k, v in params.items()}


def train_digit_classifier(seed: int = 0, steps: int = 400,
                           batch: int = 128, lr: float = 1e-2,
                           crop: int = CROP, *, device="cuda",
                           init: Optional[dict] = None) -> DigitClassifier:
    """Fit the digit MLP on renderer output seen through the STN crop,
    plus 0.1 * randn noise so that slightly blurred GAN output still
    classifies (JAX ``train_digit_classifier``)."""
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    params = (initial_params(crop * crop, 10, seed, dev) if init is None
              else _given(init, dev))

    def loss_fn(p, x, y):
        lg = DigitClassifier(p, crop).logits(x)
        n = torch.arange(x.shape[0], device=x.device)
        return -F.log_softmax(lg, -1)[n, y].mean()

    def batches():
        for _ in range(steps):
            imgs, bbox, labels = _render_batch(rs, batch)
            crops = _extract(imgs, bbox, crop, dev)[:, 0, :, :, 0]
            noise = 0.1 * rs.randn(*crops.shape).astype(np.float32)
            yield (crops + torch.from_numpy(noise).to(dev),
                   torch.from_numpy(labels).to(dev))

    return DigitClassifier(_sgd(params, loss_fn, batches(), lr), crop)


def train_clevr_classifier(seed: int = 0, steps: int = 400,
                           batch: int = 128, lr: float = 1e-2,
                           crop: int = CROP, *, device="cuda",
                           init: Optional[dict] = None) -> ClevrClassifier:
    """Fit the shape and colour MLP as :func:`train_digit_classifier`
    fits the digits (JAX ``train_clevr_classifier``)."""
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    params = (initial_params(crop * crop * 3, 11, seed, dev) if init is None
              else _given(init, dev))

    def loss_fn(p, x, ys, yc):
        ls, lc = ClevrClassifier(p, crop).logits(x)
        n = torch.arange(x.shape[0], device=x.device)
        return -(F.log_softmax(ls, -1)[n, ys].mean()
                 + F.log_softmax(lc, -1)[n, yc].mean())

    def batches():
        for _ in range(steps):
            imgs, bbox, ys, yc = _render_clevr_batch(rs, batch)
            crops = _extract(imgs, bbox, crop, dev)[:, 0]
            noise = 0.1 * rs.randn(*crops.shape).astype(np.float32)
            yield (crops + torch.from_numpy(noise).to(dev),
                   torch.from_numpy(ys).to(dev),
                   torch.from_numpy(yc).to(dev))

    return ClevrClassifier(_sgd(params, loss_fn, batches(), lr), crop)


def _luminance(images: np.ndarray) -> np.ndarray:
    """(B, H, W, C) in [-1, 1] -> (B, H, W) luminance in [0, 1]."""
    return (np.asarray(images, np.float32).mean(-1) + 1.0) / 2.0


def _loc_iou(lum: np.ndarray, bb: np.ndarray, thr: float = 0.35,
             pad: float = 0.5) -> float:
    """IoU between the conditioned box and the tightest box of
    above-threshold luminance inside a (1 + 2*pad)-padded window of it;
    0 when the window holds no such pixel."""
    h, w = lum.shape
    x, y, bw, bh = float(bb[0]), float(bb[1]), float(bb[2]), float(bb[3])
    wx0 = max(0, int((x - pad * bw) * w))
    wy0 = max(0, int((y - pad * bh) * h))
    wx1 = min(w, int(np.ceil((x + bw * (1 + pad)) * w)))
    wy1 = min(h, int(np.ceil((y + bh * (1 + pad)) * h)))
    win = lum[wy0:wy1, wx0:wx1] > thr
    ys, xs = np.nonzero(win)
    if ys.size == 0:
        return 0.0
    px0, px1 = (wx0 + xs.min()) / w, (wx0 + xs.max() + 1) / w
    py0, py1 = (wy0 + ys.min()) / h, (wy0 + ys.max() + 1) / h
    ix0, iy0 = max(px0, x), max(py0, y)
    ix1, iy1 = min(px1, x + bw), min(py1, y + bh)
    inter = max(0.0, ix1 - ix0) * max(0.0, iy1 - iy0)
    union = (px1 - px0) * (py1 - py0) + bw * bh - inter
    return inter / union if union > 0 else 0.0


def _argmax(logits: torch.Tensor, b: int, o: int) -> np.ndarray:
    return logits.argmax(-1).reshape(b, o).cpu().numpy()


def layout_fidelity(images, bbox, labels, clf: DigitClassifier) -> dict:
    """Score generated digit images against their layout (JAX
    ``layout_fidelity``). images (B, H, W, C) in [-1, 1]; bbox (B, O, 4)
    normalized xywh, rows with w <= 0 padding; labels (B, O) class ids or
    (B, O, L) one-hots. The crops and the classifier run on the device
    of ``clf``'s parameters. Returns {"recall", "per_label_recall",
    "loc_iou", "n_objects"}."""
    images = np.asarray(images, np.float32)
    bbox = np.asarray(bbox, np.float32)
    labels = np.asarray(labels)
    if labels.ndim == 3:
        labels = labels.argmax(-1)
    dev = clf.params["w1"].device
    # the classifier reads single-channel luminance in [-1, 1]
    lum_m1 = _luminance(images) * 2.0 - 1.0
    b, o = bbox.shape[:2]
    with torch.no_grad():
        crops = _extract(lum_m1[..., None], bbox, clf.crop, dev)[..., 0]
        preds = _argmax(clf.logits(crops.reshape(b * o, clf.crop,
                                                 clf.crop)), b, o)
    valid = bbox[..., 2] > 0
    hits = (preds == labels) & valid
    n_valid = int(valid.sum())
    per_label = {}
    for c in range(10):
        m = (labels == c) & valid
        if m.sum():
            per_label[c] = round(float(hits[m].sum() / m.sum()), 3)
    lum = _luminance(images)
    ious = [_loc_iou(lum[i], bbox[i, j])
            for i in range(b) for j in range(o) if valid[i, j]]
    return {
        "recall": round(float(hits.sum() / max(n_valid, 1)), 3),
        "per_label_recall": per_label,
        "loc_iou": round(float(np.mean(ious)) if ious else 0.0, 3),
        "n_objects": n_valid,
    }


def clevr_layout_fidelity(images, bbox, labels,
                          clf: ClevrClassifier) -> dict:
    """Score generated CLEVR images against their layout (JAX
    ``clevr_layout_fidelity``). labels (B, O, 13) multi-hot: shape
    one-hot in [0:3], colour in [4:12]. Returns {"recall_shape",
    "recall_color", "recall_both", "loc_iou", "n_objects"}."""
    images = np.asarray(images, np.float32)
    bbox = np.asarray(bbox, np.float32)
    labels = np.asarray(labels, np.float32)
    dev = clf.params["w1"].device
    b, o = bbox.shape[:2]
    with torch.no_grad():
        crops = _extract(images, bbox, clf.crop, dev)
        ls, lc = clf.logits(crops.reshape(b * o, clf.crop, clf.crop, 3))
        pred_s, pred_c = _argmax(ls, b, o), _argmax(lc, b, o)
    true_s = labels[..., 0:3].argmax(-1)
    true_c = labels[..., 4:12].argmax(-1)
    valid = (bbox[..., 2] > 0) & (labels[..., 0:3].sum(-1) > 0)
    n_valid = int(valid.sum())
    hit_s = (pred_s == true_s) & valid
    hit_c = (pred_c == true_c) & valid
    lum = _luminance(images)
    ious = [_loc_iou(lum[i], bbox[i, j], thr=0.2)
            for i in range(b) for j in range(o) if valid[i, j]]
    return {
        "recall_shape": round(float(hit_s.sum() / max(n_valid, 1)), 3),
        "recall_color": round(float(hit_c.sum() / max(n_valid, 1)), 3),
        "recall_both": round(
            float((hit_s & hit_c).sum() / max(n_valid, 1)), 3),
        "loc_iou": round(float(np.mean(ious)) if ious else 0.0, 3),
        "n_objects": n_valid,
    }
