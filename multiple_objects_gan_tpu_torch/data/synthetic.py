"""Synthetic data for the port (copies of the JAX package's generators).

* :func:`synthetic_batch` is ``data/synthetic.py:synthetic_batch``: one
  batch of any stage-1 variant, the batch ``bench.py`` times.
* :func:`synthetic_multimnist` is the numpy part of
  ``data/datasets.py:write_synthetic_multimnist``: the same uint8 images,
  boxes and one-hot labels from the same seed, held in memory.
* :func:`clevr_scenes` makes the draws of
  ``data/datasets.py:write_synthetic_clevr``, and :func:`synthetic_clevr`
  holds in memory the items ``ClevrDataset`` reads back from it without
  its h-flip.
* :func:`synthetic_coco` makes the draws of ``data/coco.py:
  write_synthetic_coco`` from the same seed, with the images drawn at
  64x64 (or stage 2's 256x256) directly; :func:`synthetic_coco_stage2`
  adds stage 2's boxes. They hold single steps in tests and in
  ``chip_smoke.py``'s step phases; the entries read COCO from disk
  (``data/coco.py``).
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


# datasets.py:CLEVR_SHAPES, CLEVR_COLORS and write_synthetic_clevr's palette
CLEVR_SHAPES = {"cube": 0, "cylinder": 1, "sphere": 2}
CLEVR_COLORS = {"gray": 0, "red": 1, "blue": 2, "green": 3, "brown": 4,
                "purple": 5, "cyan": 6, "yellow": 7}
_CLEVR_PALETTE = {"gray": (128, 128, 128), "red": (200, 30, 30),
                  "blue": (40, 60, 200), "green": (30, 160, 60),
                  "brown": (140, 90, 40), "purple": (130, 40, 160),
                  "cyan": (40, 180, 190), "yellow": (210, 200, 40)}
CLEVR_MAX_OBJECTS = 4


def clevr_scenes(n: int = 256, seed: int = 0, imsize: int = 64):
    """The draws of ``write_synthetic_clevr``, in its order: per item the
    uint8 image (H, W, 3) with 2-4 coloured cubes, discs and capsules and
    its scene's objects, ``{"bbox": [x, y, w, h] in pixels, "shape",
    "color"}``."""
    rng = np.random.RandomState(seed)
    shapes, colors = list(CLEVR_SHAPES), list(CLEVR_COLORS)
    for _ in range(n):
        img = np.zeros((imsize, imsize, 3), np.uint8)
        objects = []
        for _ in range(rng.randint(2, 5)):
            w = h = rng.randint(imsize // 6, imsize // 3)
            x = rng.randint(0, imsize - w)
            y = rng.randint(0, imsize - h)
            shape = shapes[rng.randint(len(shapes))]
            color = colors[rng.randint(len(colors))]
            yy, xx = np.indices((h, w)).astype(np.float32)
            cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
            if shape == "sphere":
                mask = (((yy - cy) / max(cy, 1)) ** 2
                        + ((xx - cx) / max(cx, 1)) ** 2) <= 1.0
            elif shape == "cylinder":
                mask = np.abs(xx - cx) <= (w * 0.3)
            else:
                mask = np.ones((h, w), bool)
            img[y:y + h, x:x + w][mask] = _CLEVR_PALETTE[color]
            objects.append({"bbox": [float(x), float(y), float(w), float(h)],
                            "shape": shape, "color": color})
        yield img, objects


def clevr_item(objects: list, hw: tuple[int, int]
               ) -> tuple[np.ndarray, np.ndarray]:
    """A scene's objects -> (bbox (4, 4) float32 (x, y, w, h) over the
    image's size (H, W), -1 for a padded object; label_onehot (4, 13)
    float32: shape in slots 0-2, colour in slots 4-11, and a padded object
    one-hot in slots 3 and 12 (``datasets.py:156-165``), which enter the
    D condition)."""
    h, w = hw
    o = CLEVR_MAX_OBJECTS
    bbox = np.full((o, 4), -1.0, np.float32)
    label = np.zeros((o, 13), np.float32)
    label[:, 3] = 1.0
    label[:, 4 + 8] = 1.0
    for i, obj in enumerate(objects[:o]):
        x, y, bw, bh = obj["bbox"]
        bbox[i] = [x / w, y / h, bw / w, bh / h]
        label[i] = 0.0
        label[i, CLEVR_SHAPES[obj["shape"]]] = 1.0
        label[i, 4 + CLEVR_COLORS[obj["color"]]] = 1.0
    return bbox, label


def synthetic_clevr(n: int = 256, seed: int = 0, imsize: int = 64) -> dict:
    """The CLEVR-format set of ``write_synthetic_clevr`` as ``ClevrDataset``
    reads it without its h-flip: ``image`` (n, H, W, 3) uint8, ``bbox``
    (n, 4, 4) and ``label_onehot`` (n, 4, 13) float32 (:func:`clevr_item`).
    """
    images, bboxes, labels = [], [], []
    for img, objects in clevr_scenes(n, seed, imsize):
        bbox, label = clevr_item(objects, img.shape[:2])
        images.append(img)
        bboxes.append(bbox)
        labels.append(label)
    return {"image": np.stack(images), "bbox": np.stack(bboxes),
            "label_onehot": np.stack(labels)}


COCO_MAX_OBJECTS = 3
COCO_CLASSES = 81


def synthetic_coco(n: int = 256, seed: int = 0, imsize: int = 64,
                   n_captions: int = 5, text_dim: int = 1024) -> dict:
    """The COCO-format set of ``write_synthetic_coco`` from the same draws:
    ``bbox`` (n, 3, 4) float32, -1 for a padded object; ``label_onehot``
    (n, 3, 81), a padded object one-hot in slot 80 (``coco.py:44-51``);
    ``text_embedding`` (n, n_captions, text_dim) float32, the caption
    embeddings; ``image`` (n, H, W, 3) uint8, the writer's dark noise at
    the H x W nearest grid of its 96x96 draw, with each object's
    rectangle in its label's colour painted at this size."""
    rng = np.random.RandomState(seed)
    o = COCO_MAX_OBJECTS
    images = np.zeros((n, imsize, imsize, 3), np.uint8)
    bboxes = np.full((n, o, 4), -1.0, np.float32)
    labels = np.zeros((n, o, COCO_CLASSES), np.float32)
    labels[:, :, COCO_CLASSES - 1] = 1.0
    embs = np.zeros((n, n_captions, text_dim), np.float32)
    grid = np.arange(imsize) * 96 // imsize
    for i in range(n):
        noise = (rng.rand(96, 96, 3) * 40).astype(np.uint8)
        img = images[i]
        img[:] = noise[grid][:, grid]
        for j in range(rng.randint(1, o + 1)):
            w, h = rng.uniform(0.2, 0.4, 2)
            bb = np.array([rng.uniform(0, 1 - w), rng.uniform(0, 1 - h),
                           w, h], np.float32)
            lab = int(rng.randint(0, COCO_CLASSES - 1))
            color = np.array([120 + 135 * ((lab * k) % 9) // 8
                              for k in (1, 2, 3)], np.uint8)
            x0, y0 = int(bb[0] * imsize), int(bb[1] * imsize)
            x1 = int((bb[0] + bb[2]) * imsize)
            y1 = int((bb[1] + bb[3]) * imsize)
            img[y0:y1, x0:x1] = color
            bboxes[i, j] = bb
            labels[i, j] = 0.0
            labels[i, j, lab] = 1.0
        embs[i] = rng.randn(n_captions, text_dim).astype(np.float32)
    return {"image": images, "bbox": bboxes, "label_onehot": labels,
            "text_embedding": embs}


def synthetic_coco_stage2(n: int = 80, seed: int = 0, imsize: int = 256,
                          **kwargs) -> dict:
    """The stage-2 train set: :func:`synthetic_coco` at ``imsize`` (256,
    cfg/coco_s2_train.yml's IMSIZE) with ``bbox_s2``, the stage-2 boxes,
    equal to ``bbox``, as the COCO reader gives them when it does not
    crop (``data/coco.py:106-110``). Keyword arguments go to
    :func:`synthetic_coco`."""
    data = synthetic_coco(n, seed=seed, imsize=imsize, **kwargs)
    data["bbox_s2"] = data["bbox"].copy()
    return data
