"""The COCO StackGAN set on disk (the port of the JAX package's
``data/coco.py``).

Format, as code/coco/stackgan/miscc/datasets.py:25-217 reads it:
``<data_dir>/<split>/{filenames,bboxes,labels}.pickle`` and
``char-CNN-RNN-embeddings.pickle`` (one caption embedding an item drawn at
each visit), the images ``<img_dir>/<key>.jpg``. Each image is decoded and
resized to 76 (stage 1) or 268 (stage 2) with PIL's bilinear filter, then
cropped at random to 64 or 256 and flipped at random; the boxes follow the
crop and the flip (crop_imgs, :100-190), and stage 2 carries two box sets,
``bbox`` at the 76 -> 64 scale for the frozen stage-1 G and ``bbox_s2`` at
268 -> 256 for stage 2. Labels are per-object category ids, -1 padded,
one-hot over 81 with the padding in slot 80.

The images are decoded per batch (real COCO's 82k training images are
about 17.7 GB at 268x268x3), on the CPU by ``data/jpeg.py`` and on the card
by nvjpeg (``data/nvjpeg.py``), where the batch's images stay. The random
draws come from one ``RandomState(seed)`` in the JAX reader's order
(``__getitem__`` and ``get_batch`` agree): the caption embedding, then the
flip and the crop's two offsets.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from multiple_objects_gan_tpu_torch.data.nvjpeg import decode_resized, encode
from multiple_objects_gan_tpu_torch.io.pycompat import load_pickle
from multiple_objects_gan_tpu_torch.io.torchfile import save as t7_save

MAX_OBJECTS = 3
NUM_CLASSES = 81
EMBEDDING_FILES = {"cnn-rnn": "char-CNN-RNN-embeddings.pickle",
                   "cnn-gru": "char-CNN-GRU-embeddings.pickle",
                   "skip-thought": "skip-thought-embeddings.pickle"}


def _rescale_bbox(bbox_obj, ori_size, imsize, h1, w1, flip):
    """One object's box under resize -> crop -> flip (crop_imgs)."""
    x = max(bbox_obj[0] * float(ori_size) - h1, 0) / float(imsize)
    y = max(bbox_obj[1] * float(ori_size) - w1, 0) / float(imsize)
    w = min((float(ori_size) / imsize) * bbox_obj[2], 1.0)
    if x + w > 0.999:
        w = 1.0 - x - 0.001
    h = min((float(ori_size) / imsize) * bbox_obj[3], 1.0)
    if y + h > 0.999:
        h = 1.0 - y - 0.001
    if flip:
        x = 1.0 - x - w
    return [x, y, w, h]


def rescale_boxes(bbox: np.ndarray, ori_size: int, imsize: int, h1: int,
                  w1: int, flip: bool) -> np.ndarray:
    """A (3, 4) box set under resize to ``ori_size`` -> crop at (h1, w1) to
    ``imsize`` -> flip, up to its first padded (-1) box, float32."""
    out = np.full_like(bbox, -1.0, dtype=np.float32)
    for i in range(MAX_OBJECTS):
        if bbox[i][0] == -1:
            break
        out[i] = _rescale_bbox(bbox[i], ori_size, imsize, h1, w1, flip)
    return out


def labels_to_onehot(labels: np.ndarray) -> np.ndarray:
    """(O,) or (O, 1) int ids with -1 padding -> (O, 81) one-hot, pad -> 80."""
    ids = np.asarray(labels).reshape(-1).astype(np.int64)
    ids = np.where(ids < 0, NUM_CLASSES - 1, ids)
    onehot = np.zeros((ids.shape[0], NUM_CLASSES), np.float32)
    onehot[np.arange(ids.shape[0]), ids] = 1.0
    return onehot


def crop_flip(images, h1, w1, flip, size: int):
    """Per image i of (N, S, S, C) ``images`` (numpy or a tensor), rows
    w1[i]:w1[i]+size and columns h1[i]:h1[i]+size, mirrored where flip[i]:
    one gather for the batch."""
    n = len(h1)
    ar = np.arange(size)
    rows = np.asarray(w1)[:, None] + ar
    cols = np.asarray(h1)[:, None] + ar
    cols = np.where(np.asarray(flip, bool)[:, None], cols[:, ::-1], cols)
    idx = (np.arange(n)[:, None, None], rows[:, :, None], cols[:, None, :])
    if isinstance(images, torch.Tensor):
        idx = tuple(torch.from_numpy(np.ascontiguousarray(i)).to(
            images.device) for i in idx)
    return images[idx]


class CocoStackganDataset:
    """COCO pickles and JPEG directory (reference format), read per batch.

    ``device`` says where images are decoded and returned: numpy uint8 on
    the CPU, a uint8 tensor on a CUDA device. Boxes, labels and embeddings
    are numpy either way. :meth:`rng_state` and :meth:`set_rng_state`
    carry the draws through a checkpoint.
    """

    max_objects = MAX_OBJECTS
    label_dim = NUM_CLASSES
    channels = 3

    def __init__(self, data_dir: str, img_dir: str, split: str = "train",
                 stage: int = 1, imsize: int = 64,
                 embedding_type: str = "cnn-rnn", crop: bool = True,
                 seed: int = 0, device="cpu"):
        self.split_dir = os.path.join(data_dir, split)
        self.img_dir = img_dir
        self.stage = stage
        self.imsize = imsize
        self.crop = crop
        self.device = torch.device(device)
        # the resize before the random crop (main.py's transform: 76 / 268)
        self.ori_size = 76 if imsize == 64 else 268
        self._rng = np.random.RandomState(seed)
        self.filenames = load_pickle(
            os.path.join(self.split_dir, "filenames.pickle"))
        self.bboxes = np.array(
            load_pickle(os.path.join(self.split_dir, "bboxes.pickle")),
            dtype=np.float32)
        self.labels = np.array(
            load_pickle(os.path.join(self.split_dir, "labels.pickle")))
        self.embeddings = np.array(load_pickle(os.path.join(
            self.split_dir, EMBEDDING_FILES[embedding_type])),
            dtype=np.float32)

    def __len__(self) -> int:
        return len(self.filenames)

    def path(self, index: int) -> str:
        return os.path.join(self.img_dir, str(self.filenames[index]) + ".jpg")

    def __getitem__(self, index: int) -> dict:
        return {k: v[0] for k, v in self.get_batch([index]).items()}

    def get_batch(self, idxs) -> dict:
        """The items ``idxs``: ``image`` (N, imsize, imsize, 3) uint8
        (ori_size without the crop), ``bbox`` (N, 3, 4), for stage 2
        ``bbox_s2``, ``label_onehot`` (N, 3, 81) and ``text_embedding``."""
        idxs = np.asarray(idxs).reshape(-1)
        n = len(idxs)
        arrs = decode_resized([self.path(i) for i in idxs], self.ori_size,
                              self.device)
        bbox1 = np.empty((n, self.max_objects, 4), np.float32)
        bbox2 = np.empty((n, self.max_objects, 4), np.float32)
        embs = np.empty((n, self.embeddings.shape[-1]), np.float32)
        h1 = np.zeros(n, np.int64)
        w1 = np.zeros(n, np.int64)
        flip = np.zeros(n, bool)
        margin = self.ori_size - self.imsize
        for j, i in enumerate(idxs):
            cands = self.embeddings[i]
            embs[j] = cands[self._rng.randint(cands.shape[0])]
            bb = self.bboxes[i]
            if not self.crop:
                # no crop: the normalised boxes hold at both scales
                bbox1[j] = bbox2[j] = bb
                continue
            f = bool(self._rng.rand() < 0.5)
            x0 = int(np.floor(margin * self._rng.rand()))
            y0 = int(np.floor(margin * self._rng.rand()))
            flip[j], h1[j], w1[j] = f, x0, y0
            if self.stage == 1:
                bbox1[j] = rescale_boxes(bb, self.ori_size, self.imsize,
                                           x0, y0, f)
            else:
                bbox1[j] = rescale_boxes(bb, 76, 64, x0, y0, f)
                bbox2[j] = rescale_boxes(bb, self.ori_size, self.imsize,
                                           x0, y0, f)
        images = (crop_flip(arrs, h1, w1, flip, self.imsize) if self.crop
                  else arrs)
        out = {"image": images, "bbox": bbox1,
               "label_onehot": np.stack(
                   [labels_to_onehot(self.labels[i]) for i in idxs]),
               "text_embedding": embs}
        if self.stage == 2:
            out["bbox_s2"] = bbox2
        return out

    def rng_state(self) -> dict:
        """The draws' ``RandomState`` as tensors, for a checkpoint."""
        _, keys, pos, has_gauss, gauss = self._rng.get_state()
        return {"keys": torch.from_numpy(keys.astype(np.int64)),
                "pos": int(pos), "has_gauss": int(has_gauss),
                "cached_gaussian": float(gauss)}

    def set_rng_state(self, state: dict) -> None:
        self._rng.set_state(("MT19937",
                             state["keys"].numpy().astype(np.uint32),
                             state["pos"], state["has_gauss"],
                             state["cached_gaussian"]))


def write_synthetic_coco(data_dir: str, img_dir: str, n: int = 64,
                         split: str = "train", seed: int = 0,
                         n_captions: int = 5, text_dim: int = 1024,
                         device="cpu") -> None:
    """The JAX ``write_synthetic_coco`` set from the same ``RandomState``
    stream: per item a 96x96 image of dark noise with each object's box
    filled in its label's colour, saved as ``<img_dir>/synthetic_NNNNNN.jpg``
    (``data/nvjpeg.py:encode``: PIL's encoder on the CPU, nvjpeg's on the
    card), 1-3 boxes and labels and ``n_captions`` embeddings; the four
    pickles; and for the test split ``val_captions.t7`` (its captions and
    each item's first embedding, as the reference's eval reads them)."""
    rng = np.random.RandomState(seed)
    split_dir = os.path.join(data_dir, split)
    os.makedirs(split_dir, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)
    filenames, bboxes, labels, embs = [], [], [], []
    for i in range(n):
        key = f"synthetic_{i:06d}"
        img = (rng.rand(96, 96, 3) * 40).astype(np.uint8)
        filenames.append(key)
        n_obj = rng.randint(1, MAX_OBJECTS + 1)
        bb = np.full((MAX_OBJECTS, 4), -1.0, np.float32)
        lab = np.full((MAX_OBJECTS, 1), -1, np.int64)
        for j in range(n_obj):
            w, h = rng.uniform(0.2, 0.4, 2)
            bb[j] = [rng.uniform(0, 1 - w), rng.uniform(0, 1 - h), w, h]
            lab[j] = rng.randint(0, NUM_CLASSES - 1)
            x0, y0 = int(bb[j][0] * 96), int(bb[j][1] * 96)
            x1 = int((bb[j][0] + bb[j][2]) * 96)
            y1 = int((bb[j][1] + bb[j][3]) * 96)
            lab_j = int(lab[j, 0])
            img[y0:y1, x0:x1] = np.array(
                [120 + 135 * ((lab_j * k) % 9) // 8 for k in (1, 2, 3)],
                np.uint8)
        encode(os.path.join(img_dir, key + ".jpg"), img, device)
        bboxes.append(bb)
        labels.append(lab)
        embs.append(rng.randn(n_captions, text_dim).astype(np.float32))
    for name, obj in [("filenames.pickle", filenames),
                      ("bboxes.pickle", np.stack(bboxes)),
                      ("labels.pickle", np.stack(labels)),
                      ("char-CNN-RNN-embeddings.pickle", np.stack(embs))]:
        with open(os.path.join(split_dir, name), "wb") as f:
            pickle.dump(obj, f)
    if split == "test":
        t7_save(os.path.join(split_dir, "val_captions.t7"),
                {"raw_txt": [f"synthetic caption {i}" for i in range(n)],
                 "fea_txt": [e[:1] for e in embs]})
