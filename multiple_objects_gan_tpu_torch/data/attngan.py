"""The AttnGAN COCO data (port of the JAX ``data/attngan.py``): captions,
the vocabulary, the split's layouts, and the synthetic train set held in
memory with the reader's augmentations.

Reference: the caption pipeline of code/coco/attngan/datasets.py:192-291:
each image's text file tokenized with a
``\\w+`` regex, lowercased and kept to ASCII; the vocabulary built over
train + test with ``<end>`` = 0, in first-seen order; the result cached in
``<data_dir>/captions.pickle`` as [train ids, test ids, ixtoword,
wordtoix].

The published pickles were written by Python 2; they are read through
``io/pycompat.load_pickle``, and the cache the port writes is the one the
JAX package writes.

The images are read from ``<img_dir>/<key>.jpg`` per batch
(:class:`AttnGanTrainSet`), decoded on the CPU by ``data/jpeg.py`` and on
the card by nvjpeg, and resized to 268 with PIL's bilinear filter
(``data/nvjpeg.py:decode_resized``); then per item the reader's draws from
its ``RandomState`` in its order (get_imgs and get_caption,
code/coco/attngan/datasets.py:71-137,311-329; JAX
``AttnGanDataset.__getitem__``): the h-flip, the 256 crop's offsets, the
boxes rescaled to the crop, the caption of the item and its words cut to
TEXT.WORDS_NUM; the 128 and 64px images are PIL's bilinear resize of the
crop (``data/png.py``). :func:`write_synthetic_attngan` writes the JAX
writer's set, its JPEGs included.
"""

from __future__ import annotations

import os
import pickle
import re
from collections import defaultdict

import numpy as np
import torch

from multiple_objects_gan_tpu_torch.data.coco import (
    MAX_OBJECTS, crop_flip, labels_to_onehot, rescale_boxes)
from multiple_objects_gan_tpu_torch.data.nvjpeg import decode_resized, encode
from multiple_objects_gan_tpu_torch.data.png import (
    resize_bilinear_batch, resize_bilinear_tensor)
from multiple_objects_gan_tpu_torch.io.pycompat import load_pickle

LOAD_SIZE = 268             # the reader's resize before its 256 crop
CROP = 256
_TOKEN_RE = re.compile(r"\w+")


def tokenize(caption: str) -> list[str]:
    """The reference's tokenizer: lowercased ``\\w+`` runs, ASCII only."""
    toks = _TOKEN_RE.findall(caption.lower().replace("��", " "))
    out = []
    for t in toks:
        t = t.encode("ascii", "ignore").decode("ascii")
        if t:
            out.append(t)
    return out


def load_captions(data_dir: str, filenames, captions_per_image: int):
    """The first ``captions_per_image`` non-empty captions of each file's
    text, tokenized. A file with fewer raises: the flat caption list is
    indexed as index * captions_per_image + sent_ix, so a short one would
    pair every later image with the wrong captions (the reference only
    prints, datasets.py:258-259)."""
    all_captions = []
    for name in filenames:
        path = os.path.join(data_dir, "text", f"{name}.txt")
        with open(path, encoding="utf-8") as f:
            raw = f.read().split("\n")
        cnt = 0
        for cap in raw:
            if not cap:
                continue
            tokens = tokenize(cap)
            if not tokens:
                continue
            all_captions.append(tokens)
            cnt += 1
            if cnt == captions_per_image:
                break
        if cnt < captions_per_image:
            raise ValueError(
                f"ERROR: the captions for {name} less than "
                f"{captions_per_image} ({cnt}): the flat caption index "
                "would misalign all later images")
    return all_captions


def build_dictionary(train_captions, test_captions):
    """(train ids, test ids, ixtoword, wordtoix, n_words): every word of
    both splits in first-seen order after ``<end>`` = 0."""
    word_counts: dict = defaultdict(float)
    for sent in train_captions + test_captions:
        for w in sent:
            word_counts[w] += 1
    ixtoword = {0: "<end>"}
    wordtoix = {"<end>": 0}
    for ix, w in enumerate(word_counts, start=1):
        wordtoix[w] = ix
        ixtoword[ix] = w

    def to_ids(caps):
        return [[wordtoix[w] for w in sent if w in wordtoix]
                for sent in caps]

    return (to_ids(train_captions), to_ids(test_captions),
            ixtoword, wordtoix, len(ixtoword))


def _load_filenames(data_dir: str, split: str) -> list:
    path = os.path.join(data_dir, split, "filenames.pickle")
    return load_pickle(path) if os.path.isfile(path) else []


class AttnGanDataset:
    """One split's captions, boxes and labels, and the vocabulary.

    Reads ``<data_dir>/<split>/{bboxes,labels}.pickle`` and the filenames
    of both splits, then ``<data_dir>/captions.pickle`` when it exists, or
    else builds the vocabulary from the text files and writes that cache.
    ``wordtoix``, ``ixtoword`` and ``n_words`` are the vocabulary;
    ``captions`` the split's word ids a caption.
    """

    def __init__(self, data_dir: str, split: str = "train",
                 captions_per_image: int = 5):
        split_dir = os.path.join(data_dir, split)
        self.bboxes = np.array(
            load_pickle(os.path.join(split_dir, "bboxes.pickle")),
            np.float32)
        self.labels = np.array(
            load_pickle(os.path.join(split_dir, "labels.pickle")))
        cache = os.path.join(data_dir, "captions.pickle")
        train_names = _load_filenames(data_dir, "train")
        test_names = _load_filenames(data_dir, "test")
        if not os.path.isfile(cache):
            tr = load_captions(data_dir, train_names, captions_per_image)
            te = load_captions(data_dir, test_names, captions_per_image)
            tr, te, self.ixtoword, self.wordtoix, self.n_words = \
                build_dictionary(tr, te)
            with open(cache, "wb") as f:
                pickle.dump([tr, te, self.ixtoword, self.wordtoix], f)
        else:
            tr, te, self.ixtoword, self.wordtoix = load_pickle(cache)
            self.n_words = len(self.ixtoword)
        self.captions = tr if split == "train" else te
        self.filenames = train_names if split == "train" else test_names

    def __len__(self):
        return len(self.filenames)


def _synthetic_items(n: int, seed: int, captions_per_image: int,
                     vocab: int, images: bool = True):
    """The JAX writer's stream (JAX ``write_synthetic_attngan``): per item
    of the train split (n items), then the test split (max(4, n // 4)),
    ``(split, key, image, bbox, labels, caption lines)``. The image is the
    writer's 268x268 draw, ``rand * 40``, with each object's box filled in
    its label's colour; without ``images`` it is drawn, so that the stream
    stays the same, and None."""
    rng = np.random.RandomState(seed)
    words = [f"word{i}" for i in range(vocab)]
    for split, count in [("train", n), ("test", max(4, n // 4))]:
        for i in range(count):
            key = f"{split}_{i:05d}"
            img = rng.rand(268, 268, 3)
            img = (img * 40).astype(np.uint8) if images else None
            n_obj = rng.randint(1, MAX_OBJECTS + 1)
            bb = np.full((MAX_OBJECTS, 4), -1.0, np.float32)
            lab = np.full((MAX_OBJECTS, 1), -1, np.int64)
            obj_tokens = []
            for j in range(n_obj):
                w, h = rng.uniform(0.2, 0.4, 2)
                bb[j] = [rng.uniform(0, 1 - w), rng.uniform(0, 1 - h), w, h]
                lab[j] = rng.randint(0, 80)
                x0, y0 = int(bb[j][0] * 268), int(bb[j][1] * 268)
                x1 = int((bb[j][0] + bb[j][2]) * 268)
                y1 = int((bb[j][1] + bb[j][3]) * 268)
                lab_j = int(lab[j, 0])
                if images:
                    img[y0:y1, x0:x1] = np.array(
                        [120 + 135 * ((lab_j * k) % 9) // 8
                         for k in (1, 2, 3)], np.uint8)
                gx = min(int((bb[j][0] + bb[j][2] / 2) * 3), 2)
                gy = min(int((bb[j][1] + bb[j][3] / 2) * 3), 2)
                obj_tokens.append(f"obj{lab_j} loc{gx}{gy}")
            cap_lines = []
            for _ in range(captions_per_image):
                order = rng.permutation(n_obj)
                toks = [obj_tokens[j] for j in order]
                toks += list(rng.choice(words, rng.randint(1, 4)))
                cap_lines.append(" ".join(toks))
            yield split, key, img, bb, lab, cap_lines


def write_synthetic_attngan(data_dir: str, img_dir: str | None = None,
                            n: int = 32, seed: int = 0,
                            captions_per_image: int = 5, vocab: int = 50,
                            device="cpu") -> None:
    """The JAX package's synthetic AttnGAN set from the same
    ``RandomState`` stream: the text files, ``{filenames,bboxes,labels}.pickle``
    of both splits (n train items, max(4, n // 4) test items) and so the
    same vocabulary, and, with ``img_dir``, each item's 268x268 image as
    ``<img_dir>/<key>.jpg`` (``data/nvjpeg.py:encode``: PIL's encoder on
    the CPU, nvjpeg's on the card). Each caption names every object
    (``obj<label>``) and its cell of a 3x3 grid (``loc<gx><gy>``) in a
    random order, then 1-3 filler words (``word<i>``). Without ``img_dir``
    the text side alone is written (the vocabulary a service needs)."""
    os.makedirs(os.path.join(data_dir, "text"), exist_ok=True)
    if img_dir is not None:
        os.makedirs(img_dir, exist_ok=True)
    splits: dict = {}
    for split, key, img, bb, lab, cap_lines in _synthetic_items(
            n, seed, captions_per_image, vocab, images=img_dir is not None):
        with open(os.path.join(data_dir, "text", key + ".txt"), "w") as f:
            f.write("\n".join(cap_lines))
        if img is not None:
            encode(os.path.join(img_dir, key + ".jpg"), img, device)
        rows = splits.setdefault(split, ([], [], []))
        for col, v in zip(rows, (key, bb, lab)):
            col.append(v)
    for split, (filenames, bboxes, labels) in splits.items():
        split_dir = os.path.join(data_dir, split)
        os.makedirs(split_dir, exist_ok=True)
        for name, obj in [("filenames.pickle", filenames),
                          ("bboxes.pickle", np.stack(bboxes)),
                          ("labels.pickle", np.stack(labels))]:
            with open(os.path.join(split_dir, name), "wb") as f:
                pickle.dump(obj, f)


class AttnGanTrainSet:
    """One split (``train`` or ``test``) read from ``img_dir`` per batch, in
    the JAX reader's order.

    The captions, boxes and labels are :class:`AttnGanDataset`'s; the
    images ``<img_dir>/<filename>.jpg`` are decoded and resized to 268 on
    ``device`` (numpy on the CPU, tensors on the card). Each split draws
    its crops, flips and captions as the JAX reader of that split does,
    from its own ``RandomState``. :meth:`get_batch` gives what the JAX
    reader's ``__getitem__`` gives for the same indices, stacked:
    ``image{64,128,256}`` (uint8 NHWC), ``bbox``, ``label_onehot``,
    ``captions`` (B, words_num) int64 zero-padded, ``cap_lens`` and
    ``class_ids`` (arange, or the split's ``class_info.pickle`` where there
    is one); with BASE_SIZE 256 and BRANCH_NUM 1 ``image256`` alone.
    The draws come from one ``RandomState(seed)`` carried across epochs;
    :meth:`rng_state` and :meth:`set_rng_state` carry it through a
    checkpoint, so a resumed run draws what an uninterrupted one draws.
    """

    def __init__(self, data_dir: str, img_dir: str, base_size: int = 64,
                 branch_num: int = 3, captions_per_image: int = 5,
                 words_num: int = 12, seed: int = 0, split: str = "train",
                 device="cpu"):
        self.text = AttnGanDataset(data_dir, split, captions_per_image)
        self.img_dir = img_dir
        self.device = torch.device(device)
        self.embeddings_num = captions_per_image
        self.words_num = words_num
        self.imsizes = [base_size * (2 ** i) for i in range(branch_num)]
        self._rng = np.random.RandomState(seed)
        cls_path = os.path.join(data_dir, split, "class_info.pickle")
        self.class_id = (np.asarray(load_pickle(cls_path))
                         if os.path.isfile(cls_path)
                         else np.arange(len(self.text)))

    def __len__(self) -> int:
        return len(self.text)

    @property
    def ixtoword(self) -> dict:
        return self.text.ixtoword

    @property
    def wordtoix(self) -> dict:
        return self.text.wordtoix

    @property
    def n_words(self) -> int:
        return self.text.n_words

    def _get_caption(self, sent_ix: int):
        """Caption ``sent_ix``'s ids zero-padded to words_num, or
        words_num of them drawn in order when it is longer, and its length
        (at least 1)."""
        sent = np.asarray(self.text.captions[sent_ix], np.int64)
        x = np.zeros(self.words_num, np.int64)
        if len(sent) <= self.words_num:
            x[:len(sent)] = sent
            return x, max(len(sent), 1)
        ix = np.sort(self._rng.permutation(len(sent))[:self.words_num])
        x[:] = sent[ix]
        return x, self.words_num

    def path(self, index: int) -> str:
        return os.path.join(self.img_dir,
                            str(self.text.filenames[index]) + ".jpg")

    def get_batch(self, idxs) -> dict:
        idxs = np.asarray(idxs).reshape(-1)
        n = len(idxs)
        images = decode_resized([self.path(i) for i in idxs], LOAD_SIZE,
                                self.device)
        bbox = np.empty((n, MAX_OBJECTS, 4), np.float32)
        caps = np.empty((n, self.words_num), np.int64)
        lens = np.empty((n,), np.int64)
        h1 = np.zeros(n, np.int64)
        w1 = np.zeros(n, np.int64)
        flip = np.zeros(n, bool)
        for j, i in enumerate(idxs):
            f = bool(self._rng.rand() < 0.5)
            x0 = int(np.floor(12 * self._rng.rand()))
            y0 = int(np.floor(12 * self._rng.rand()))
            flip[j], h1[j], w1[j] = f, x0, y0
            bbox[j] = rescale_boxes(self.text.bboxes[i], LOAD_SIZE, CROP,
                                    x0, y0, f)
            sent_ix = self._rng.randint(0, self.embeddings_num)
            caps[j], lens[j] = self._get_caption(
                int(i) * self.embeddings_num + sent_ix)
        crops = crop_flip(images, h1, w1, flip, CROP)
        resize = (resize_bilinear_tensor if isinstance(crops, torch.Tensor)
                  else resize_bilinear_batch)
        out = {f"image{s}": crops if s == CROP else resize(crops, (s, s))
               for s in self.imsizes}
        out.update({
            "bbox": bbox,
            "label_onehot": np.stack([labels_to_onehot(self.text.labels[i])
                                      for i in idxs]),
            "captions": caps, "cap_lens": lens,
            "class_ids": self.class_id[idxs].astype(np.int64)})
        return out

    def rng_state(self) -> dict:
        """The draws' ``RandomState`` as tensors, for a checkpoint."""
        kind, keys, pos, has_gauss, gauss = self._rng.get_state()
        return {"keys": torch.from_numpy(keys.astype(np.int64)),
                "pos": int(pos), "has_gauss": int(has_gauss),
                "cached_gaussian": float(gauss)}

    def set_rng_state(self, state: dict) -> None:
        self._rng.set_state(("MT19937",
                             state["keys"].numpy().astype(np.uint32),
                             state["pos"], state["has_gauss"],
                             state["cached_gaussian"]))


def attngan_split(data_dir: str, img_dir: str, st, seed: int,
                  split: str = "train", device="cpu") -> AttnGanTrainSet:
    """``split`` of the set in ``data_dir`` with its JPEGs in ``img_dir``,
    at the TEXT and TREE settings of ``st`` (a
    ``config.AttnGanTrainSettings``), its draws from ``seed``, decoded on
    ``device``."""
    return AttnGanTrainSet(
        data_dir, img_dir, base_size=st.base_size, branch_num=st.branch_num,
        captions_per_image=st.captions_per_image, words_num=st.words_num,
        seed=seed, split=split, device=device)
