"""The text side of the AttnGAN COCO data (port of the JAX
``data/attngan.py``): captions, the vocabulary, and the split's layouts.

Reference: the caption pipeline of code/coco/attngan/datasets.py:192-291:
each image's text file tokenized with a
``\\w+`` regex, lowercased and kept to ASCII; the vocabulary built over
train + test with ``<end>`` = 0, in first-seen order; the result cached in
``<data_dir>/captions.pickle`` as [train ids, test ids, ixtoword,
wordtoix].

The published pickles were written by Python 2; they are read through
``io/pycompat.load_pickle``, and the cache the port writes is the one the
JAX package writes. The images (JPEGs, resized, cropped and flipped with
their boxes) wait for the JPEG reader: the card's machine has no JPEG
decoder or encoder, so this module reads no image and
:func:`write_synthetic_attngan` writes none. A caption's padding and
subsampling to TEXT.WORDS_NUM (get_caption, :311-329) waits with them.
"""

from __future__ import annotations

import os
import pickle
import re
from collections import defaultdict

import numpy as np

from multiple_objects_gan_tpu_torch.io.pycompat import load_pickle

MAX_OBJECTS = 3
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


def write_synthetic_attngan(data_dir: str, n: int = 32, seed: int = 0,
                            captions_per_image: int = 5,
                            vocab: int = 50) -> None:
    """The JAX package's synthetic AttnGAN set, text side: the same text
    files, ``{filenames,bboxes,labels}.pickle`` of both splits (n train
    items, max(4, n // 4) test items) and so the same vocabulary, drawn
    from the same ``RandomState`` stream. Each caption names every object
    (``obj<label>``) and its cell of a 3x3 grid (``loc<gx><gy>``) in a
    random order, then 1-3 filler words (``word<i>``).

    The JAX writer also draws each item's 268x268 image and saves it as
    a JPEG. The draw (``rng.rand(268, 268, 3)``) is made here too, so the
    stream and every caption stay the same, but no image is written: the
    images wait for the JPEG reader."""
    rng = np.random.RandomState(seed)
    words = [f"word{i}" for i in range(vocab)]
    os.makedirs(os.path.join(data_dir, "text"), exist_ok=True)
    for split, count in [("train", n), ("test", max(4, n // 4))]:
        split_dir = os.path.join(data_dir, split)
        os.makedirs(split_dir, exist_ok=True)
        filenames, bboxes, labels = [], [], []
        for i in range(count):
            key = f"{split}_{i:05d}"
            rng.rand(268, 268, 3)      # the JAX writer's image draw
            filenames.append(key)
            n_obj = rng.randint(1, MAX_OBJECTS + 1)
            bb = np.full((MAX_OBJECTS, 4), -1.0, np.float32)
            lab = np.full((MAX_OBJECTS, 1), -1, np.int64)
            obj_tokens = []
            for j in range(n_obj):
                w, h = rng.uniform(0.2, 0.4, 2)
                bb[j] = [rng.uniform(0, 1 - w), rng.uniform(0, 1 - h), w, h]
                lab[j] = rng.randint(0, 80)
                gx = min(int((bb[j][0] + bb[j][2] / 2) * 3), 2)
                gy = min(int((bb[j][1] + bb[j][3] / 2) * 3), 2)
                obj_tokens.append(f"obj{int(lab[j, 0])} loc{gx}{gy}")
            cap_lines = []
            for _ in range(captions_per_image):
                order = rng.permutation(n_obj)
                toks = [obj_tokens[j] for j in order]
                toks += list(rng.choice(words, rng.randint(1, 4)))
                cap_lines.append(" ".join(toks))
            with open(os.path.join(data_dir, "text", key + ".txt"), "w") as f:
                f.write("\n".join(cap_lines))
            bboxes.append(bb)
            labels.append(lab)
        for name, obj in [("filenames.pickle", filenames),
                          ("bboxes.pickle", np.stack(bboxes)),
                          ("labels.pickle", np.stack(labels))]:
            with open(os.path.join(split_dir, name), "wb") as f:
                pickle.dump(obj, f)
