"""The on-disk Multi-MNIST and CLEVR sets, their writers and the batch
loaders (the port's copy of the JAX package's ``data/datasets.py``).

Formats, as the reference's pipelines read them:

* Multi-MNIST (code/multi-mnist/miscc/datasets.py:25-86):
  ``<data_dir>/<split>/normal/{filenames,bboxes,labels}.pickle`` and
  ``imgs/*.png``; the labels are per-object one-hot rows (3, 10).
* CLEVR (code/clevr/miscc/datasets.py:44-145): ``<data_dir>/<split>/
  images/*.png`` and ``scenes/*.json``; boxes over the image size, padded
  with -1 to 4 objects; shape and colour one-hots; a random h-flip mirrors
  the box x (x' = 1 - x - w).

Images are decoded by the port's own PNG reader (``data/png.py``) to uint8
and travel as uint8; the model's normalise to [-1, 1] runs on the device
(``utils/images.py:as_model_image``). :class:`Loader` is the JAX package's
shuffled, drop-last batcher with a prefetch thread (the COCO readers of
``data/coco.py`` and ``data/attngan.py`` decode in it);
:class:`MemoryLoader` batches a set held on the device in the same order,
for tests and timed steps. Both take the JAX loader's ``shard=(rank,
world)``: every rank shuffles the same seeded order and takes
``order[rank::world]``, ``len(ds) // world // batch`` batches an epoch, so
that every rank runs the same number of steps (``parallel/multihost.py:
shard_loader_kwargs`` gives a rank its share of the global batch and its
shard). The JAX loader's native-decoder ``workers`` are not ported: the
card decodes with nvjpeg.
"""

from __future__ import annotations

import json
import os
import pickle
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from multiple_objects_gan_tpu_torch.data.png import read_png, resize_bilinear
from multiple_objects_gan_tpu_torch.data.synthetic import (
    clevr_item, clevr_scenes, synthetic_multimnist)
from multiple_objects_gan_tpu_torch.io.pycompat import load_pickle
from multiple_objects_gan_tpu_torch.utils.images import png_bytes

MNIST_VARIANT = "normal"    # the reference's Multi-MNIST set directory
PREFETCH = 2                # batches the Loader's thread assembles ahead


def _load_image(path: str, channels: int, imsize: int | None = None
                ) -> np.ndarray:
    """A PNG as uint8 (H, W, channels), resized to imsize x imsize with
    PIL's bilinear filter when given and different."""
    img = read_png(path, "L" if channels == 1 else "RGB")
    if imsize is not None and img.shape[:2] != (imsize, imsize):
        img = resize_bilinear(img, (imsize, imsize))
    return img[..., None] if channels == 1 else img


class MultiMnistDataset:
    """Multi-MNIST pickles and image directory (reference format). The
    whole split is decoded once, at imsize, and batches are slices of it
    (64x64 gray is 4 KB an image)."""

    max_objects = 3
    label_dim = 10
    channels = 1

    def __init__(self, data_dir: str, split: str = "train", imsize: int = 64):
        self.split_dir = os.path.join(data_dir, split, MNIST_VARIANT)
        self.img_dir = os.path.join(self.split_dir, "imgs")
        self.imsize = imsize
        self.filenames = load_pickle(
            os.path.join(self.split_dir, "filenames.pickle"))
        self.bboxes = np.array(
            load_pickle(os.path.join(self.split_dir, "bboxes.pickle")),
            dtype=np.float32)
        self.labels = np.array(
            load_pickle(os.path.join(self.split_dir, "labels.pickle")),
            dtype=np.float32)
        self._cache = np.stack([self._image(i) for i in range(len(self))])

    def __len__(self) -> int:
        return len(self.filenames)

    def _image(self, idx: int) -> np.ndarray:
        name = str(self.filenames[idx]).split("/")[-1]
        return _load_image(os.path.join(self.img_dir, name), self.channels,
                           self.imsize)

    def __getitem__(self, idx: int) -> dict:
        return {"image": self._cache[idx], "bbox": self.bboxes[idx],
                "label_onehot": self.labels[idx]}

    def get_batch(self, idxs) -> dict:
        return {"image": self._cache[idxs], "bbox": self.bboxes[idxs],
                "label_onehot": self.labels[idxs]}


class ClevrDataset:
    """CLEVR images and ``scenes/*.json`` (reference format). The h-flip
    draws one ``rand()`` a visit from ``RandomState(seed)``, in the order
    the items are visited, before the resize to imsize."""

    max_objects = 4
    label_dim = 13
    channels = 3

    def __init__(self, data_dir: str, split: str = "train",
                 imsize: int = 64, hflip: bool = True, seed: int = 0):
        self.img_dir = os.path.join(data_dir, split, "images")
        scene_dir = os.path.join(data_dir, split, "scenes")
        self.imsize = imsize
        self.hflip = hflip
        self._rng = np.random.RandomState(seed)
        self.scenes = sorted(
            os.path.join(scene_dir, f) for f in os.listdir(scene_dir)
            if f.endswith(".json"))

    def __len__(self) -> int:
        return len(self.scenes)

    def __getitem__(self, idx: int) -> dict:
        with open(self.scenes[idx]) as f:
            scene = json.load(f)
        img = _load_image(
            os.path.join(self.img_dir, scene["image_filename"]), 3)
        bbox, label = clevr_item(scene["objects"], img.shape[:2])
        if self.hflip and self._rng.rand() < 0.5:
            img = img[:, ::-1].copy()
            valid = bbox[:, 0] >= 0
            bbox[valid, 0] = 1.0 - bbox[valid, 0] - bbox[valid, 2]
        if img.shape[:2] != (self.imsize, self.imsize):
            img = resize_bilinear(img, (self.imsize, self.imsize))
        return {"image": img, "bbox": bbox, "label_onehot": label}


class Loader:
    """Shuffled (``seed + epoch``; in order without ``shuffle``), drop-last
    batches of numpy arrays, assembled by a prefetch thread ``PREFETCH``
    batches ahead. An error in the thread is raised in the consumer.

    A set on a card (``dataset.device``, the COCO readers) is read on a
    CUDA stream of the thread's own, so that its decodes and copies wait
    for the reader's work alone and not for the train step queued on the
    consumer's stream; the consumer's stream waits for each batch on an
    event. ``shard=(rank, world)`` takes the rank's strided slice of the
    order (module docstring)."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 shuffle: bool = True, shard: tuple = (0, 1)):
        self.ds = dataset
        self.bs = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.shard = shard

    def __len__(self) -> int:
        return len(self.ds) // self.shard[1] // self.bs

    def epoch(self, epoch_idx: int = 0) -> Iterator[dict]:
        order = _shard_order(len(self.ds), self.seed + epoch_idx,
                             self.shuffle, self.shard)
        n_batches = len(self)
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        get_batch = getattr(self.ds, "get_batch", None)
        device = torch.device(getattr(self.ds, "device", None) or "cpu")
        stream = (torch.cuda.Stream(device) if device.type == "cuda"
                  else None)

        def read(idxs):
            if get_batch is not None:
                return get_batch(idxs)
            items = [self.ds[int(i)] for i in idxs]
            return {k: np.stack([it[k] for it in items]) for k in items[0]}

        def worker():
            try:
                for b in range(n_batches):
                    idxs = order[b * self.bs:(b + 1) * self.bs]
                    if stream is None:
                        q.put((read(idxs), None))
                        continue
                    with torch.cuda.stream(stream):
                        batch = read(idxs)
                        done = torch.cuda.Event()
                        done.record(stream)
                    q.put((batch, done))
                q.put(None)
            except Exception as e:  # noqa: BLE001 - raised in the consumer
                q.put(e)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            batch, done = item
            if done is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(done)
                for v in batch.values():
                    if isinstance(v, torch.Tensor) and v.is_cuda:
                        # the allocator keeps the block until the consumer's
                        # queued work is done with it
                        v.record_stream(consumer)
            yield batch


def _shard_order(n: int, seed: int, shuffle: bool, shard: tuple
                 ) -> np.ndarray:
    """The items of an epoch: ``arange(n)``, shuffled by
    ``RandomState(seed)`` when asked, and of it ``shard``'s strided slice
    (JAX ``Loader.epoch``)."""
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    rank, world = shard
    return order[rank::world] if world > 1 else order


class MemoryLoader:
    """A set held on ``device`` (arrays keyed ``image``, ``bbox``,
    ``label_onehot`` and, for COCO, ``text_embedding`` (n, captions, dim)),
    batched in :class:`Loader`'s order, ``shard`` too. Each epoch gives
    every item one of its captions, drawn from ``RandomState(seed)``
    carried across epochs, as the JAX COCO reader draws one a visit
    (``data/coco.py:102-103``)."""

    def __init__(self, data: dict, batch_size: int, seed: int = 0,
                 device="cpu", shard: tuple = (0, 1)):
        self.tensors = {k: torch.as_tensor(v).to(device)
                        for k, v in data.items()}
        self.captions = self.tensors.pop("text_embedding", None)
        self._caption_rng = np.random.RandomState(seed)
        self.n = self.tensors["image"].shape[0]
        self.bs = batch_size
        self.seed = seed
        self.shard = shard

    def __len__(self) -> int:
        return self.n // self.shard[1] // self.bs

    def epoch(self, epoch_idx: int = 0) -> Iterator[dict]:
        device = self.tensors["image"].device
        order = torch.from_numpy(_shard_order(
            self.n, self.seed + epoch_idx, True, self.shard)).to(device)
        tensors = dict(self.tensors)
        if self.captions is not None:
            pick = self._caption_rng.randint(self.captions.shape[1],
                                             size=self.n)
            tensors["text_embedding"] = self.captions[
                torch.arange(self.n, device=device),
                torch.from_numpy(pick).to(device)]
        for i in range(len(self)):
            idx = order[i * self.bs:(i + 1) * self.bs]
            yield {k: v.index_select(0, idx) for k, v in tensors.items()}


def write_synthetic_multimnist(data_dir: str, n: int = 256,
                               split: str = "train", seed: int = 0,
                               imsize: int = 64) -> None:
    """The JAX ``write_synthetic_multimnist`` set (the draws of
    ``data/synthetic.py:synthetic_multimnist``): ``<split>/normal/imgs/
    synthetic_NNNNN.png`` and the three pickles."""
    data = synthetic_multimnist(n, seed=seed, imsize=imsize)
    split_dir = os.path.join(data_dir, split, MNIST_VARIANT)
    img_dir = os.path.join(split_dir, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    filenames = [f"synthetic_{i:05d}.png" for i in range(n)]
    for name, img in zip(filenames, data["image"]):
        with open(os.path.join(img_dir, name), "wb") as f:
            f.write(png_bytes(img))
    for key, value in (("filenames", filenames), ("bboxes", data["bbox"]),
                       ("labels", data["label_onehot"])):
        with open(os.path.join(split_dir, f"{key}.pickle"), "wb") as f:
            pickle.dump(value, f)


def write_synthetic_clevr(data_dir: str, n: int = 128, split: str = "train",
                          seed: int = 0, imsize: int = 64) -> None:
    """The JAX ``write_synthetic_clevr`` set (the draws of
    ``data/synthetic.py:clevr_scenes``): ``<split>/images/CLEVR_<split>_
    NNNNNN.png`` and a ``scenes/*.json`` for each."""
    img_dir = os.path.join(data_dir, split, "images")
    scene_dir = os.path.join(data_dir, split, "scenes")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(scene_dir, exist_ok=True)
    for i, (img, objects) in enumerate(clevr_scenes(n, seed, imsize)):
        name = f"CLEVR_{split}_{i:06d}.png"
        with open(os.path.join(img_dir, name), "wb") as f:
            f.write(png_bytes(img))
        with open(os.path.join(scene_dir, name.replace(".png", ".json")),
                  "w") as f:
            json.dump({"image_filename": name, "objects": objects}, f)
