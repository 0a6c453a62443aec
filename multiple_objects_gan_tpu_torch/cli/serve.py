"""Serving endpoint of the port: layout -> image over HTTP, on the card.

The PyTorch counterpart of the JAX package's ``cli/serve.py`` for the
Stage-1 generators (multi-mnist, clevr, coco-stackgan-1), COCO StackGAN
stage 2 (256px) and COCO AttnGAN (free-text captions, 256px): a
micro-batcher coalesces concurrent requests into device batches of a
fixed size (``--max_batch``, default ``MAX_BATCH`` 64), each batch is one
eval-mode ``Stage1G`` forward (stage 2: the frozen stage-1 G, then
``Stage2G``; AttnGAN: the DAMSM text encoder, then ``GNet``), whose object
pathways place their objects with the CUDA kernel of
``ops/stn_place_cuda.py``.

HTTP API (stdlib http.server, threaded):
  POST /generate  {"items": [{"labels": [3], "bboxes": [[x, y, w, h]]}]}
                  -> {"images": [base64 png, ...]}
                  a label is a class id or a label_dim-long row (clevr's
                  two-hot shape + colour rows); coco-stackgan-1/2 items
                  also carry "text_embedding", exactly 1024 values, and
                  coco-stackgan-2 items may carry "bboxes_s2", the boxes of
                  its 256px object pathway (default: "bboxes");
                  coco-attngan items carry "caption", free text, and up to
                  3 objects (a random layout without "labels"/"bboxes");
                  at most max_batch items a request, else a 400
  GET  /healthz   -> {"ok": true, "max_batch": N, ...}
  GET  /stats     -> batcher counters, device batches and K1 launches

Usage:
  python -m multiple_objects_gan_tpu_torch.cli.serve \
      --variant multi-mnist|clevr|coco-stackgan-1|coco-stackgan-2 \
      [--net_g G.pth] [--cfg CFG] [--device cuda] [--port 8000] \
      [--max_batch 64] [--max_wait_ms 5] [--bf16]
  python -m multiple_objects_gan_tpu_torch.cli.serve --variant coco-attngan \
      --cfg CFG --data_dir D [--img_dir I] [--net_g G.pth] [--bf16] ...

Without ``--cfg`` multi-mnist takes its preset and clevr, coco-stackgan-1
and coco-stackgan-2 the widths of the repository's ``cfg/clevr_eval.yml``,
``cfg/coco_s1_train.yml`` and ``cfg/coco_s2_eval.yml`` (``DEFAULT_CFGS``);
without ``--net_g`` (or a NET_G in the cfg) the generator gets the
reference's random init. Stage 2's NET_G is a reference STAGE2_G ``.pth``
(its ``STAGE1_G.`` part, when it has one, is the frozen G) or a port run
directory; the frozen G falls back on the cfg's STAGE1_G. coco-attngan
takes cfg/coco_attn_eval.yml without ``--cfg``, its vocabulary from the
data directory's captions (``--data_dir``, else the cfg's DATA_DIR), its
G from ``--net_g`` or TRAIN.NET_G and its text encoder from TRAIN.NET_E;
a missing file gives a WARNING and random weights, as in the JAX package.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional

import numpy as np
import torch

from multiple_objects_gan_tpu_torch import float32_policy, resolve_device
from multiple_objects_gan_tpu_torch.cli.stage2_runner import stage2_images
from multiple_objects_gan_tpu_torch.config.config import (
    attngan_model_config, cfg_from_file, stage1_model_config,
    stage2_model_config)
from multiple_objects_gan_tpu_torch.data.attngan import (
    AttnGanDataset, tokenize)
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.io.weights import (
    load_reference_attngan_g, load_reference_g, load_text_encoder,
    split_stage2_g)
from multiple_objects_gan_tpu_torch.models.attngan import (
    AttnGanConfig, build_attngan_g)
from multiple_objects_gan_tpu_torch.models.common import MNIST, Stage1Config
from multiple_objects_gan_tpu_torch.models.stage1 import build_stage1_g
from multiple_objects_gan_tpu_torch.models.stage2 import build_stage2_g
from multiple_objects_gan_tpu_torch.nn.encoders import build_text_encoder
from multiple_objects_gan_tpu_torch.ops import stn_place_cuda
from multiple_objects_gan_tpu_torch.train.step import make_sample_fn
from multiple_objects_gan_tpu_torch.utils.images import png_bytes, to_uint8

MAX_BATCH = 64              # the device batch without --max_batch
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
# the cfg each variant is served with when no --cfg is given (coco-stackgan-1:
# the stage-1 G's widths; coco_s1_eval.yml is the stage-2 sampler's)
DEFAULT_CFGS = {"multi-mnist": "",
                "clevr": os.path.join(ROOT, "cfg", "clevr_eval.yml"),
                "coco-stackgan-1": os.path.join(ROOT, "cfg",
                                                "coco_s1_train.yml"),
                "coco-stackgan-2": os.path.join(ROOT, "cfg",
                                                "coco_s2_eval.yml"),
                "coco-attngan": os.path.join(ROOT, "cfg",
                                             "coco_attn_eval.yml")}


def _max_batch(max_batch: Optional[int]) -> int:
    """A service's device batch: ``max_batch``, else ``MAX_BATCH`` (read
    when the service is built); at least 1."""
    b = MAX_BATCH if max_batch is None else int(max_batch)
    if b < 1:
        raise ValueError(f"max_batch must be at least 1, got {b}")
    return b


# ---------------------------------------------------------------------------
# micro-batcher


class _Pending:
    __slots__ = ("item", "event", "result", "error")

    def __init__(self, item):
        self.item = item
        self.event = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None


class MicroBatcher:
    """Coalesce concurrent single-item requests into device batches.

    ``run_batch(items) -> results`` is called on a dedicated worker
    thread with 1..max_batch items: the first queued item starts a
    batch, which then waits up to ``max_wait_ms`` for more before
    launching. Results (or the exception) fan back to the callers.
    """

    def __init__(self, run_batch: Callable[[list], list], max_batch: int,
                 max_wait_ms: float = 5.0):
        self._run_batch = run_batch
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "items": 0,
                      "batch_ms_total": 0.0}
        self._lock = threading.Lock()
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, item) -> Any:
        """Block until the batch containing ``item`` completes."""
        return self.submit_many([item])[0]

    def submit_many(self, items: list) -> list:
        """Enqueue all items at once (so one request's items share device
        batches) and block until every result is in."""
        pending = [_Pending(it) for it in items]
        with self._lock:
            self.stats["requests"] += len(pending)
        for p in pending:
            self._q.put(p)
        for p in pending:
            p.event.wait()
        for p in pending:
            if p.error is not None:
                raise p.error
        return [p.result for p in pending]

    def close(self):
        self._stop = True
        self._q.put(None)  # wake the worker
        self._thread.join(timeout=5)

    def _collect(self) -> list:
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _worker(self):
        while not self._stop:
            batch = self._collect()
            if not batch:
                continue
            t0 = time.monotonic()
            try:
                results = self._run_batch([p.item for p in batch])
                for p, r in zip(batch, results):
                    p.result = r
            except Exception as e:  # fan the failure out to all callers
                for p in batch:
                    p.error = e
            dt = (time.monotonic() - t0) * 1e3
            with self._lock:
                self.stats["batches"] += 1
                self.stats["items"] += len(batch)
                self.stats["batch_ms_total"] += dt
            for p in batch:
                p.event.set()

    def snapshot(self) -> dict:
        with self._lock:
            s = dict(self.stats)
        b = max(s["batches"], 1)
        s["avg_batch_fill"] = round(s["items"] / b, 2)
        s["avg_batch_ms"] = round(s["batch_ms_total"] / b, 2)
        s.pop("batch_ms_total")
        s["max_batch"] = self.max_batch
        return s


# ---------------------------------------------------------------------------
# model service


def _png_b64(img: np.ndarray) -> str:
    """[-1, 1] float image (H, W, C) -> base64 PNG."""
    return base64.b64encode(png_bytes(to_uint8(img))).decode("ascii")


def _item_layout(item: dict, max_objects: int, label_dim: int,
                 rs: np.random.RandomState):
    """(labels one-hot (O, L), bbox (O, 4)) from a request item; missing
    layout -> random; missing objects padded with bbox=-1 like the
    reference datasets."""
    labels = np.zeros((max_objects, label_dim), np.float32)
    bbox = np.full((max_objects, 4), -1.0, np.float32)
    ids = item.get("labels")
    boxes = item.get("bboxes")
    if ids is None and boxes is None:
        n = rs.randint(1, max_objects + 1)
        ids = rs.randint(0, label_dim, n).tolist()
        w = rs.uniform(0.2, 0.4, n)
        h = rs.uniform(0.2, 0.4, n)
        boxes = np.stack([rs.uniform(0, 1 - w), rs.uniform(0, 1 - h), w, h],
                         axis=-1).tolist()
    ids = list(ids or [])
    boxes = list(boxes or [])
    if len(ids) != len(boxes):
        raise ValueError("labels and bboxes must have the same length")
    if len(ids) > max_objects:
        raise ValueError(f"at most {max_objects} objects supported")
    for o, (lab, bb) in enumerate(zip(ids, boxes)):
        row = np.asarray(lab, np.float32).reshape(-1)
        if row.size == 1:  # class id -> one-hot
            if not (np.isfinite(row[0]) and 0 <= row[0] < label_dim):
                raise ValueError(f"label id {lab!r} is outside "
                                 f"[0, {label_dim})")
            labels[o, int(row[0])] = 1.0
        elif row.size == label_dim:
            labels[o] = row
        else:
            raise ValueError(f"label must be an id or a {label_dim}-d "
                             "one-hot")
        bbox[o] = _box(bb, "bbox")
    return labels, bbox


def _box(bb, what: str) -> np.ndarray:
    """One request box [x, y, w, h] as float32 (4,), else a ValueError (a
    400). A padded object (all -1) places nothing; any other box needs
    finite values and a positive size, or the place divides by zero."""
    box = np.asarray(bb, np.float32).reshape(-1)
    if box.size != 4:
        raise ValueError(f"{what} must be [x, y, w, h], got {bb!r}")
    if not (box == -1.0).all() and not (
            np.isfinite(box).all() and box[2] > 0 and box[3] > 0):
        raise ValueError(f"{what} {bb!r} needs finite values and w, h > 0")
    return box


def _item_text(item: dict, text_dim: int) -> np.ndarray:
    """The text embedding of a coco-stackgan-1 request item: exactly
    ``text_dim`` finite values, else a ValueError (a 400)."""
    emb = item.get("text_embedding")
    if emb is None:
        raise ValueError(f"items need a {text_dim}-d text_embedding")
    try:
        row = np.asarray(emb, np.float32).reshape(-1)
    except (TypeError, ValueError) as e:
        raise ValueError(f"text_embedding must be {text_dim} numbers") from e
    if row.size != text_dim:
        raise ValueError(f"text_embedding must have {text_dim} values, got "
                         f"{row.size}")
    if not np.isfinite(row).all():
        raise ValueError("text_embedding values must be finite")
    return row


class Stage1Service:
    """Stage-1 generation at ``max_batch`` (default ``MAX_BATCH``) on one
    device, for any of the
    three families (JAX ``cli/serve.py:Stage1Service``).

    ``net_g`` is a reference-format ``.pth``; without one the generator
    gets the reference's random init from ``seed``. The generator computes
    in ``mcfg.compute_dtype`` (bf16 with ``--bf16``); the images come back
    float32 either way. z comes from a ``torch.Generator`` seeded with
    ``seed``; under the CA net (coco-stackgan-1) each item's
    ``text_embedding`` gives the condition c = mu. The constructor runs one
    warm-up batch, so the first request pays neither the kernel build nor
    cuDNN's first-call set-up.
    """

    def __init__(self, mcfg: Stage1Config = MNIST, net_g: str = "",
                 seed: int = 0, device="cuda",
                 max_batch: Optional[int] = None):
        self.device = resolve_device(device)
        self.mcfg = mcfg
        self.max_batch = _max_batch(max_batch)
        state_dict = load_reference_g(net_g) if net_g else None
        self.weights = net_g or f"random init, seed {seed}"
        self.g = build_stage1_g(mcfg, state_dict, seed=seed,
                                device=self.device)
        self._sample = make_sample_fn(mcfg)
        self._rs = np.random.RandomState(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.device_batches = 0
        # the warm-up batch: stackgan needs a text embedding on every item
        self.run([{"text_embedding": [0.0] * mcfg.text_dim}
                  if mcfg.use_ca else {}])

    def validate(self, item: dict) -> None:
        """Raise ValueError for a malformed request item. Runs in the HTTP
        thread BEFORE the micro-batcher, so one client's bad item cannot
        fail the other requests coalesced into the same device batch."""
        _item_layout(item, self.mcfg.num_objects, self.mcfg.label_dim,
                     np.random.RandomState(0))
        if self.mcfg.use_ca:
            _item_text(item, self.mcfg.text_dim)

    def run(self, items: list) -> list:
        mc = self.mcfg
        b = self.max_batch
        labels = np.zeros((b, mc.num_objects, mc.label_dim), np.float32)
        bbox = np.full((b, mc.num_objects, 4), -1.0, np.float32)
        text = np.zeros((b, mc.text_dim), np.float32) if mc.use_ca else None
        for i, item in enumerate(items):
            labels[i], bbox[i] = _item_layout(item, mc.num_objects,
                                              mc.label_dim, self._rs)
            if text is not None:
                text[i] = _item_text(item, mc.text_dim)
        z = torch.randn((b, mc.z_dim), generator=self._gen,
                        device=self.device)
        img = self._sample(self.g, z, torch.from_numpy(bbox).to(self.device),
                           torch.from_numpy(labels).to(self.device),
                           None if text is None
                           else torch.from_numpy(text).to(self.device))
        imgs = img[:len(items)].permute(0, 2, 3, 1).cpu().numpy()
        self.device_batches += 1
        return [_png_b64(im) for im in imgs]

    def stats(self) -> dict:
        return {"device": str(self.device),
                "device_batches": self.device_batches,
                "k1_launches": stn_place_cuda.launch_count()}


def _item_boxes_s2(item: dict, bbox: np.ndarray) -> np.ndarray:
    """A stage-2 item's ``bboxes_s2`` (O, 4), the 256px object pathway's
    boxes: the item's ``bboxes`` layout (``bbox``) when absent, as the COCO
    reader gives them without a crop; else one [x, y, w, h] per box of
    ``bboxes``, checked as those are (a ValueError, a 400)."""
    boxes = item.get("bboxes_s2")
    if boxes is None:
        return bbox.copy()
    boxes = list(boxes)
    if len(boxes) != len(item.get("bboxes") or []):
        raise ValueError("bboxes_s2 must match bboxes in length")
    out = np.full_like(bbox, -1.0)
    for o, bb in enumerate(boxes):
        out[o] = _box(bb, "bboxes_s2 entry")
    return out


class Stage2Service:
    """COCO StackGAN stage 2 at ``max_batch`` on one device: 256px images,
    the paper's headline output (JAX ``cli/serve.py:Stage2Service``).

    Each device batch runs the frozen stage-1 G and then Stage2G, both in
    eval mode, with one fresh CA eps a batch given to both CA nets, as the
    JAX service passes its key as both ``ca_rng``, and z, both drawn from a
    ``torch.Generator`` seeded with ``seed``. Requests take the stage-1
    coco schema (``labels``, ``bboxes``, ``text_embedding``) and an
    optional ``bboxes_s2`` (:func:`_item_boxes_s2`).

    Weights: ``net_g`` a reference STAGE2_G ``.pth`` (its ``STAGE1_G.``
    part loads into the frozen G) or a port run directory (its latest
    checkpoint's G2); the frozen G otherwise from ``stage1_g``, a
    reference ``.pth``; either without a file gets the reference's random
    init from ``seed``. The constructor runs one warm-up batch.
    """

    def __init__(self, s1_cfg: Stage1Config, s2_cfg: Stage1Config,
                 net_g: str = "", stage1_g: str = "", seed: int = 0,
                 device="cuda", max_batch: Optional[int] = None):
        self.device = resolve_device(device)
        self.mcfg, self.s2_cfg = s1_cfg, s2_cfg
        self.max_batch = _max_batch(max_batch)
        random_init = f"random init, seed {seed}"
        s1_sd = load_reference_g(stage1_g) if stage1_g else None
        g1_src, s2_sd = stage1_g or random_init, None
        if net_g and os.path.isdir(net_g):
            s2_sd = CheckpointManager(os.path.join(net_g, "models")).load()[
                0]["g"]
        elif net_g:
            part1, s2_sd = split_stage2_g(load_reference_g(net_g))
            if part1 is not None:
                s1_sd, g1_src = part1, f"{net_g} (its STAGE1_G part)"
        self.weights = f"G2 {net_g or random_init}; G1 {g1_src}"
        self.g1 = build_stage1_g(s1_cfg, s1_sd, seed=seed,
                                 device=self.device)
        self.g2 = build_stage2_g(s2_cfg, s2_sd, seed=seed,
                                 device=self.device)
        self._rs = np.random.RandomState(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.device_batches = 0
        self.run([{"text_embedding": [0.0] * s1_cfg.text_dim}])

    def validate(self, item: dict) -> None:
        """Raise ValueError for a malformed item, before the batcher (see
        :meth:`Stage1Service.validate`)."""
        mc = self.mcfg
        _, bbox = _item_layout(item, mc.num_objects, mc.label_dim,
                               np.random.RandomState(0))
        _item_text(item, mc.text_dim)
        _item_boxes_s2(item, bbox)

    def run(self, items: list) -> list:
        mc, b = self.mcfg, self.max_batch
        labels = np.zeros((b, mc.num_objects, mc.label_dim), np.float32)
        bbox = np.full((b, mc.num_objects, 4), -1.0, np.float32)
        bbox_s2 = bbox.copy()
        text = np.zeros((b, mc.text_dim), np.float32)
        for i, item in enumerate(items):
            labels[i], bbox[i] = _item_layout(item, mc.num_objects,
                                              mc.label_dim, self._rs)
            bbox_s2[i] = _item_boxes_s2(item, bbox[i])
            text[i] = _item_text(item, mc.text_dim)
        z = torch.randn((b, mc.z_dim), generator=self._gen,
                        device=self.device)
        eps = torch.randn((b, mc.condition_dim), generator=self._gen,
                          device=self.device)
        batch = {k: torch.from_numpy(v).to(self.device) for k, v in (
            ("bbox", bbox), ("bbox_s2", bbox_s2), ("label_onehot", labels),
            ("text_embedding", text))}
        img = stage2_images(self.g1, self.g2, z, batch, eps)
        imgs = img[:len(items)].permute(0, 2, 3, 1).cpu().numpy()
        self.device_batches += 1
        return [_png_b64(im) for im in imgs]

    def stats(self) -> dict:
        return {"device": str(self.device),
                "device_batches": self.device_batches,
                "k1_launches": stn_place_cuda.launch_count()}


def attngan_images(text_enc, g, caps: torch.Tensor, lens: torch.Tensor,
                   bbox: torch.Tensor, labels: torch.Tensor,
                   z: torch.Tensor) -> torch.Tensor:
    """The JAX AttnGanService's ``gen``: the text encoder's word and
    sentence embeddings of ``caps`` (B, T) at ``lens`` (B,), then the
    generator with the mask ``caps == 0`` and c = mu; returns the last
    branch's image (B, 3, 256, 256) in float32."""
    with torch.inference_mode():
        words, sent = text_enc(caps, lens)
        return g(z, sent, words, caps == 0, bbox, labels).float()


def _read_weights(path: str, name: str, kind: str, load, what: str,
                  warning: str):
    """The state dict ``load`` reads from the file ``path``. A ``path``
    that is empty or does not exist prints the JAX package's WARNING and
    gives None: the caller takes random weights. An existing path that is
    not a readable ``kind`` ``.pth`` raises ValueError: the port reads no
    other format (not a JAX run directory, which the JAX runner restores
    with its checkpoint manager)."""
    if not path or not os.path.exists(path):
        print(f"WARNING: {name}={path!r} not found — {warning}", flush=True)
        return None
    if not os.path.isfile(path):
        raise ValueError(f"{name}={path!r} is not a file: the port reads "
                         f"only a reference-format {kind} .pth")
    try:
        sd = load(path)
    except Exception as e:
        raise ValueError(f"{name}={path!r} is not a reference-format {kind} "
                         f".pth ({type(e).__name__}: {e})") from e
    print(f"Load {what} from: {path}", flush=True)
    return sd


class AttnGanService:
    """COCO AttnGAN at ``max_batch`` on one device: free-text caption and
    layout -> 256px image (JAX ``cli/serve.py:AttnGanService``).

    The vocabulary is the data directory's (``data/attngan.py:
    AttnGanDataset``, its test split). A caption is tokenized, its
    in-vocabulary words kept, and cut at ``words_num``; a caption with none
    takes the largest word id, as the JAX service does. Each device batch
    runs the DAMSM text encoder, then GNet in eval mode with c = mu; z
    comes from a ``torch.Generator`` seeded with ``seed``.

    Weights: ``net_g`` a reference-format G_NET ``.pth`` (``netG``),
    ``net_e`` a DAMSM ``text_encoder*.pth``; either missing prints the JAX
    package's WARNING and takes random weights from ``seed`` (AttnGAN's
    orthogonal init; the encoder's uniform one), and either naming
    anything else raises (:func:`_read_weights`). The generator computes
    in ``mcfg.compute_dtype``; the text encoder and the word attention
    stay float32. The constructor runs one warm-up batch.
    """

    def __init__(self, mcfg: AttnGanConfig, data_dir: str, net_g: str = "",
                 net_e: str = "", words_num: int = 12,
                 captions_per_image: int = 5, seed: int = 0,
                 device="cuda", max_batch: Optional[int] = None):
        self.device = resolve_device(device)
        self.mcfg, self.words_num = mcfg, int(words_num)
        self.max_batch = _max_batch(max_batch)
        ds = AttnGanDataset(data_dir, split="test",
                            captions_per_image=captions_per_image)
        self.wordtoix = ds.wordtoix
        self.max_word = max(self.wordtoix.values())
        e_sd = _read_weights(net_e, "NET_E", "DAMSM text_encoder",
                             load_text_encoder, "text encoder",
                             "DAMSM encoders use random weights")
        self.text_enc = build_text_encoder(ds.n_words, mcfg.embedding_dim,
                                           e_sd, seed=seed,
                                           device=self.device)
        g_sd = _read_weights(net_g, "TRAIN.NET_G", "G_NET",
                             load_reference_attngan_g, "G",
                             "G uses random weights")
        self.g = build_attngan_g(mcfg, g_sd, seed=seed, device=self.device)
        random_init = f"random init, seed {seed}"
        self.weights = (f"G {net_g if g_sd is not None else random_init}; "
                        f"text encoder "
                        f"{net_e if e_sd is not None else random_init}")
        self._rs = np.random.RandomState(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.device_batches = 0
        self.run([{"caption": "a"}])       # warm-up, as the JAX service

    def validate(self, item: dict) -> None:
        """Raise ValueError for a malformed item, before the batcher (see
        :meth:`Stage1Service.validate`)."""
        if not isinstance(item.get("caption", ""), str):
            raise ValueError("caption must be a string")
        _item_layout(item, self.mcfg.num_objects, self.mcfg.label_dim,
                     np.random.RandomState(0))

    def token_ids(self, caption: str) -> list[int]:
        """The caption's in-vocabulary word ids, at most ``words_num``; the
        largest id when it has none (the JAX service's all-OOV rule)."""
        ids = [self.wordtoix[w] for w in tokenize(caption.lower())
               if w in self.wordtoix]
        return (ids or [self.max_word])[:self.words_num]

    def batch(self, items: list) -> dict:
        """A device batch's inputs as numpy arrays, ``max_batch`` rows:
        ``caps`` (zero-padded ids), ``lens`` (1 for the padding rows),
        ``label_onehot`` and ``bbox`` (items without a layout draw one
        from the service's RandomState)."""
        b, mc = self.max_batch, self.mcfg
        out = {"caps": np.zeros((b, self.words_num), np.int64),
               "lens": np.ones((b,), np.int64),
               "label_onehot": np.zeros((b, mc.num_objects, mc.label_dim),
                                        np.float32),
               "bbox": np.full((b, mc.num_objects, 4), -1.0, np.float32)}
        for i, item in enumerate(items):
            ids = self.token_ids(str(item.get("caption", "")))
            out["caps"][i, :len(ids)] = ids
            out["lens"][i] = len(ids)
            out["label_onehot"][i], out["bbox"][i] = _item_layout(
                item, mc.num_objects, mc.label_dim, self._rs)
        return out

    def draw_z(self) -> torch.Tensor:
        return torch.randn((self.max_batch, self.mcfg.z_dim),
                           generator=self._gen, device=self.device)

    def run(self, items: list) -> list:
        arr = self.batch(items)
        t = {k: torch.from_numpy(v).to(self.device) for k, v in arr.items()
             if k != "lens"}
        img = attngan_images(self.text_enc, self.g, t["caps"],
                             torch.from_numpy(arr["lens"]), t["bbox"],
                             t["label_onehot"], self.draw_z())
        imgs = img[:len(items)].permute(0, 2, 3, 1).cpu().numpy()
        self.device_batches += 1
        return [_png_b64(im) for im in imgs]

    def stats(self) -> dict:
        return {"device": str(self.device),
                "device_batches": self.device_batches,
                "k1_launches": stn_place_cuda.launch_count()}


# ---------------------------------------------------------------------------
# HTTP layer


def make_handler(batcher: MicroBatcher, info: dict, validate=None,
                 extra_stats: Optional[Callable[[], dict]] = None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, **info})
            elif self.path == "/stats":
                extra = extra_stats() if extra_stats is not None else {}
                self._json(200, {**batcher.snapshot(), **extra})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                return self._json(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                items = req.get("items", [{}])
                if not isinstance(items, list) or not items:
                    raise ValueError("items must be a non-empty list")
                if len(items) > batcher.max_batch:
                    raise ValueError(
                        f"at most {batcher.max_batch} items per request")
                if validate is not None:
                    for it in items:  # reject HERE, not inside the shared
                        validate(it)  # device batch (one bad item must not
                                      # fail other clients' requests)
                self._json(200, {"images": batcher.submit_many(items)})
            except ValueError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # keep serving; report the failure
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def build_service(args):
    """The service the CLI arguments name: the model config and NET_G of
    ``--cfg`` (or of the variant's ``DEFAULT_CFGS`` entry; the MNIST preset
    for multi-mnist); ``--net_g`` wins over the YAML, ``--bf16`` makes
    the generators compute in bf16, and ``--max_batch`` sets the device
    batch (``MAX_BATCH`` without it). coco-stackgan-2 gives a
    :class:`Stage2Service`, with the cfg's STAGE1_G for the frozen G;
    coco-attngan an :class:`AttnGanService` on ``--data_dir`` (else the
    cfg's DATA_DIR)."""
    dt = torch.bfloat16 if getattr(args, "bf16", False) else None
    mb = getattr(args, "max_batch", None)
    mcfg, net_g = dataclasses.replace(MNIST, compute_dtype=dt), args.net_g
    path = args.cfg or DEFAULT_CFGS[args.variant]
    if not path:
        return Stage1Service(mcfg, net_g, seed=args.seed,
                             device=args.device, max_batch=mb)
    cfg = cfg_from_file(path, args.variant)
    if args.variant == "coco-attngan":
        # as the JAX service: TRAIN.NET_G and TRAIN.NET_E whatever the cfg
        return AttnGanService(
            attngan_model_config(cfg, compute_dtype=dt),
            args.data_dir or cfg.DATA_DIR, net_g or cfg.TRAIN.NET_G,
            cfg.TRAIN.NET_E, words_num=cfg.TEXT.WORDS_NUM,
            captions_per_image=cfg.TEXT.CAPTIONS_PER_IMAGE, seed=args.seed,
            device=args.device, max_batch=mb)
    # a cfg's NET_G and STAGE1_G are served only when its --cfg names them:
    # the default cfgs' are paths of the reference's own layout
    net_g = net_g or (cfg.NET_G if args.cfg else "")
    if args.variant == "coco-stackgan-2":
        s1_cfg, s2_cfg = stage2_model_config(cfg, compute_dtype=dt)
        return Stage2Service(s1_cfg, s2_cfg, net_g,
                             cfg.STAGE1_G if args.cfg else "",
                             seed=args.seed, device=args.device,
                             max_batch=mb)
    mcfg = stage1_model_config(cfg, args.variant, compute_dtype=dt)
    return Stage1Service(mcfg, net_g, seed=args.seed, device=args.device,
                         max_batch=mb)


def serve(args, service=None) -> ThreadingHTTPServer:
    """Build the service (unless given) and batcher and return a bound,
    unstarted server; the CLI calls serve_forever, tests and chip_smoke.py
    drive it from a thread. A float32 service of any variant on the card
    turns TF32 off for matmuls and cuDNN in the process, so that float32
    serving computes in float32 (the JAX package's float32 path;
    ``float32_policy``)."""
    svc = service if service is not None else build_service(args)
    float32_policy(svc.device, svc.mcfg.compute_dtype)
    batcher = MicroBatcher(svc.run, max_batch=svc.max_batch,
                           max_wait_ms=args.max_wait_ms)
    info = {"variant": args.variant, "max_batch": svc.max_batch,
            "device": str(svc.device), "weights": svc.weights,
            "bf16": svc.mcfg.compute_dtype == torch.bfloat16}
    httpd = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(batcher, info, validate=svc.validate,
                     extra_stats=svc.stats))
    httpd.batcher = batcher
    httpd.service = svc
    return httpd


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--variant", required=True, choices=sorted(DEFAULT_CFGS))
    p.add_argument("--cfg", default="",
                   help="reference YAML (cfg/mnist_eval.yml, ...); default: "
                        "the Multi-MNIST preset, cfg/clevr_eval.yml, "
                        "cfg/coco_s1_train.yml, cfg/coco_s2_eval.yml, "
                        "cfg/coco_attn_eval.yml")
    p.add_argument("--net_g", default="",
                   help="reference-format .pth (overrides the YAML's "
                        "NET_G; coco-stackgan-2: a STAGE2_G .pth or a port "
                        "run directory; coco-attngan: a G_NET .pth, over "
                        "TRAIN.NET_G); default: random init from --seed")
    p.add_argument("--data_dir", default="",
                   help="coco-attngan: the set whose captions give the "
                        "vocabulary (default: the cfg's DATA_DIR)")
    p.add_argument("--img_dir", default="",
                   help="coco-attngan: accepted as the JAX CLI takes it; "
                        "serving reads no image")
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=MAX_BATCH,
                   help="the device batch and the most items a request "
                        "may carry (default %(default)s)")
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="run the generator in bf16 (float32 weights and "
                        "running statistics, float32 images out); "
                        "without it every variant computes in float32, "
                        "TF32 off on the card")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    httpd = serve(args)
    print(f"serving {args.variant} on http://{args.host}:"
          f"{httpd.server_address[1]} on {httpd.service.device} "
          f"(max_batch={httpd.service.max_batch}, max_wait={args.max_wait_ms}ms, "
          f"weights: {httpd.service.weights})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        httpd.batcher.close()


if __name__ == "__main__":
    main()
