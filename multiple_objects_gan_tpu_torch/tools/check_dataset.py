"""First-contact diagnostics for a dataset directory (the port's counterpart
of the JAX package's ``tools/check_dataset.py``).

    python -m multiple_objects_gan_tpu_torch.tools.check_dataset \\
        {mnist|clevr|coco-stackgan|coco-attngan} DATA_DIR \\
        [--img_dir DIR] [--split train] [--sample_images N] \\
        [--device cuda|cpu]

When the published data (py2 cPickle files; formats at
code/multi-mnist/miscc/datasets.py:25-86, code/clevr/miscc/datasets.py:
44-145, code/coco/stackgan/miscc/datasets.py:25-217,
code/coco/attngan/datasets.py:214-303) first lands, a failure should be a
diagnosis, not a traceback. Per variant: files present, pickles
decodable (``io/pycompat.py:load_pickle_diag`` reports the decode stage),
shapes, dtypes and ranges, boxes, and images present and decodable.

Images are read as the port's readers read them, without PIL: the mode
(``L``, ``RGB``, ``P``, ``RGBA``; ``CMYK``) comes from the PNG's colour type
or the JPEG's component count, and the first ``--sample_images`` are
decoded, PNGs by ``data/png.py``, JPEGs by nvjpeg on the card
(``data/nvjpeg.py``; the default, which raises without a card) or by the
numpy codec ``data/jpeg.py`` with ``--device cpu``. A file the decoder
refuses is an error naming the file; nothing falls back to another codec.

Prints one JSON line:
  {"variant": V, "data_dir": D, "split": S, "ok": bool, "errors": [...],
   "warnings": [...], "report": {...}}
and exits 0 iff ok. The checks, their verdicts and the report's fields are
the JAX tool's; the wording of a message may differ.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from multiple_objects_gan_tpu_torch import resolve_device
from multiple_objects_gan_tpu_torch.data.datasets import MNIST_VARIANT
from multiple_objects_gan_tpu_torch.data.jpeg import decode_jpeg, probe_jpeg
from multiple_objects_gan_tpu_torch.data.nvjpeg import decode_nvjpeg
from multiple_objects_gan_tpu_torch.data.png import decode_png
from multiple_objects_gan_tpu_torch.data.synthetic import (
    CLEVR_COLORS, CLEVR_SHAPES)
from multiple_objects_gan_tpu_torch.io.pycompat import load_pickle_diag
from multiple_objects_gan_tpu_torch.utils.images import PNG_SIGNATURE

PNG_MODES = {0: "L", 2: "RGB", 3: "P", 6: "RGBA"}     # colour type -> mode
JPEG_MODES = {1: "L", 3: "RGB", 4: "CMYK"}            # components -> mode
MODE_BANDS = {"L": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}


class Check:
    """Collects errors, warnings and report fields; never raises on bad
    data."""

    def __init__(self, device: torch.device):
        self.device = device
        self.errors: list = []
        self.warnings: list = []
        self.report: dict = {}

    def error(self, msg: str):
        self.errors.append(msg)

    def warn(self, msg: str):
        self.warnings.append(msg)

    def load_pickle(self, path: str, name: str):
        """-> object or None (error recorded). Reports the decode stage."""
        if not os.path.isfile(path):
            self.error(f"{name}: missing file {path}")
            return None
        try:
            obj, stage = load_pickle_diag(path)
        except Exception as e:  # noqa: BLE001 — a diagnostic tool
            self.error(f"{name}: undecodable pickle {path}: "
                       f"{type(e).__name__}: {e}")
            return None
        self.report[f"{name}_pickle_encoding"] = stage
        return obj


def _summary(name: str, arr, ck: Check) -> np.ndarray | None:
    try:
        a = np.asarray(arr)
    except Exception as e:  # noqa: BLE001
        ck.error(f"{name}: not array-convertible: {e}")
        return None
    ck.report[name] = {"shape": list(a.shape), "dtype": str(a.dtype)}
    if a.dtype.kind in "fiu" and a.size:
        ck.report[name]["min"] = float(a.min())
        ck.report[name]["max"] = float(a.max())
        if a.dtype.kind == "f" and not np.isfinite(a).all():
            ck.error(f"{name}: contains non-finite values")
    return a


def _check_bboxes(bb: np.ndarray, ck: Check, pad_allowed: bool):
    """Box rows are [x, y, w, h] normalized; -1 rows are pads."""
    if bb is None or bb.ndim != 3 or bb.shape[-1] != 4:
        ck.error(f"bboxes: expected (N, O, 4), got "
                 f"{None if bb is None else bb.shape}")
        return
    flat = bb.reshape(-1, 4)
    pads = flat[:, 0] < 0
    if pads.any() and not pad_allowed:
        ck.error("bboxes: -1 pad rows present but variant has none")
    real = flat[~pads]
    if real.size == 0:
        ck.error("bboxes: no real (non-pad) boxes")
        return
    if (real < -1e-6).any() or (real > 1 + 1e-6).any():
        ck.error(f"bboxes: values outside [0, 1] "
                 f"(min {real.min():.3f}, max {real.max():.3f}) — "
                 "are they normalized by image size?")
    over = (real[:, 0] + real[:, 2] > 1 + 1e-3).mean() + \
        (real[:, 1] + real[:, 3] > 1 + 1e-3).mean()
    if over > 0.02:
        ck.warn(f"bboxes: {over * 100:.1f}% extend past the right/bottom "
                "edge (x+w or y+h > 1)")
    if (real[:, 2:] <= 0).any():
        ck.error("bboxes: non-positive width/height in real rows")
    ck.report["bboxes"]["pad_fraction"] = float(pads.mean())


def read_image(path: str, device) -> tuple[tuple[int, int], str]:
    """Decode the PNG or JPEG at ``path`` as the port's readers do and
    return its (width, height) and mode; raises ``ValueError`` (or the
    card decoder's ``NvjpegError``) for a file the decoder refuses."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        pixels, ctype, _ = decode_png(data)
        return (pixels.shape[1], pixels.shape[0]), PNG_MODES[ctype]
    h, w, comps = probe_jpeg(data, path)
    if device.type == "cuda":
        decode_nvjpeg(data, path, device)
    else:
        decode_jpeg(data, path)
    return (w, h), JPEG_MODES.get(comps, f"{comps} components")


def _check_images(paths: list, ck: Check, n: int, channels: int):
    missing = [p for p in paths[:200] if not os.path.isfile(p)]
    if missing:
        ck.error(f"images: {len(missing)}/{min(len(paths), 200)} sampled "
                 f"paths missing (first: {missing[0]})")
        return
    sizes, modes = set(), set()
    for p in paths[:n]:
        try:
            size, mode = read_image(p, ck.device)
        except Exception as e:  # noqa: BLE001
            ck.error(f"images: undecodable {p}: {e}")
            return
        sizes.add(size)
        modes.add(mode)
    bad = sorted(m for m in modes if MODE_BANDS.get(m) != channels)
    if bad:
        # the readers convert anyway, so a mode mismatch is survivable, but
        # e.g. grayscale files in a COCO directory usually mean a wrong one
        ck.warn(f"images: sampled modes {bad} have != {channels} channels "
                f"(expected {channels} for this variant)")
    ck.report["image_sizes_sampled"] = sorted(map(list, sizes))
    ck.report["image_modes_sampled"] = sorted(modes)
    ck.report["images_sampled"] = min(len(paths), n)


def check_mnist(data_dir: str, img_dir: str, split: str, n_img: int,
                ck: Check) -> Check:
    sd = os.path.join(data_dir, split, MNIST_VARIANT)
    names = ck.load_pickle(os.path.join(sd, "filenames.pickle"),
                           "filenames")
    bb = ck.load_pickle(os.path.join(sd, "bboxes.pickle"), "bboxes")
    lab = ck.load_pickle(os.path.join(sd, "labels.pickle"), "labels")
    if names is not None:
        ck.report["n_items"] = len(names)
    bb = _summary("bboxes", bb, ck) if bb is not None else None
    lab = _summary("labels", lab, ck) if lab is not None else None
    if bb is not None:
        _check_bboxes(bb, ck, pad_allowed=False)
    if lab is not None:
        if lab.ndim != 3 or lab.shape[-1] != 10:
            ck.error(f"labels: expected (N, 3, 10) one-hots, got {lab.shape}")
        elif not np.allclose(lab.sum(-1), 1.0, atol=1e-5):
            ck.error("labels: rows are not one-hot (sums != 1) — "
                     "multi-mnist labels.pickle stores per-object one-hots "
                     "(ref datasets.py:25-86)")
    if names is not None and bb is not None and len(names) != len(bb):
        ck.error(f"length mismatch: {len(names)} filenames vs "
                 f"{len(bb)} bboxes")
    if names:
        paths = [os.path.join(sd, "imgs", str(f).split("/")[-1])
                 for f in names]
        _check_images(paths, ck, n_img, 1)
    return ck


def check_clevr(data_dir: str, img_dir: str, split: str, n_img: int,
                ck: Check) -> Check:
    scene_dir = os.path.join(data_dir, split, "scenes")
    image_dir = os.path.join(data_dir, split, "images")
    if not os.path.isdir(scene_dir):
        ck.error(f"missing scenes dir {scene_dir}")
        return ck
    scenes = sorted(f for f in os.listdir(scene_dir) if f.endswith(".json"))
    ck.report["n_items"] = len(scenes)
    if not scenes:
        ck.error(f"no scene jsons under {scene_dir}")
        return ck
    img_paths, n_objs = [], []
    for fn in scenes[: max(n_img, 50)]:
        try:
            with open(os.path.join(scene_dir, fn)) as f:
                scene = json.load(f)
        except Exception as e:  # noqa: BLE001
            ck.error(f"scenes: unparsable {fn}: {e}")
            return ck
        if "image_filename" not in scene or "objects" not in scene:
            ck.error(f"scenes: {fn} missing image_filename/objects keys")
            return ck
        img_paths.append(os.path.join(image_dir, scene["image_filename"]))
        n_objs.append(len(scene["objects"]))
        for obj in scene["objects"]:
            if obj.get("shape") not in CLEVR_SHAPES:
                ck.error(f"scenes: {fn} unknown shape {obj.get('shape')!r}")
            if obj.get("color") not in CLEVR_COLORS:
                ck.error(f"scenes: {fn} unknown color {obj.get('color')!r}")
            if "bbox" not in obj or len(obj["bbox"]) != 4:
                ck.error(f"scenes: {fn} object missing 4-element bbox "
                         "(pixel x, y, w, h)")
    ck.report["objects_per_scene_sampled"] = {
        "min": int(min(n_objs)), "max": int(max(n_objs))}
    if max(n_objs) > 4:
        ck.warn("scenes with > 4 objects: the loader keeps the first 4 "
                "(reference MAX_OBJECTS)")
    _check_images(img_paths, ck, n_img, 3)
    return ck


def _coco_labels(lab, ck: Check, hint: str = "") -> None:
    ids = lab.reshape(-1)
    if ids.min() < -1 or ids.max() > 80:
        ck.error(f"labels: category ids outside [-1, 80] "
                 f"(min {ids.min()}, max {ids.max()}){hint}")


def _coco_images(names, img_dir: str, n_img: int, ck: Check) -> None:
    if names is not None and img_dir:
        paths = [os.path.join(img_dir, str(k) + ".jpg") for k in names]
        _check_images(paths, ck, n_img, 3)
    elif not img_dir:
        ck.warn("no --img_dir given: image presence not checked")


def check_coco(data_dir: str, img_dir: str, split: str, n_img: int,
               ck: Check) -> Check:
    sd = os.path.join(data_dir, split)
    names = ck.load_pickle(os.path.join(sd, "filenames.pickle"),
                           "filenames")
    bb = ck.load_pickle(os.path.join(sd, "bboxes.pickle"), "bboxes")
    lab = ck.load_pickle(os.path.join(sd, "labels.pickle"), "labels")
    emb = ck.load_pickle(
        os.path.join(sd, "char-CNN-RNN-embeddings.pickle"), "embeddings")
    if names is not None:
        ck.report["n_items"] = len(names)
    bb = _summary("bboxes", bb, ck) if bb is not None else None
    lab = _summary("labels", lab, ck) if lab is not None else None
    emb = _summary("embeddings", emb, ck) if emb is not None else None
    if bb is not None:
        _check_bboxes(bb, ck, pad_allowed=True)
    if lab is not None:
        _coco_labels(lab, ck, " — expected -1-padded ids, one-hot happens "
                     "in the loader")
    if emb is not None and (emb.ndim != 3 or emb.shape[-1] != 1024):
        ck.error(f"embeddings: expected (N, captions, 1024), got "
                 f"{emb.shape} (char-CNN-RNN cnn-rnn format)")
    for a, b, an, bn in ((names, bb, "filenames", "bboxes"),
                         (names, emb, "filenames", "embeddings")):
        if a is not None and b is not None and len(a) != len(b):
            ck.error(f"length mismatch: {len(a)} {an} vs {len(b)} {bn}")
    _coco_images(names, img_dir, n_img, ck)
    return ck


def check_attngan(data_dir: str, img_dir: str, split: str, n_img: int,
                  ck: Check) -> Check:
    sd = os.path.join(data_dir, split)
    names = ck.load_pickle(os.path.join(sd, "filenames.pickle"),
                           "filenames")
    bb = ck.load_pickle(os.path.join(sd, "bboxes.pickle"), "bboxes")
    lab = ck.load_pickle(os.path.join(sd, "labels.pickle"), "labels")
    if names is not None:
        ck.report["n_items"] = len(names)
    bb = _summary("bboxes", bb, ck) if bb is not None else None
    lab = _summary("labels", lab, ck) if lab is not None else None
    if bb is not None:
        _check_bboxes(bb, ck, pad_allowed=True)
    if lab is not None:
        _coco_labels(lab, ck)
    _coco_images(names, img_dir, n_img, ck)
    # the caption text files serve only to rebuild captions.pickle
    cache = os.path.join(data_dir, "captions.pickle")
    if os.path.isfile(cache):
        caps = ck.load_pickle(cache, "captions_cache")
        if caps is not None:
            try:
                tr, te, ixtoword, wordtoix = caps
            except Exception:  # noqa: BLE001
                ck.error("captions.pickle: expected "
                         "[train, test, ixtoword, wordtoix] 4-list "
                         "(ref datasets.py:261-291)")
            else:
                ck.report["vocab_size"] = len(ixtoword)
                ck.report["n_train_captions"] = len(tr)
                ck.report["n_test_captions"] = len(te)
                bad = [w for w, ix in list(wordtoix.items())[:5000]
                       if ixtoword.get(ix) != w]
                # <end>/0 may be asymmetric; anything else is corruption
                if len(bad) > 1:
                    ck.error(f"captions.pickle: wordtoix/ixtoword not "
                             f"inverse (e.g. {bad[:3]})")
    else:
        txt = os.path.join(data_dir, "text")
        if names and os.path.isdir(txt):
            missing = [k for k in names[:50]
                       if not os.path.isfile(
                           os.path.join(txt, str(k) + ".txt"))]
            if missing:
                ck.error(f"text/: {len(missing)}/50 sampled caption files "
                         f"missing (first: {missing[0]}.txt); no "
                         "captions.pickle either")
        else:
            ck.warn("no captions.pickle and no text/ dir: vocabulary "
                    "cannot be built; the PUBLISHED captions.pickle is "
                    "required for vocab-index parity with the published "
                    "DAMSM NET_E")
    return ck


CHECKS = {"mnist": check_mnist, "clevr": check_clevr,
          "coco-stackgan": check_coco, "coco-attngan": check_attngan}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("variant", choices=sorted(CHECKS))
    p.add_argument("data_dir")
    p.add_argument("--img_dir", default="")
    p.add_argument("--split", default="train")
    p.add_argument("--sample_images", type=int, default=8,
                   help="images to actually decode")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: JPEGs by nvjpeg) or cpu")
    args = p.parse_args(argv)
    ck = CHECKS[args.variant](args.data_dir, args.img_dir, args.split,
                              args.sample_images,
                              Check(resolve_device(args.device)))
    out = {"variant": args.variant, "data_dir": args.data_dir,
           "split": args.split, "ok": not ck.errors,
           "errors": ck.errors, "warnings": ck.warnings,
           "report": ck.report}
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
