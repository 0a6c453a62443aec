"""FID and Inception Score between two image directories, with the port
(its counterpart of the JAX package's ``tools/eval_fid.py``).

    python -m multiple_objects_gan_tpu_torch.tools.eval_fid \\
        REAL_DIR FAKE_DIR [--image_encoder damsm_image_encoder.pth] \\
        [--fid_weights pt_inception.pth] [--size 256] [--limit N] \\
        [--batch 32] [--out metrics.json] [--device cuda|cpu]

For any 256px dump (AttnGAN's ``single_samples/``, a real-image
directory). FID is comparable with published numbers only with
``--fid_weights`` (or ``$FID_INCEPTION_WEIGHTS``) naming pytorch-fid's
pt_inception-2015-12-05 ``.pth`` (``fid_encoder: "fid_canonical"``); else
it runs on the DAMSM image encoder's backbone of ``--image_encoder``
(``"damsm"``), or a random one (``"random"``, comparable only with
itself). IS takes its head from ``$INCEPTION_V3_WEIGHTS`` (a torchvision
inception_v3 state dict) and is publication-grade only when
``is_backbone`` and ``is_head`` are both "imported".

PNGs are decoded by ``data/png.py``; JPEGs by ``data/jpeg.py`` on the CPU
and nvjpeg on the card (``data/nvjpeg.py``); an image of another size is
resized with PIL's bilinear filter (``data/png.py:resize_bilinear``, or
``nvjpeg.decode_resized`` on the card). The directories are streamed in
chunks of 512 images; only their 2048-d features are kept. Prints one
JSON line: {"fid", "is_mean", "is_std", "n_real", "n_fake", "is_head",
"is_backbone", "fid_encoder"}.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from multiple_objects_gan_tpu_torch import resolve_device
from multiple_objects_gan_tpu_torch.data.nvjpeg import decode_resized
from multiple_objects_gan_tpu_torch.data.png import read_png, resize_bilinear
from multiple_objects_gan_tpu_torch.io.weights import load_image_encoder
from multiple_objects_gan_tpu_torch.nn.encoders import build_image_encoder
from multiple_objects_gan_tpu_torch.utils.metrics import (
    BATCH, fid_from_activations, inception_activations, inception_score,
    resolve_fid_encoder, resolve_inception_fc)

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")
JPEG_EXTS = (".jpg", ".jpeg")
CHUNK = 512             # images decoded at once


def list_image_files(path: str, limit: int = 0) -> list:
    files = sorted(
        os.path.join(r, f)
        for r, _, fs in os.walk(path) for f in fs
        if f.lower().endswith(IMG_EXTS))
    if limit:
        files = files[:limit]
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    return files


def load_images(files, size: int, device: torch.device) -> torch.Tensor:
    """(N, size, size, 3) in [-1, 1] float32 on ``device``: each file
    decoded as ``Image.open(f).convert("RGB")`` and, at another size,
    resized bilinearly as PIL resizes it."""
    out = torch.empty((len(files), size, size, 3), device=device)
    jpegs = [i for i, f in enumerate(files) if f.lower().endswith(JPEG_EXTS)]
    if jpegs:
        u8 = torch.as_tensor(decode_resized([files[i] for i in jpegs], size,
                                            device))
        out[torch.tensor(jpegs, device=device)] = u8.to(device).float()
    for i, f in enumerate(files):
        if f.lower().endswith(".bmp"):
            raise ValueError(f"{f}: the port reads PNG and JPEG, not BMP")
        if f.lower().endswith(".png"):
            img = read_png(f, "RGB")
            if img.shape[:2] != (size, size):
                img = resize_bilinear(img, (size, size))
            out[i] = torch.from_numpy(img).to(device).float()
    return out / 127.5 - 1.0


def dir_activations(enc, path: str, size: int, limit: int, batch: int,
                    chunk: int = CHUNK) -> np.ndarray:
    """A directory's (N, 2048) features, ``chunk`` images decoded at a
    time on the encoder's device."""
    device = next(enc.parameters()).device
    files = list_image_files(path, limit)
    return np.concatenate([
        inception_activations(enc, load_images(files[s:s + chunk], size,
                                               device), batch)
        for s in range(0, len(files), chunk)], axis=0)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("real_dir")
    p.add_argument("fake_dir")
    p.add_argument("--image_encoder", default="",
                   help="DAMSM image_encoder .pth (a random backbone if "
                        "unset: its numbers compare only with themselves)")
    p.add_argument("--fid_weights", default="",
                   help="pytorch-fid pt_inception .pth -> the canonical "
                        "FID encoder (also $FID_INCEPTION_WEIGHTS)")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--limit", type=int, default=0,
                   help="images read a directory (0 = all)")
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--out", default="", help="also write the JSON here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    sd = None
    if args.image_encoder:
        sd = load_image_encoder(args.image_encoder)
        print(f"Load image encoder from: {args.image_encoder}", flush=True)
    enc = build_image_encoder(256, sd, seed=0, device=device)
    if args.fid_weights:
        os.environ["FID_INCEPTION_WEIGHTS"] = args.fid_weights
    fid_enc, fid_prov = resolve_fid_encoder(
        enc, "damsm" if args.image_encoder else "random", device=device)
    if fid_prov == "fid_canonical":
        print("canonical pytorch-fid encoder: "
              f"{os.environ['FID_INCEPTION_WEIGHTS']}", flush=True)
    elif fid_prov == "random":
        print("WARNING: neither $FID_INCEPTION_WEIGHTS nor --image_encoder "
              "set — random Inception backbone; FID comparable only within "
              "this configuration", flush=True)

    real_acts = dir_activations(fid_enc, args.real_dir, args.size,
                                args.limit, args.batch)
    fake_acts = dir_activations(fid_enc, args.fake_dir, args.size,
                                args.limit, args.batch)
    fid = fid_from_activations(real_acts, fake_acts)
    fc, is_head = resolve_inception_fc()
    is_backbone = "imported" if args.image_encoder else "random"
    if is_backbone == "random" or is_head == "random":
        print("WARNING: IS is not comparable to published numbers "
              f"(backbone={is_backbone}, head={is_head}) — set "
              "--image_encoder AND $INCEPTION_V3_WEIGHTS for a meaningful "
              "IS", flush=True)
    if fid_prov == "fid_canonical" and is_backbone == "imported":
        # the head matches the DAMSM backbone's pool, not pt_inception's
        is_acts = dir_activations(enc, args.fake_dir, args.size, args.limit,
                                  args.batch)
    else:
        is_acts = fake_acts
    is_mean, is_std = inception_score(acts=is_acts, fc=fc)
    result = {"fid": round(fid, 4), "is_mean": round(is_mean, 4),
              "is_std": round(is_std, 4),
              "n_real": int(real_acts.shape[0]),
              "n_fake": int(fake_acts.shape[0]),
              "is_head": is_head, "is_backbone": is_backbone,
              "fid_encoder": fid_prov}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
