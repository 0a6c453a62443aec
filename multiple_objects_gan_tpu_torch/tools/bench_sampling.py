"""Sampling throughput on the card: eval-mode generation images/s (the
port's counterpart of the JAX package's ``tools/bench_sampling.py``).

    python -m multiple_objects_gan_tpu_torch.tools.bench_sampling \\
        [mnist|clevr|stackgan1|attngan ...] [--f32] [--device cuda|cpu]

The SERVING path at a given batch: ``train/step.py:make_sample_fn``
(eval-mode BatchNorm, c = mu) for the stage-1 families at batch 128, the
widths of cfg/mnist_train.yml, cfg/clevr_train.yml and
cfg/coco_s1_train.yml (seeded G, ``data/synthetic.py``'s layouts), and
``attngan`` ("attngan256"): the text encoder plus AttnGAN's G to 256px at
batch 32, as ``cli/serve.py:attngan_images`` computes it, at the JAX
tool's widths (GF 48, 3 branches, R_NUM 2, a 100-word vocabulary,
captions of 12, every box [0.2, 0.2, 0.3, 0.3]). bf16 unless ``--f32``
(``MOG_COMPUTE_DTYPE`` is not read, as in the JAX tool); float32 runs
with TF32 off. Without names it runs mnist, as the JAX tool does.

Timing: ``bench_variants.sync_time``, the JAX tools' ``_sync_time``: 2
warm-up batches, a host sync, then ``n`` batches (40 for the stage-1
families, 20 for attngan256) on a rotation of noise draws and one host
sync after the last (``.item()`` of a pixel), on the host clock.
Prints one JSON line per variant:
  {"variant", "batch", "bf16", "ms_per_batch", "img_per_sec"}
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from multiple_objects_gan_tpu_torch import float32_policy, resolve_device
from multiple_objects_gan_tpu_torch.cli.serve import attngan_images
from multiple_objects_gan_tpu_torch.config.config import (
    cfg_from_file, stage1_model_config)
from multiple_objects_gan_tpu_torch.data.synthetic import synthetic_batch
from multiple_objects_gan_tpu_torch.models.attngan import build_attngan_g
from multiple_objects_gan_tpu_torch.models.stage1 import build_stage1_g
from multiple_objects_gan_tpu_torch.nn.encoders import build_text_encoder
from multiple_objects_gan_tpu_torch.tools.bench_variants import (
    ATTN_BENCH, ATTN_SEQ, ATTN_VOCAB, BOX, sync_time)
from multiple_objects_gan_tpu_torch.train.step import make_sample_fn

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
VARIANTS = {
    "mnist": (os.path.join(ROOT, "cfg", "mnist_train.yml"), "multi-mnist",
              128),
    "clevr": (os.path.join(ROOT, "cfg", "clevr_train.yml"), "clevr", 128),
    "stackgan1": (os.path.join(ROOT, "cfg", "coco_s1_train.yml"),
                  "coco-stackgan-1", 128),
}
STAGE1_BATCHES = 40         # timed batches of a stage-1 family
ATTN_BATCHES = 20           # timed batches of attngan256
ATTN_BATCH = 32
NOISE_DRAWS = 8             # z rotation (the JAX tool's fold_in 0..7)


def _line(name: str, bs: int, bf16: bool, dt: float) -> dict:
    return {"variant": name, "batch": bs, "bf16": bf16,
            "ms_per_batch": round(dt * 1e3, 2),
            "img_per_sec": round(bs / dt, 1)}


def _noise(n: int, bs: int, z_dim: int, dev) -> list:
    gen = torch.Generator().manual_seed(0)
    return [torch.randn(bs, z_dim, generator=gen).to(dev) for _ in range(n)]


def bench_variant(name: str, bf16: bool, device="cuda",
                  n: int = STAGE1_BATCHES, mcfg=None,
                  bs: Optional[int] = None) -> dict:
    """A stage-1 family's sampling at its batch (``mcfg`` overrides the
    cfg's model config, ``bs`` the batch)."""
    cfg_file, cfg_variant, batch = VARIANTS[name]
    bs = bs or batch
    dev = resolve_device(device)
    dtype = torch.bfloat16 if bf16 else None
    float32_policy(dev, dtype)
    if mcfg is None:
        mcfg = stage1_model_config(cfg_from_file(cfg_file, cfg_variant),
                                   cfg_variant)
    mcfg = dataclasses.replace(mcfg, compute_dtype=dtype)
    g = build_stage1_g(mcfg, seed=0, device=dev)
    data = synthetic_batch(mcfg, bs)
    bbox = torch.from_numpy(data["bbox"]).to(dev)
    labels = torch.from_numpy(data["label_onehot"]).to(dev)
    text = (torch.from_numpy(data["text_embedding"]).to(dev)
            if "text_embedding" in data else None)
    sample = make_sample_fn(mcfg)
    zs = itertools.cycle(_noise(NOISE_DRAWS, bs, mcfg.z_dim, dev))
    dt = sync_time(lambda: sample(g, next(zs), bbox, labels, text), n=n)
    return _line(name, bs, bf16, dt)


def bench_attngan(bf16: bool, bs: int = ATTN_BATCH, device="cuda",
                  n: int = ATTN_BATCHES, mcfg=ATTN_BENCH) -> dict:
    """The flagship serving path: text encoder + AttnGAN's G to 256px."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if bf16 else None
    float32_policy(dev, dtype)
    mcfg = dataclasses.replace(mcfg, compute_dtype=dtype)
    g = build_attngan_g(mcfg, seed=0, device=dev).eval()
    text = build_text_encoder(ATTN_VOCAB, mcfg.embedding_dim, seed=0,
                              device=dev)
    rs = np.random.RandomState(0)
    caps = torch.from_numpy(rs.randint(1, ATTN_VOCAB, (bs, ATTN_SEQ))).to(
        dev)
    lens = torch.full((bs,), ATTN_SEQ, dtype=torch.int64, device=dev)
    bbox = torch.from_numpy(np.tile(BOX, (bs, 3, 1)).astype(
        np.float32)).to(dev)
    labels = torch.from_numpy(np.eye(mcfg.label_dim, dtype=np.float32)[
        rs.randint(0, mcfg.label_dim, (bs, 3))]).to(dev)
    zs = itertools.cycle(_noise(4, bs, mcfg.z_dim, dev))
    dt = sync_time(
        lambda: attngan_images(text, g, caps, lens, bbox, labels, next(zs)),
        n=n)
    return _line("attngan256", bs, bf16, dt)


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("names", nargs="*", metavar="VARIANT",
                   help=f"of {[*VARIANTS, 'attngan']} (default: mnist)")
    p.add_argument("--f32", action="store_true",
                   help="float32 (TF32 off) instead of bf16")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    unknown = sorted(set(args.names) - {*VARIANTS, "attngan"})
    if unknown:
        p.error(f"unknown variants {unknown}")
    bf16 = not args.f32
    dev = resolve_device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the CPU")
    print(f"bench_sampling: {'bf16' if bf16 else 'float32'} on {where}",
          file=sys.stderr, flush=True)
    lines = []
    for name in args.names or ["mnist"]:
        lines.append(bench_attngan(bf16, device=args.device)
                     if name == "attngan"
                     else bench_variant(name, bf16, device=args.device))
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
