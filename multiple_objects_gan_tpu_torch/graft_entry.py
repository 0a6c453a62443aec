"""Driver entry points: one full train step, and the train steps over a
process group of n ranks (the port's counterpart of the JAX package's
``__graft_entry__.py``).

    python -m multiple_objects_gan_tpu_torch.graft_entry [--device cpu]
    python -m multiple_objects_gan_tpu_torch.graft_entry --dryrun N \\
        [--device cpu]

The first runs :func:`entry`'s step once and prints ``entry OK: d_loss=...
g_loss=...``; the second runs :func:`dryrun_multichip`. Both run on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import tempfile
from typing import Callable, Optional

import numpy as np
import torch

from multiple_objects_gan_tpu_torch import float32_policy, resolve_device
from multiple_objects_gan_tpu_torch.data.synthetic import synthetic_batch
from multiple_objects_gan_tpu_torch.models.attngan import COCO_ATTN
from multiple_objects_gan_tpu_torch.models.common import (
    COCO_S1, COCO_S2, MNIST, Stage1Config)
from multiple_objects_gan_tpu_torch.models.stage1 import build_stage1_g
from multiple_objects_gan_tpu_torch.nn.encoders import (
    build_image_encoder, build_text_encoder)
from multiple_objects_gan_tpu_torch.tools import dist_steps
from multiple_objects_gan_tpu_torch.train.state import (
    create_attngan_state, create_state, create_state_stage2)
from multiple_objects_gan_tpu_torch.train.step import make_train_step

LR = 2e-4
ENTRY_BATCH = 8
ENTRY_BOX = [0.2, 0.2, 0.3, 0.3]    # every object's box in the entry batch
ENTRY_LABEL = 1                     # every object's class in the entry batch
# the dry run's legs at the JAX dry run's tiny widths
DRY_STAGE1 = dataclasses.replace(MNIST, gf_dim=16, df_dim=8)
DRY_ATTN = dataclasses.replace(COCO_ATTN, gf_dim=8, df_dim=8, z_dim=16,
                               condition_dim=16, embedding_dim=16,
                               branch_num=3, r_num=1)
DRY_ATTN_WORDS = 30
DRY_ATTN_SEQ = 6
DRY_ATTN_SMOOTH = {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0,
                   "LAMBDA": 1.0}
_S2_TINY = dict(gf_dim=8, df_dim=4, text_dim=16, condition_dim=16,
                d_cond_dim=16)
DRY_S1 = dataclasses.replace(COCO_S1, **_S2_TINY)
DRY_S2 = dataclasses.replace(COCO_S2, r_num=1, **_S2_TINY)
DRY_LEGS = ("stage1", "attngan", "stage2")


def entry_batch(cfg: Stage1Config = MNIST) -> dict:
    """The JAX entry's batch as numpy arrays: ``RandomState(0)`` images in
    [-1, 1] (B, 64, 64, C), every box ``ENTRY_BOX``, every object of class
    ``ENTRY_LABEL``."""
    b = ENTRY_BATCH
    rs = np.random.RandomState(0)
    bbox = np.tile(np.asarray(ENTRY_BOX, np.float32),
                   (b, cfg.num_objects, 1))
    labels = np.zeros((b, cfg.num_objects, cfg.label_dim), np.float32)
    labels[:, :, ENTRY_LABEL] = 1.0
    return {"image": rs.rand(b, 64, 64, cfg.img_channels)
            .astype(np.float32) * 2 - 1,
            "bbox": bbox, "label_onehot": labels}


def entry(device="cuda", cfg: Stage1Config = MNIST) -> tuple[Callable, tuple]:
    """Returns ``(fn, example_args)``: one full stage-1 train step (64px,
    ``cfg``'s widths, batch 8) through ``train/step.py:make_train_step``,
    D then G, Adam(0.5, 0.999) at lr 2e-4 for both nets.

    ``fn(state, batch, generator, z=None) -> (d_loss, g_loss, G's
    parameters by name)``; ``example_args`` is ``(state, batch,
    generator)`` on ``device``: the state from ``create_state(cfg,
    seed=0)``, :func:`entry_batch` and a generator seeded 0. ``z`` replaces
    the step's draw (a test replays the JAX step's). The state and the
    batch are arguments, never closure constants. Where the JAX step
    returns a new state, this one updates ``state`` in place: its modules,
    Adams and step count, so the parameters returned are the state's own.
    Float32 on the card computes with TF32 off (``float32_policy``).
    """
    dev = resolve_device(device)
    float32_policy(dev, cfg.compute_dtype)
    state = create_state(cfg, seed=0, device=dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in entry_batch(cfg).items()}
    generator = torch.Generator(device=dev).manual_seed(0)
    step = make_train_step(cfg)

    def train_step(state, batch, generator,
                   z: Optional[torch.Tensor] = None):
        metrics = step(state, batch, generator, LR, LR, z=z)
        return (metrics["d_loss"], metrics["g_loss"],
                {k: p.detach() for k, p in state.g.named_parameters()})

    return train_step, (state, batch, generator)


def _tensors(batch: dict) -> dict:
    """numpy -> CPU tensors, integer arrays as int64 (embedding ids)."""
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                                else v) for k, v in batch.items()}


def dryrun_cases(n_devices: int) -> list[dict]:
    """The dry run's step cases (``tools/dist_steps.py``), in ``DRY_LEGS``
    order, on the CPU, at the JAX dry run's widths and a global batch of
    2n: stage 1 at ``DRY_STAGE1`` on ``synthetic_batch``; AttnGAN at
    ``DRY_ATTN`` (three branches, R_NUM 1) with seeded encoders (a 30-word
    vocabulary, captions of 6) and the smooth ``DRY_ATTN_SMOOTH``; stage 2
    at ``DRY_S1``/``DRY_S2`` with a seeded frozen stage-1 G and boxes in
    [0.1, 0.5] x [0.2, 0.4]. The AttnGAN and stage-2 batches come from one
    ``RandomState(0)``, in that order, as in the JAX dry run."""
    b = 2 * n_devices
    stage1 = {
        "name": "stage1", "kind": "stage1", "config": DRY_STAGE1,
        "state": create_state(DRY_STAGE1, seed=0, device="cpu"),
        "batch": _tensors(synthetic_batch(DRY_STAGE1, b)), "seed": 0,
        "lr": LR}

    rs = np.random.RandomState(0)
    abatch = {f"image{s}": rs.rand(b, s, s, 3).astype(np.float32) * 2 - 1
              for s in (64, 128, 256)}
    abatch.update({
        "bbox": np.tile(ENTRY_BOX, (b, 3, 1)).astype(np.float32),
        "label_onehot": np.eye(DRY_ATTN.label_dim, dtype=np.float32)[
            rs.randint(0, DRY_ATTN.label_dim, (b, 3))],
        "captions": rs.randint(1, DRY_ATTN_WORDS, (b, DRY_ATTN_SEQ)),
        "cap_lens": np.full((b,), DRY_ATTN_SEQ),
        "class_ids": np.arange(b)})
    encoders = (build_text_encoder(DRY_ATTN_WORDS, DRY_ATTN.embedding_dim,
                                   seed=0, device="cpu"),
                build_image_encoder(DRY_ATTN.embedding_dim, seed=0,
                                    device="cpu"))
    attngan = {
        "name": "attngan", "kind": "attngan", "config": DRY_ATTN,
        "state": create_attngan_state(DRY_ATTN, seed=0, device="cpu"),
        "encoders": encoders, "smooth": DRY_ATTN_SMOOTH,
        "batch": _tensors(abatch), "seed": 0, "lr": LR}

    o = 3
    bb = np.stack([rs.uniform(0.1, 0.5, (b, o)),
                   rs.uniform(0.1, 0.5, (b, o)),
                   rs.uniform(0.2, 0.4, (b, o)),
                   rs.uniform(0.2, 0.4, (b, o))], -1).astype(np.float32)
    lab = np.zeros((b, o, DRY_S2.label_dim), np.float32)
    lab[:, :, 5] = 1.0
    s2_batch = {
        "image": rs.rand(b, 256, 256, 3).astype(np.float32) * 2 - 1,
        "bbox": bb, "bbox_s2": bb.copy(), "label_onehot": lab,
        "text_embedding": rs.randn(b, DRY_S2.text_dim).astype(np.float32)}
    stage2 = {
        "name": "stage2", "kind": "stage2", "config": DRY_S2,
        "s1_config": DRY_S1,
        "g1": build_stage1_g(DRY_S1, seed=0, device="cpu").state_dict(),
        "state": create_state_stage2(DRY_S2, seed=0, device="cpu"),
        "batch": _tensors(s2_batch), "seed": 0, "lr": LR}
    return [stage1, attngan, stage2]


def same_bits(a, b) -> bool:
    """Two records (dicts, lists, tensors, numbers) equal bit for bit."""
    if isinstance(a, dict):
        return sorted(a, key=str) == sorted(b, key=str) and all(
            same_bits(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same_bits, a, b))
    return a == b


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The full train steps of stage 1, AttnGAN and stage 2
    (:func:`dryrun_cases`) as ``n_devices`` ranks of one process group
    (``tools/dist_steps.py:spawn``, gloo on the CPU or on one shared card,
    NCCL where each rank has a card of its own), one step each on the
    global batch of 2n, checked by :func:`check_dryrun`. Returns {leg:
    every rank's result, rank order}; raises if a rank or a check fails."""
    resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        path = os.path.join(tmp, "cases.pth")
        torch.save(dryrun_cases(n_devices), path)
        ranks = dist_steps.spawn(path, os.path.join(tmp, "out"),
                                 world=n_devices, device=device)
    return check_dryrun(ranks, n_devices)


def check_dryrun(ranks: list, n_devices: int) -> dict:
    """What the JAX dry run checks, on the ranks' records of
    :func:`dryrun_cases` (``dist_steps.spawn``'s): every summed metric
    finite, the state identical on every rank bit for bit (the port's
    "fully replicated"), and AttnGAN's ``d_loss_d256`` present. Prints
    one ``dryrun_multichip(n) <leg> OK — k=v ...`` line a leg and raises
    on the first failure. Returns {case name: every rank's result}."""
    results = {name: [r["results"][name] for r in ranks]
               for name in ranks[0]["results"]}
    for leg in DRY_LEGS:
        got = results[leg]
        metrics = got[0]["metrics"]
        bad = sorted(k for k, v in metrics.items() if not math.isfinite(v))
        if bad:
            raise RuntimeError(f"dryrun_multichip({n_devices}) {leg}: "
                               f"{bad} not finite")
        if not all(same_bits(got[0]["state"], r["state"]) for r in got[1:]):
            raise RuntimeError(f"dryrun_multichip({n_devices}) {leg}: the "
                               "ranks' states differ after the step")
        if leg == "attngan" and "d_loss_d256" not in metrics:
            raise RuntimeError("branch-3 d256 missing from the dry run")
        print(f"dryrun_multichip({n_devices}) {leg} OK — "
              + " ".join(f"{k}={v:.3f}" for k, v in sorted(metrics.items())),
              flush=True)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dryrun", type=int, metavar="N",
                   help="run the dry run over N ranks instead")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.dryrun:
        dryrun_multichip(args.dryrun, device=args.device)
        return 0
    fn, example = entry(device=args.device)
    d_loss, g_loss, _ = fn(*example)
    print("entry OK: d_loss=%.4f g_loss=%.4f"
          % (float(d_loss), float(g_loss)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
