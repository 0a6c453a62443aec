"""Export a checkpoint of a port run to reference-format ``.pth`` files (the
port's counterpart of the JAX package's ``tools/export_checkpoint.py``).

    python -m multiple_objects_gan_tpu_torch.tools.export_checkpoint stage1 \\
        --variant multi-mnist --cfg cfg/mnist_eval.yml --ckpt OUTPUT_DIR \\
        [--epoch N] --out netG.pth [--out_d netD.pth] [--device cuda|cpu]
    python -m multiple_objects_gan_tpu_torch.tools.export_checkpoint stage2 \\
        --cfg cfg/coco_s2_eval.yml --ckpt OUTPUT_DIR \\
        --s1_net_g stage1_netG.pth --out netG.pth
    python -m multiple_objects_gan_tpu_torch.tools.export_checkpoint attngan \\
        --cfg cfg/coco_attn_eval.yml --ckpt OUTPUT_DIR --out netG.pth \\
        [--raw] [--bare] [--out_d DIR]

``--ckpt`` is a port run directory (``models/`` inside) or its
``models/`` directory; ``--epoch`` picks a checkpoint (default the
latest). The containers are the JAX exporter's
(``io/torch_export.py:save_reference_checkpoint``, ``save_bare_state_dict``):
NET_G as ``{'epoch', 'netG', 'optimG': {}, 'netD': {}, 'optimD': {}}``
(the reference's save_model, code/multi-mnist/miscc/utils.py:160-174),
NET_D as a bare state dict, AttnGAN's Ds as ``netD0.pth``, ``netD1.pth``
... in a directory (attngan trainer.py:119-126). AttnGAN exports the EMA G
by default (the reference's published checkpoints are EMA-swapped,
trainer.py:173-199); ``--raw`` exports the live weights and ``--bare`` a
bare state dict (the TRAIN.NET_G warm-start form, trainer.py:110-113). A
stage-2 G embeds its frozen stage-1 G under ``STAGE1_G.``
(stackgan model.py:317-320) from ``--s1_net_g``; without it a strict
reference load reports those keys missing, and the tool warns.

The port's state dicts already carry the reference's keys
(``io/weights.py``): every state dict is loaded strictly into its model
on ``--device`` (the card unless ``--device cpu``; without a card it
raises), which checks it against the cfg, and is written from the CPU,
contiguous.
"""

from __future__ import annotations

import argparse
import os

import torch

from multiple_objects_gan_tpu_torch import resolve_device
from multiple_objects_gan_tpu_torch.config.config import (
    attngan_model_config, cfg_from_file, stage1_model_config,
    stage2_model_config)
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.io.weights import (
    STAGE1_PREFIX, load_reference_g)
from multiple_objects_gan_tpu_torch.models.attngan import (
    build_attngan_d, build_attngan_g)
from multiple_objects_gan_tpu_torch.models.stage1 import (
    build_stage1_d, build_stage1_g)
from multiple_objects_gan_tpu_torch.models.stage2 import (
    build_stage2_d, build_stage2_g)

# the JAX tool's family variants -> the port's cfg variants
STAGE1_VARIANTS = {"multi-mnist": "multi-mnist", "clevr": "clevr",
                   "coco-stackgan": "coco-stackgan-1"}


def _models_dir(path: str) -> str:
    sub = os.path.join(path, "models")
    return sub if os.path.isdir(sub) else path


def _cpu(sd) -> dict:
    return {k: v.detach().cpu().contiguous() for k, v in (sd or {}).items()}


def save_bare_state_dict(sd: dict, path: str) -> None:
    """torch.save a bare state dict (the reference's NET_D and
    ``netD%d.pth`` form)."""
    torch.save(_cpu(sd), path)


def save_reference_checkpoint(path: str, epoch: int, net_g: dict = None,
                              net_d: dict = None) -> None:
    """The reference's checkpoint container, optimizers empty as in its
    default ``saveOptim=False``."""
    torch.save({"epoch": epoch, "netG": _cpu(net_g), "optimG": {},
                "netD": _cpu(net_d), "optimD": {}}, path)


def _load(args) -> tuple[dict, int]:
    return CheckpointManager(_models_dir(args.ckpt)).load(args.epoch)


def export_stage1(args, device) -> None:
    variant = STAGE1_VARIANTS[args.variant]
    mcfg = stage1_model_config(cfg_from_file(args.cfg, variant), variant)
    ckpt, epoch = _load(args)
    g = build_stage1_g(mcfg, ckpt["g"], device=device)
    save_reference_checkpoint(args.out, epoch, net_g=g.state_dict())
    print(f"wrote netG (epoch {epoch}) to {args.out}", flush=True)
    if args.out_d:
        d = build_stage1_d(mcfg, ckpt["d"], device=device)
        save_bare_state_dict(d.state_dict(), args.out_d)
        print(f"wrote bare netD to {args.out_d}", flush=True)


def export_stage2(args, device) -> None:
    s1_cfg, s2_cfg = stage2_model_config(
        cfg_from_file(args.cfg, "coco-stackgan-2"))
    ckpt, epoch = _load(args)
    sd = {}
    if args.s1_net_g:
        g1 = build_stage1_g(s1_cfg, load_reference_g(args.s1_net_g),
                            device=device)
        sd = {STAGE1_PREFIX + k: v for k, v in g1.state_dict().items()}
        print(f"embedding STAGE1_G from {args.s1_net_g}", flush=True)
    else:
        print("WARNING: no --s1_net_g — the reference's STAGE2_G wraps a "
              "frozen STAGE1_G (model.py:317-320) and a strict torch load "
              "of this export will report its keys missing", flush=True)
    sd.update(build_stage2_g(s2_cfg, ckpt["g"], device=device).state_dict())
    save_reference_checkpoint(args.out, epoch, net_g=sd)
    print(f"wrote netG (epoch {epoch}) to {args.out}", flush=True)
    if args.out_d:
        d = build_stage2_d(s2_cfg, ckpt["d"], device=device)
        save_bare_state_dict(d.state_dict(), args.out_d)
        print(f"wrote bare netD to {args.out_d}", flush=True)


def export_attngan(args, device) -> None:
    mcfg = attngan_model_config(cfg_from_file(args.cfg, "coco-attngan"))
    ckpt, epoch = _load(args)
    weights = ckpt["g"] if args.raw else {**ckpt["g"], **ckpt["g_ema"]}
    sd = build_attngan_g(mcfg, weights, device=device).state_dict()
    if args.bare:
        save_bare_state_dict(sd, args.out)
    else:
        save_reference_checkpoint(args.out, epoch, net_g=sd)
    print(f"wrote {'raw' if args.raw else 'EMA'} netG (epoch {epoch}, "
          f"{'bare' if args.bare else 'netG container'}) to {args.out}",
          flush=True)
    if args.out_d:
        os.makedirs(args.out_d, exist_ok=True)
        for i, name in enumerate(sorted(ckpt["d"], key=lambda n: int(n[1:]))):
            path = os.path.join(args.out_d, f"netD{i}.pth")
            d = build_attngan_d(mcfg, int(name[1:]), ckpt["d"][name],
                                device=device)
            save_bare_state_dict(d.state_dict(), path)
            print(f"wrote bare {name} to {path}", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("family", choices=["stage1", "stage2", "attngan"])
    p.add_argument("--variant", default="multi-mnist",
                   choices=sorted(STAGE1_VARIANTS))
    p.add_argument("--cfg", required=True)
    p.add_argument("--ckpt", required=True,
                   help="a port run directory (or its models/ directory)")
    p.add_argument("--epoch", type=int, default=None,
                   help="checkpoint epoch (default: the latest)")
    p.add_argument("--out", required=True, help="output netG .pth path")
    p.add_argument("--out_d", default="",
                   help="stage1/stage2: path for a bare netD .pth; "
                        "attngan: directory for netD0/1/2.pth")
    p.add_argument("--s1_net_g", default="",
                   help="stage2: stage-1 netG .pth to embed as STAGE1_G.*")
    p.add_argument("--raw", action="store_true",
                   help="attngan: export the live G weights, not the EMA")
    p.add_argument("--bare", action="store_true",
                   help="attngan: a bare state dict (the TRAIN.NET_G "
                        "warm-start form), not the {'netG': ...} container")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    {"stage1": export_stage1, "stage2": export_stage2,
     "attngan": export_attngan}[args.family](args, device)


if __name__ == "__main__":
    main()
