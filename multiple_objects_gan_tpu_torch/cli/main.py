"""Train or sample with the PyTorch port (the port's counterpart of the JAX
package's ``cli/main.py``, for the three stage-1 families, COCO StackGAN
stage 2, COCO AttnGAN and DAMSM pretraining).

    python -m multiple_objects_gan_tpu_torch.cli.main \\
        --variant multi-mnist|clevr|coco-stackgan-1|coco-stackgan-2|\\
coco-attngan|damsm \\
        --cfg CFG \\
        [--data_dir D] [--img_dir I] [--output_dir O] [--synthetic] \\
        [--resume RUN_DIR] [--stochastic_ca] \\
        [--max_epochs N] [--snapshot_interval N] [--manualSeed N] \\
        [--device cuda|cpu] [--bf16] [--bn_groups G] \\
        [--num_objects N] [--bbox_scale S] \\
        [--eval_mode auto|sample|gen_example|sampling] [--num_images N] \\
        [--profile DIR]

``TRAIN.FLAG`` in the cfg picks training or sampling, as in the reference
(code/multi-mnist/main.py:27-95). Training reads Multi-MNIST and CLEVR
from ``DATA_DIR`` (``--data_dir`` overrides it), and COCO from DATA_DIR's
pickles and IMG_DIR's JPEGs (``--img_dir`` overrides it): StackGAN through
``data/coco.py:CocoStackganDataset`` (decoded per batch; on the card by
nvjpeg), AttnGAN (``cli/attngan_runner.py``) and DAMSM pretraining
(``cli/damsm_runner.py``, cfg/coco_damsm.yml) through
``data/attngan.py:AttnGanTrainSet``. With ``--synthetic`` a missing train
split is first written there, at the JAX CLI's sizes
(``synthetic_items``); without it a missing split exits with its path.
Both ``coco-stackgan-*`` variants go where cfg ``STAGE`` says, as the JAX
CLI's ``run_stackgan`` does: stage 1 to the stage-1 trainer (whatever
TRAIN.FLAG says, as there), stage 2 to ``cli/stage2_runner.py`` (training
with the frozen stage-1 G of cfg ``STAGE1_G``, or with ``TRAIN.FLAG:
False`` 25 grids, ``sample_stage2``; ``--stochastic_ca`` draws the CA
noise there instead of c = mu). AttnGAN's DAMSM encoders come from cfg
``TRAIN.NET_E``, which DAMSM pretraining writes (``DAMSMencoders/``). A
run leaves, under ``--output_dir`` (default
``output/<DATASET>_<time>``), ``run_flags.json``, a copy of the cfg, the
port's sources (``src_snapshot/``), ``logs/metrics.jsonl``, epoch grids in
``images/`` and checkpoints in ``models/<epoch>/``. ``--resume RUN_DIR``
continues from that run's latest checkpoint; cfg ``NET_G``/``NET_D``
``.pth`` files warm-start G and D; a resume without ``--manualSeed``
takes the seed of the resumed run's ``run_flags.json``, so its shuffles
and grids are the uninterrupted run's. With ``TRAIN.FLAG: False`` the run
samples from ``NET_G``: 25 grids for Multi-MNIST and CLEVR
(``cli/sample.py``) and COCO StackGAN stage 2; for COCO AttnGAN the eval
mode ``--eval_mode`` names (``auto``: ``sample`` under cfg B_VALIDATION,
else ``gen_example``; ``sampling`` dumps the test split's fakes, up to
``--num_images``, and writes FID and IS with their provenance to
``eval_metrics.json``). ``--profile DIR`` writes a torch.profiler trace
of steps 2-5 of a training run's first epoch to DIR.
The run is on the card unless ``--device cpu`` is given; without a card it
raises. It runs on several processes when the environment says so
(``MOG_COORDINATOR=host:port MOG_NUM_PROCESSES=n MOG_PROCESS_ID=i``, or
torchrun's): each process trains on its shard of every global batch
(``parallel/``), NCCL between cards and gloo on the CPU or on a shared
card, rank 0 writing the logs, records and checkpoints; ``--bn_groups``
and the world size must then divide the global batch (a group may span
ranks), and of the eval modes only AttnGAN's ``sampling`` dump shards
(the others run on rank 0). ``MOG_REMAT=0|full|convs|dots`` recomputes
the train steps' regions in their backward (``train/remat.py``). A float32
run on the card computes in float32: TF32 is turned off
(``float32_policy``, as the server does).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import random
import shutil
import subprocess
import sys
import warnings

import numpy as np
import torch

from multiple_objects_gan_tpu_torch import float32_policy, resolve_device
from multiple_objects_gan_tpu_torch.cli.attngan_runner import (
    EVAL_MODES, eval_mode, run_attngan, run_attngan_eval)
from multiple_objects_gan_tpu_torch.cli.damsm_runner import run_damsm
from multiple_objects_gan_tpu_torch.cli.sample import sample_stage1
from multiple_objects_gan_tpu_torch.cli.stage2_runner import (
    run_stage2, sample_stage2)
from multiple_objects_gan_tpu_torch.config.config import (
    attngan_model_config, cfg_from_file, stage1_model_config,
    stage2_model_config, train_settings)
from multiple_objects_gan_tpu_torch.data.attngan import (
    write_synthetic_attngan)
from multiple_objects_gan_tpu_torch.data.coco import (
    CocoStackganDataset, write_synthetic_coco)
from multiple_objects_gan_tpu_torch.data.datasets import (
    MNIST_VARIANT, ClevrDataset, Loader, MultiMnistDataset,
    write_synthetic_clevr, write_synthetic_multimnist)
from multiple_objects_gan_tpu_torch.parallel.multihost import (
    barrier, destroy_distributed, is_main_process,
    maybe_initialize_distributed, rank_device, shard_loader_kwargs,
    world_size)
from multiple_objects_gan_tpu_torch.train.loop import train

VARIANTS = ("multi-mnist", "clevr", "coco-stackgan-1", "coco-stackgan-2",
            "coco-attngan", "damsm")
# the variants of the AttnGAN set (data/attngan.py)
ATTNGAN_SETS = ("coco-attngan", "damsm")
SAMPLE_TEST_ITEMS = 32   # a --synthetic stage-2 sampling run's test split
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's sources that define a run, copied into src_snapshot/
SNAPSHOT_DIRS = ("cli", "config", "models", "train", "losses", "nn", "ops",
                 "data", "csrc")
# the items of a --synthetic train set (JAX cli/main.py:248-256,274-284)
SYNTHETIC_ITEMS = {"multi-mnist": 512, "clevr": 256}


def synthetic_items(variant: str, batch: int) -> int:
    """The items of ``variant``'s --synthetic train set: the on-disk sizes,
    and for COCO at least 2 full batches (else the drop-last loop is
    empty), at least 64 for StackGAN and 32 for AttnGAN and DAMSM."""
    least = 32 if variant in ATTNGAN_SETS else 64
    return SYNTHETIC_ITEMS.get(variant, max(2 * batch, least))


def coco_data(args, cfg, seed: int, device, split: str = "train") -> None:
    """A COCO set in DATA_DIR/IMG_DIR: with ``--synthetic`` its ``split`` is
    written there when missing (StackGAN: ``write_synthetic_coco``, the
    test split of a sampling run at 32 items; AttnGAN and DAMSM:
    ``write_synthetic_attngan``, both splits), as the JAX CLI writes it
    (``cli/main.py:320-373``, ``cli/stage2_runner.py:60-66,111-123``);
    without it a missing split exits with its path. Under a process
    group rank 0 writes and every rank waits for it."""
    if not os.path.isfile(os.path.join(cfg.DATA_DIR, split,
                                       "filenames.pickle")):
        if not args.synthetic:
            sys.exit(f"COCO data not found under {cfg.DATA_DIR} (no {split}"
                     " split; pass --synthetic to generate one)")
        n = (SAMPLE_TEST_ITEMS if split == "test" else
             synthetic_items(args.variant, int(cfg.TRAIN.BATCH_SIZE)))
        if is_main_process() and args.variant in ATTNGAN_SETS:
            write_synthetic_attngan(cfg.DATA_DIR, cfg.IMG_DIR, n=n,
                                    seed=seed, device=device)
        elif is_main_process():
            write_synthetic_coco(cfg.DATA_DIR, cfg.IMG_DIR, n=n, split=split,
                                 seed=seed, device=device)
    barrier()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variant", required=True, choices=VARIANTS)
    p.add_argument("--cfg", dest="cfg_file", required=True)
    p.add_argument("--data_dir", default="", help="override cfg DATA_DIR")
    p.add_argument("--img_dir", default="",
                   help="override cfg IMG_DIR (the COCO JPEG directory)")
    p.add_argument("--output_dir", default="")
    p.add_argument("--synthetic", action="store_true",
                   help="write a synthetic split to DATA_DIR (and COCO's "
                        "JPEGs to IMG_DIR) when it is missing")
    p.add_argument("--resume", default="",
                   help="output dir of a previous run to resume from")
    p.add_argument("--max_epochs", type=int, default=None,
                   help="stop after this many epochs (default TRAIN.MAX_EPOCH)")
    p.add_argument("--snapshot_interval", type=int, default=None,
                   help="override TRAIN.SNAPSHOT_INTERVAL (the last epoch "
                        "is always checkpointed)")
    p.add_argument("--manualSeed", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 activations: convs and linears compute in "
                        "bf16; weights, Adam state and BatchNorm running "
                        "statistics stay float32")
    p.add_argument("--bn_groups", type=int, default=1,
                   help="train-mode BatchNorm statistic groups: 1 = the "
                        "whole batch (default), G > 1 = per-replica "
                        "DataParallel statistics over G contiguous batch "
                        "chunks, as a G-GPU reference run computes them")
    p.add_argument("--stochastic_ca", action="store_true",
                   help="stage-2 sampling: draw the CA noise (the "
                        "reference's eval, stackgan model.py:66-71) "
                        "instead of c = mu")
    p.add_argument("--num_objects", type=int, default=None,
                   help="sampling: truncate or extend each layout's objects "
                        "(ref trainer.py:219-243)")
    p.add_argument("--bbox_scale", type=float, default=None,
                   help="sampling: scale every box's w and h (ref "
                        "trainer.py:245-253)")
    p.add_argument("--eval_mode", default="auto", choices=EVAL_MODES,
                   help="coco-attngan with TRAIN.FLAG False: auto = sample "
                        "under B_VALIDATION, else gen_example (ref "
                        "main.py:153-160); sampling = the single-image "
                        "dump with FID and IS")
    p.add_argument("--num_images", type=int, default=0,
                   help="--eval_mode sampling: cap the dump (0 = the whole "
                        "test split)")
    p.add_argument("--profile", default="",
                   help="directory for a torch.profiler trace of steps 2-5 "
                        "of the first epoch")
    return p.parse_args(argv)


def check_resume_flags(resume_dir: str, **current) -> list:
    """Warn for each knob that differs from the resumed run's
    ``run_flags.json`` (a resumed run that forgets ``--bf16`` or
    ``--bn_groups`` silently changes its training); returns their keys."""
    path = os.path.join(resume_dir, "run_flags.json")
    if not os.path.isfile(path):
        return []
    with open(path) as f:
        prev = json.load(f)
    mismatched = []
    for key, cur in current.items():
        if key in prev and prev[key] != cur:
            mismatched.append(key)
            warnings.warn(
                f"--resume: {key} differs from the original run "
                f"({prev[key]!r} -> {cur!r}); training dynamics will change "
                "mid-run; pass the original flag unless this is intended",
                UserWarning)
    return mismatched


def record_run_flags(output_dir: str, resume: str | None, **flags) -> str:
    """Check the knobs against the resumed run, then record them in
    ``<output_dir>/run_flags.json`` with the git sha of the code. An
    in-place resume (``--resume`` = ``--output_dir``) keeps the original
    record, so later resumes still compare against the run's origin.
    Returns the record's path."""
    if resume:
        check_resume_flags(resume, **{k: flags[k] for k in (
            "bn_groups", "bf16", "manualSeed") if k in flags})
    path = os.path.join(output_dir, "run_flags.json")
    in_place = bool(resume and os.path.isfile(path) and os.path.isdir(resume)
                    and os.path.samefile(resume, output_dir))
    if not in_place:
        sha = _git_sha()
        if sha:
            flags = dict(flags, git_sha=sha)
        with open(path, "w") as f:
            json.dump(flags, f)
    return path


def resumed_seed(resume_dir: str):
    """The ``manualSeed`` of the run in ``resume_dir`` (its
    ``run_flags.json``), or None when it has no record."""
    path = os.path.join(resume_dir, "run_flags.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f).get("manualSeed")


def _git_sha() -> str:
    """HEAD of the repository holding the port, with ``-dirty`` when its
    tracked files have changes; '' outside a git checkout."""
    repo = os.path.dirname(PKG_ROOT)
    try:
        sha = subprocess.run(
            ["git", "-C", repo, "rev-parse", "HEAD"], capture_output=True,
            text=True, timeout=10, check=True).stdout.strip()
        dirty = subprocess.run(
            ["git", "-C", repo, "status", "--porcelain",
             "--untracked-files=no", "--", ".", ":(exclude)PROGRESS.jsonl"],
            capture_output=True, text=True, timeout=10,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""
    return sha + ("-dirty" if dirty else "")


def train_loader(args, cfg, variant: str, seed: int, device,
                 stage: int = 1):
    """The variant's train loader: Multi-MNIST and CLEVR from DATA_DIR,
    COCO StackGAN (``stage`` 1 or 2) from DATA_DIR and IMG_DIR, each
    written there first with ``--synthetic`` when missing (by rank 0 under
    a process group), with this rank's share of the global batch and its
    shard of the order (``shard_loader_kwargs``)."""
    batch = train_settings(cfg).batch_size
    shard = shard_loader_kwargs(batch)
    imsize = int(cfg.IMSIZE)
    if variant.startswith("coco-stackgan"):
        coco_data(args, cfg, seed, device)
        ds = CocoStackganDataset(cfg.DATA_DIR, cfg.IMG_DIR, split="train",
                                 stage=stage, imsize=imsize, seed=seed,
                                 device=device)
        return Loader(ds, seed=seed, **shard)
    marker = os.path.join(cfg.DATA_DIR, "train",
                          MNIST_VARIANT if variant == "multi-mnist"
                          else "scenes")
    if not os.path.isdir(marker):
        if not args.synthetic:
            sys.exit(f"dataset not found at {marker} (pass --synthetic to "
                     "generate one)")
        write = (write_synthetic_multimnist if variant == "multi-mnist"
                 else write_synthetic_clevr)
        if is_main_process():
            write(cfg.DATA_DIR, n=synthetic_items(variant, batch),
                  split="train", seed=seed, imsize=imsize)
    barrier()
    if variant == "multi-mnist":
        ds = MultiMnistDataset(cfg.DATA_DIR, split="train", imsize=imsize)
    else:
        ds = ClevrDataset(cfg.DATA_DIR, split="train", imsize=imsize,
                          seed=seed)
    return Loader(ds, seed=seed, **shard)


def snapshot_sources(output_dir: str) -> None:
    """Copy the port's sources that define the run into
    ``<output_dir>/src_snapshot`` (code/multi-mnist/main.py:71-76)."""
    snap = os.path.join(output_dir, "src_snapshot")
    for rel in SNAPSHOT_DIRS:
        src = os.path.join(PKG_ROOT, rel)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(snap, rel), dirs_exist_ok=True,
                            ignore=shutil.ignore_patterns("__pycache__"))


def main(argv=None) -> list[dict]:
    """Run what the arguments ask for. Training returns the per-epoch mean
    losses of :func:`~multiple_objects_gan_tpu_torch.train.loop.run_epochs`;
    sampling returns an empty list. The process group the environment
    describes (``parallel/multihost.py``) is joined first and left at the
    end."""
    args = parse_args(argv)
    owns_group = not torch.distributed.is_initialized()
    maybe_initialize_distributed(args.device)
    try:
        return _run(args)
    finally:
        if owns_group:
            destroy_distributed()


def check_bn_groups(groups: int, batch_size: int) -> None:
    """Exit where the JAX package fails too: ``groups`` > 1 BatchNorm
    chunks of a global batch of ``batch_size`` that they, or the world
    size, do not divide (the object pathways' chunks must be whole, and so
    must the ranks' shares). Any other count of groups runs at any world
    size: a chunk may span ranks (``nn/blocks.py``)."""
    world = world_size()
    if groups > 1 and (batch_size % groups or batch_size % world):
        sys.exit(f"--bn_groups {groups} over {world} processes at global "
                 f"batch {batch_size} is not supported: the groups and the "
                 "world size must divide the batch")


def _run(args) -> list[dict]:
    device = rank_device(resolve_device(args.device))
    cfg = cfg_from_file(args.cfg_file, args.variant)
    if args.data_dir:
        cfg.DATA_DIR = args.data_dir
    if args.img_dir and "IMG_DIR" in cfg:
        cfg.IMG_DIR = args.img_dir
    if args.snapshot_interval is not None:
        cfg.TRAIN.SNAPSHOT_INTERVAL = args.snapshot_interval
    seed = args.manualSeed
    if seed is None and args.resume:
        seed = resumed_seed(args.resume)
        if seed is None:
            warnings.warn(f"--resume: {args.resume} records no manualSeed; "
                          "the resumed epochs shuffle with a new seed",
                          UserWarning)
        else:
            print(f"seed {seed} from {args.resume}/run_flags.json",
                  flush=True)
    if seed is None:
        seed = random.randint(1, 10000)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    dtype = torch.bfloat16 if args.bf16 else None
    float32_policy(device, dtype)
    # both StackGAN variants go where cfg STAGE says (JAX run_stackgan)
    stackgan = args.variant.startswith("coco-stackgan")
    stage2 = stackgan and int(cfg.STAGE) == 2
    attn = args.variant in ATTNGAN_SETS
    damsm = args.variant == "damsm"
    # a stage-1 StackGAN cfg trains whatever TRAIN.FLAG says, as there
    training = bool(cfg.TRAIN.FLAG) or damsm or (stackgan and not stage2)
    if training and not damsm:
        check_bn_groups(args.bn_groups, int(cfg.TRAIN.BATCH_SIZE))
    mode = None
    if attn:
        # damsm's backbone runs in eval mode and its text encoder has no
        # BatchNorm: the flag is recorded and changes nothing, as in JAX
        mcfg = attngan_model_config(cfg, compute_dtype=dtype,
                                    bn_groups=args.bn_groups)
        if not training:
            mode = eval_mode(args.eval_mode, cfg)
    elif stage2:
        s1_cfg, mcfg = stage2_model_config(cfg, compute_dtype=dtype,
                                           bn_groups=args.bn_groups)
    else:
        mcfg = stage1_model_config(
            cfg, "coco-stackgan-1" if stackgan else args.variant,
            compute_dtype=dtype, bn_groups=args.bn_groups)
    loader = None
    if attn:
        coco_data(args, cfg, seed, device)
    elif stage2 and not training:
        coco_data(args, cfg, seed, device, split="test")
    elif training:
        loader = train_loader(args, cfg, args.variant, seed, device,
                              stage=2 if stage2 else 1)
    now = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    output_dir = args.output_dir or os.path.join(
        "output", f"{cfg.DATASET_NAME}_{now}")
    os.makedirs(output_dir, exist_ok=True)
    if is_main_process():
        record_run_flags(output_dir, args.resume, bn_groups=args.bn_groups,
                         bf16=bool(args.bf16), variant=args.variant,
                         manualSeed=seed, world_size=world_size())
        cfg_copy = os.path.join(output_dir, os.path.basename(args.cfg_file))
        if not (os.path.exists(cfg_copy)
                and os.path.samefile(args.cfg_file, cfg_copy)):
            shutil.copyfile(args.cfg_file, cfg_copy)
    barrier()

    if not (training or mode == "sampling" or is_main_process()):
        barrier()     # one process samples; only the dump shards
        return []
    if mode is not None:
        print(f"coco-attngan {mode} on {device}: gf {mcfg.gf_dim}, "
              f"{mcfg.branch_num} branches, seed {seed}, "
              f"{'bf16' if args.bf16 else 'float32'}; data {cfg.DATA_DIR}; "
              f"output {output_dir}", flush=True)
        run_attngan_eval(cfg, mcfg, output_dir, mode, device=device,
                         seed=seed, num_images=args.num_images)
        barrier()
        return []
    if stage2 and not training:
        print(f"coco-stackgan stage 2 sampling on {device}: gf "
              f"{mcfg.gf_dim}, frozen stage-1 G ngf {s1_cfg.ngf}, seed "
              f"{seed}, {'stochastic CA' if args.stochastic_ca else 'c = mu'}"
              f"; data {cfg.DATA_DIR}, images {cfg.IMG_DIR}; output "
              f"{output_dir}", flush=True)
        sample_stage2(cfg, s1_cfg, mcfg, output_dir, seed=seed,
                      device=device, stochastic_ca=args.stochastic_ca)
        barrier()
        return []
    if not training:
        sample_stage1(args, cfg, mcfg, output_dir, args.variant, seed,
                      device=device)
        barrier()
        return []
    if not args.resume and cfg.TRAIN.FLAG and is_main_process():
        snapshot_sources(output_dir)
    if damsm:
        print(f"damsm on {device}: embedding {mcfg.embedding_dim}, "
              f"{cfg.TEXT.WORDS_NUM} words, "
              f"{cfg.TREE.BASE_SIZE * 2 ** (cfg.TREE.BRANCH_NUM - 1)}px, "
              f"batch {cfg.TRAIN.BATCH_SIZE}, ENCODER_LR "
              f"{cfg.TRAIN.ENCODER_LR:g}, RNN_GRAD_CLIP "
              f"{cfg.TRAIN.RNN_GRAD_CLIP:g}, seed {seed}, "
              f"{'bf16' if args.bf16 else 'float32'}; data {cfg.DATA_DIR}; "
              f"output {output_dir}", flush=True)
        return run_damsm(cfg, output_dir, device=device, seed=seed,
                         compute_dtype=dtype, max_epochs=args.max_epochs,
                         resume_dir=args.resume or None,
                         profile_dir=args.profile or None)
    if attn:
        print(f"coco-attngan on {device}: gf {mcfg.gf_dim}, df "
              f"{mcfg.df_dim}, R_NUM {mcfg.r_num}, {mcfg.branch_num} "
              f"branches, batch {cfg.TRAIN.BATCH_SIZE}, seed {seed}, "
              f"{'bf16' if args.bf16 else 'float32'}; data {cfg.DATA_DIR}; "
              f"output {output_dir}", flush=True)
        return run_attngan(cfg, mcfg, output_dir, device=device, seed=seed,
                           max_epochs=args.max_epochs,
                           resume_dir=args.resume or None,
                           profile_dir=args.profile or None)
    kl = f", KL x {train_settings(cfg).kl_coeff:g}" if mcfg.use_ca else ""
    width = (f"gf {mcfg.gf_dim}, df {mcfg.df_dim}, R_NUM {mcfg.r_num}, "
             f"frozen stage-1 G ngf {s1_cfg.ngf}" if stage2 else
             f"ngf {mcfg.ngf}, ndf {mcfg.df_dim}")
    ranks = f" a rank of {world_size()}" if world_size() > 1 else ""
    print(f"{args.variant} stage {2 if stage2 else 1} on {device}: {width}, "
          f"{mcfg.num_objects} objects, batch {loader.bs}{ranks}, "
          f"{len(loader)} steps an epoch, seed {seed}, "
          f"{'bf16' if args.bf16 else 'float32'}, BatchNorm groups "
          f"{mcfg.bn_groups}{kl}; output {output_dir}", flush=True)
    if stage2:
        return run_stage2(cfg, s1_cfg, mcfg, loader, output_dir,
                          device=device, seed=seed,
                          max_epochs=args.max_epochs,
                          resume_dir=args.resume or None,
                          profile_dir=args.profile or None)
    _, history = train(cfg, mcfg, loader, output_dir, device=device,
                       seed=seed, max_epochs=args.max_epochs,
                       resume_dir=args.resume or None,
                       profile_dir=args.profile or None)
    return history


if __name__ == "__main__":
    main(sys.argv[1:])
