"""DAMSM encoder pretraining, ``--variant damsm`` (port of the JAX
package's ``cli/damsm_runner.py``).

The reference ships no DAMSM pretraining: its README has users download
the encoders from upstream AttnGAN. The JAX package trains them after
upstream's pretrain_DAMSM.py, and so does the port
(``train/damsm_step.py``):

* the encoders are random from the seed, the image encoder's backbone
  warm-started from a torchvision ``inception_v3`` state dict at
  ``$INCEPTION_V3_WEIGHTS`` (its ``AuxLogits.`` and ``fc.`` dropped, the
  heads left at their init), or both continued from cfg ``TRAIN.NET_E``'s
  ``text_encoder*.pth`` and the ``image_encoder*.pth`` beside it; with
  neither, a WARNING says that the frozen backbone is random;
* Adam(ENCODER_LR, betas=(0.5, 0.999)) over the text encoder and the image
  encoder's two heads, the learning rate x0.98 an epoch, floored at
  ENCODER_LR / 10 (:func:`damsm_lr`), the text encoder's gradients clipped
  at RNN_GRAD_CLIP;
* after each epoch, the losses on the test split (``eval_w_loss``,
  ``eval_s_loss``, ``eval_damsm_loss`` in ``logs/metrics.jsonl``, keyed by
  the epoch), when its ``filenames.pickle`` exists and it holds a batch;
* ``DAMSMencoders/text_encoder<E>.pth`` and ``image_encoder<E>.pth`` every
  SNAPSHOT_INTERVAL epochs and after the last, in the reference's format,
  so that any AttnGAN run can name them as NET_E;
* ``models/<epoch>/state.pth``: both encoders, the Adam, the step, the
  dropout's generator, and both splits' random states (every rank's under
  a process group), so that ``--resume`` continues bit for bit on the
  CPU.

Under a process group each rank trains on its shard of every global batch
(``parallel/``); the eval reads each test batch whole on every rank and
evaluates the rank's slice of it, and rank 0 logs it and exports the
encoders.

The data are DATA_DIR's splits with their JPEGs in IMG_DIR
(``data/attngan.py:AttnGanTrainSet``, decoded per batch on the run's
device): at cfg/coco_damsm.yml's BASE_SIZE
256 and BRANCH_NUM 1, one 256px crop an item, resized to 299 inside the
image encoder.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from multiple_objects_gan_tpu_torch.config.config import (
    attngan_train_settings)
from multiple_objects_gan_tpu_torch.data.attngan import attngan_split
from multiple_objects_gan_tpu_torch.data.datasets import Loader
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.io.weights import (
    export_damsm_encoders, load_image_encoder, load_inception_backbone,
    load_text_encoder)
from multiple_objects_gan_tpu_torch.nn.encoders import (
    build_image_encoder, build_text_encoder)
from multiple_objects_gan_tpu_torch.train.damsm_step import (
    make_damsm_eval_fn, make_damsm_train_step)
from multiple_objects_gan_tpu_torch.parallel import mesh
from multiple_objects_gan_tpu_torch.parallel.multihost import (
    is_main_process, shard_loader_kwargs)
from multiple_objects_gan_tpu_torch.train.loop import (
    restore_rng, rng_extra, run_epochs, to_device)
from multiple_objects_gan_tpu_torch.train.state import create_damsm_state
from multiple_objects_gan_tpu_torch.utils.logging import MetricWriter

BACKBONE_ENV = "INCEPTION_V3_WEIGHTS"


def damsm_lr(base_lr: float, epoch: int) -> float:
    """Upstream pretrain_DAMSM.py's schedule: x0.98 an epoch until
    ENCODER_LR / 10, then flat."""
    return max(base_lr * (0.98 ** epoch), base_lr / 10.0)


def init_damsm_encoders(net_e: str, n_words: int, nef: int, *, seed: int,
                        compute_dtype: Optional[torch.dtype] = None,
                        device="cuda"):
    """The text and image encoders DAMSM pretraining starts from (JAX
    :68-100): random from ``seed``; the backbone from
    ``$INCEPTION_V3_WEIGHTS`` when that file exists; then NET_E's pair
    where it exists (the text encoder keeps the file's embedding rows,
    which must cover the vocabulary). Both are returned in eval mode."""
    image = build_image_encoder(nef, seed=seed, compute_dtype=compute_dtype,
                                device=device)
    backbone = os.environ.get(BACKBONE_ENV, "")
    if backbone and os.path.exists(backbone):
        load_inception_backbone(image, backbone)
        print(f"Load Inception backbone from: {backbone}", flush=True)
    text_sd = None
    if net_e and os.path.exists(net_e):
        text_sd = load_text_encoder(net_e)
        rows = text_sd["encoder.weight"].shape[0]
        if rows < n_words:
            raise ValueError(f"NET_E={net_e!r} embeds {rows} words, the "
                             f"vocabulary has {n_words}")
        n_words = rows
        print(f"Load text encoder from: {net_e}", flush=True)
        img_path = net_e.replace("text_encoder", "image_encoder")
        if os.path.exists(img_path):
            image.load_state_dict(load_image_encoder(img_path), strict=True)
            print(f"Load image encoder from: {img_path}", flush=True)
    elif not backbone:
        print(f"WARNING: ${BACKBONE_ENV} unset and no NET_E: the frozen "
              "Inception backbone is RANDOM; the encoders will train but are "
              "not comparable to the published DAMSM", flush=True)
    return build_text_encoder(n_words, nef, text_sd, seed=seed,
                              device=device), image


def run_damsm(cfg, output_dir: str, *, device, seed: int = 0,
              compute_dtype: Optional[torch.dtype] = None,
              max_epochs: Optional[int] = None,
              resume_dir: Optional[str] = None,
              profile_dir: Optional[str] = None) -> list[dict]:
    """Pretrain the DAMSM encoders on cfg DATA_DIR and IMG_DIR (JAX
    ``run_damsm``, :45-194), with a torch.profiler trace into
    ``profile_dir`` when given. Returns the per-epoch mean losses."""
    device = torch.device(device)
    st = attngan_train_settings(cfg)
    ds = attngan_split(cfg.DATA_DIR, cfg.IMG_DIR, st, seed, device=device)
    eval_ds = None
    if os.path.isfile(os.path.join(cfg.DATA_DIR, "test",
                                   "filenames.pickle")):
        eval_ds = attngan_split(cfg.DATA_DIR, cfg.IMG_DIR, st, seed, "test",
                                device=device)
        if len(eval_ds) < st.batch_size:
            eval_ds = None
    text, image = init_damsm_encoders(st.net_e, ds.n_words, st.embedding_dim,
                                      seed=seed, compute_dtype=compute_dtype,
                                      device=device)
    state = create_damsm_state(text, image)
    generator = torch.Generator(device=device).manual_seed(seed)
    start_epoch = 0
    if resume_dir:
        prev = CheckpointManager(os.path.join(resume_dir, "models"))
        if prev.latest_epoch() is not None:
            epoch, extra = prev.restore(state, generator)
            restore_rng(ds, extra, "data_rng")
            if eval_ds is not None:
                restore_rng(eval_ds, extra, "eval_rng")
            start_epoch = epoch + 1
            print(f"resumed from {resume_dir} at epoch {start_epoch}",
                  flush=True)
    mesh.replicate_state(state)
    n_epochs = st.max_epoch if max_epochs is None else int(max_epochs)
    enc_dir = os.path.join(output_dir, "DAMSMencoders")
    eval_fn = make_damsm_eval_fn(st.smooth)
    writer = MetricWriter(os.path.join(output_dir, "logs"))

    def epoch_end(state, batch, epoch):
        main = is_main_process()
        if eval_ds is not None:
            totals: dict = {}
            n = 0
            # every rank reads the whole batch and evaluates its slice
            # (JAX :163); eval_fn sums the ranks' shares
            for b in Loader(eval_ds, st.batch_size, seed=seed,
                            shuffle=False).epoch(0):
                for k, v in eval_fn(state, to_device(
                        mesh.shard_batch(b), device)).items():
                    totals[k] = totals.get(k, 0.0) + float(v)
                n += 1
            host = {f"eval_{k}": v / n for k, v in totals.items()}
            if main:
                writer.scalars(epoch, host)
                print("  eval: " + " ".join(
                    f"{k}={v:.4f}" for k, v in sorted(host.items())),
                    flush=True)
        if main and (st.snapshot_interval
                     and (epoch + 1) % st.snapshot_interval == 0
                     or epoch == n_epochs - 1):
            export_damsm_encoders(state.text, state.image, enc_dir, epoch)
            print(f"saved DAMSM .pth encoders (epoch {epoch}) to {enc_dir}",
                  flush=True)

    def extra():
        if eval_ds is None:
            return rng_extra(data_rng=ds)
        return rng_extra(data_rng=ds, eval_rng=eval_ds)

    try:
        return run_epochs(
            state, Loader(ds, seed=seed,
                          **shard_loader_kwargs(st.batch_size)),
            make_damsm_train_step(st.smooth, st.rnn_grad_clip), generator,
            lr_g=st.encoder_lr, lr_d=st.encoder_lr, n_epochs=n_epochs,
            start_epoch=start_epoch, snapshot_every=st.snapshot_interval,
            ckpt=CheckpointManager(os.path.join(output_dir, "models")),
            writer=writer, epoch_end_fn=epoch_end, checkpoint_extra=extra,
            lr_fn=lambda epoch: (damsm_lr(st.encoder_lr, epoch),) * 2,
            profile_dir=profile_dir)
    finally:
        writer.close()
