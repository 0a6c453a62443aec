"""COCO StackGAN stage-2 training with the PyTorch port (the port's
counterpart of the JAX package's ``cli/stage2_runner.py:run_stage2``).

Parity target: the STAGE=2 branch of code/coco/stackgan/trainer.py:110-114,
155-260. A frozen stage-1 G, loaded from cfg ``STAGE1_G`` (a
reference-format ``.pth``), makes the 64px images the stage-2 G refines to
256px; D works at 256px with the stage-2 boxes. Without a ``STAGE1_G`` file
the frozen G keeps the reference's random init, with a warning, as the JAX
runner does. cfg ``NET_G``/``NET_D`` ``.pth`` files warm-start G2 (and
G1, from NET_G's ``STAGE1_G.`` part) and D2. Checkpoints hold stage 2
alone; a resume takes G1 from STAGE1_G and NET_G again.

Left for COCO's on-disk reader (ROADMAP Queue 1, item 9b): sampling
(``sample_stage2``, JAX ``cli/stage2_runner.py:190-321``), which reads the
test split's JPEGs or ``val_captions.t7``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from multiple_objects_gan_tpu_torch.config.config import train_settings
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.io.weights import (
    load_reference_g, warm_start)
from multiple_objects_gan_tpu_torch.models.common import Stage1Config
from multiple_objects_gan_tpu_torch.models.stage1 import Stage1G, build_stage1_g
from multiple_objects_gan_tpu_torch.train.loop import grid_noise, run_epochs
from multiple_objects_gan_tpu_torch.train.state import create_state_stage2
from multiple_objects_gan_tpu_torch.train.step import make_stage2_train_step
from multiple_objects_gan_tpu_torch.utils.images import save_grid
from multiple_objects_gan_tpu_torch.utils.logging import MetricWriter

GRID_ITEMS = 16          # the epoch grid: 16 images, 4 a row (JAX :146-165)
GRID_ROW = 4


def frozen_stage1_g(s1_cfg: Stage1Config, path: str, *, seed: int,
                    device) -> Stage1G:
    """The frozen stage-1 G in eval mode without gradients: the
    reference-format ``.pth`` at ``path`` (cfg STAGE1_G) loaded with
    strict=True, or, when there is no such file, the reference's random
    init from ``seed`` and a WARNING (JAX ``cli/stage2_runner.py:51-59``).
    """
    if path and os.path.isfile(path):
        g1 = build_stage1_g(s1_cfg, load_reference_g(path), device=device)
        print(f"Load from: {path}", flush=True)
    else:
        print(f"WARNING: STAGE1_G={path!r} not found — using randomly "
              "initialized stage-1 weights", flush=True)
        g1 = build_stage1_g(s1_cfg, seed=seed, device=device)
    return g1.requires_grad_(False)


def stage2_images(g1: Stage1G, g2, z: torch.Tensor, batch: dict,
                  eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """G1 then G2 in eval mode without autograd: (B, 3, 256, 256) float32
    (JAX ``cli/stage2_runner.py:144-152``). ``eps`` None gives c = mu in
    both CA nets; the service passes one draw to both, as the JAX service
    passes one CA key."""
    g1.eval()
    g2.eval()
    labels, text = batch["label_onehot"], batch["text_embedding"]
    with torch.inference_mode():
        s1 = g1(z, batch["bbox"], labels, text, eps)
        return g2(s1, batch["bbox"], batch["bbox_s2"], labels, text,
                  eps).float()


def run_stage2(cfg, s1_cfg: Stage1Config, s2_cfg: Stage1Config, loader,
               output_dir: str, *, device, seed: int = 0,
               max_epochs: Optional[int] = None,
               resume_dir: Optional[str] = None) -> list[dict]:
    """Train stage 2 (JAX ``run_stage2``): logs, grids and checkpoints
    under ``output_dir``, as the stage-1 run's (``train/loop.py:train``).
    Returns the per-epoch mean losses."""
    device = torch.device(device)
    settings = train_settings(cfg)
    g1 = frozen_stage1_g(s1_cfg, cfg.get("STAGE1_G", ""), seed=seed,
                         device=device)
    state = create_state_stage2(s2_cfg, seed=seed, device=device)
    for path in warm_start(state, cfg.get("NET_G", ""), cfg.get("NET_D", ""),
                           frozen_g=g1):
        print(f"Load from: {path}", flush=True)
    generator = torch.Generator(device=device).manual_seed(seed)
    start_epoch = 0
    if resume_dir:
        prev = CheckpointManager(os.path.join(resume_dir, "models"))
        if prev.latest_epoch() is not None:
            start_epoch = prev.restore(state, generator)[0] + 1
            print(f"resumed from {resume_dir} at epoch {start_epoch}",
                  flush=True)
    n_epochs = settings.max_epoch if max_epochs is None else int(max_epochs)
    img_dir = os.path.join(output_dir, "images")

    def epoch_grids(state, last_batch, epoch):
        b = min(GRID_ITEMS, last_batch["image"].shape[0])
        batch = {k: v[:b] for k, v in last_batch.items()}
        fake = stage2_images(g1, state.g, grid_noise(
            seed, epoch, b, s1_cfg.z_dim, device), batch)
        save_grid(fake.permute(0, 2, 3, 1).cpu().numpy(),
                  os.path.join(img_dir, f"fake_samples_epoch_{epoch:03d}.png"),
                  nrow=GRID_ROW)
        if epoch == start_epoch:
            save_grid(batch["image"].cpu().numpy(),
                      os.path.join(img_dir, "real_samples.png"),
                      nrow=GRID_ROW)

    writer = MetricWriter(os.path.join(output_dir, "logs"))
    try:
        return run_epochs(
            state, loader,
            make_stage2_train_step(s2_cfg, s1_cfg, g1, settings.kl_coeff),
            generator, lr_g=settings.generator_lr,
            lr_d=settings.discriminator_lr, n_epochs=n_epochs,
            start_epoch=start_epoch, lr_decay_epochs=settings.lr_decay_epoch,
            snapshot_every=int(cfg.TRAIN.SNAPSHOT_INTERVAL),
            ckpt=CheckpointManager(os.path.join(output_dir, "models")),
            writer=writer, epoch_end_fn=epoch_grids)
    finally:
        writer.close()
