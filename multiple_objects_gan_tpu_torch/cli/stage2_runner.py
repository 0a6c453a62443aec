"""COCO StackGAN stage 2 with the PyTorch port: training and sampling (the
port's counterpart of the JAX package's ``cli/stage2_runner.py``).

Parity target: the STAGE=2 branch of code/coco/stackgan/trainer.py:110-114,
155-260. A frozen stage-1 G, loaded from cfg ``STAGE1_G`` (a
reference-format ``.pth``), makes the 64px images the stage-2 G refines to
256px; D works at 256px with the stage-2 boxes. Without a ``STAGE1_G`` file
the frozen G keeps the reference's random init, with a warning, as the JAX
runner does. cfg ``NET_G``/``NET_D`` ``.pth`` files warm-start G2 (and
G1, from NET_G's ``STAGE1_G.`` part) and D2. Checkpoints hold stage 2
alone; a resume takes G1 from STAGE1_G and NET_G again.

:func:`sample_stage2` (``TRAIN.FLAG: False``; JAX ``cli/stage2_runner.py:
182-321``, trainer.py:283-419) writes 25 grids of one row each, the real
image and 9 fakes of its layout and caption embedding, every box outlined
on every tile: from ``val_captions.t7`` when the test split has one, else
from the test split through ``data/coco.py:CocoStackganDataset``.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from multiple_objects_gan_tpu_torch.cli.sample import sample_noise
from multiple_objects_gan_tpu_torch.config.config import train_settings
from multiple_objects_gan_tpu_torch.data.coco import (
    CocoStackganDataset, labels_to_onehot)
from multiple_objects_gan_tpu_torch.data.nvjpeg import decode_batch
from multiple_objects_gan_tpu_torch.data.png import resize
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.io.pycompat import load_pickle
from multiple_objects_gan_tpu_torch.io.torchfile import load_val_captions
from multiple_objects_gan_tpu_torch.io.weights import (
    load_reference_g, split_stage2_g, warm_start)
from multiple_objects_gan_tpu_torch.models.common import Stage1Config
from multiple_objects_gan_tpu_torch.models.stage1 import Stage1G, build_stage1_g
from multiple_objects_gan_tpu_torch.models.stage2 import build_stage2_g
from multiple_objects_gan_tpu_torch.parallel import mesh
from multiple_objects_gan_tpu_torch.train.loop import (
    data_rng_extra, grid_noise, restore_data_rng, run_epochs,
    single_process)
from multiple_objects_gan_tpu_torch.train.state import create_state_stage2
from multiple_objects_gan_tpu_torch.train.step import make_stage2_train_step
from multiple_objects_gan_tpu_torch.utils.images import (
    draw_bboxes, save_grid, tile_uint8)
from multiple_objects_gan_tpu_torch.utils.logging import MetricWriter

GRID_ITEMS = 16          # the epoch grid: 16 images, 4 a row (JAX :146-165)
GRID_ROW = 4
SAMPLE_GRIDS = 25        # grids a sampling run (trainer.py:283-419)
SAMPLE_FAKES = 9         # a grid's row: the real image and 9 fakes
CA_NOISE_KEY = 10_000    # the CA eps of grid s is drawn from (seed, 10000+s)


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
               resume_dir: Optional[str] = None,
               profile_dir: Optional[str] = None) -> list[dict]:
    """Train stage 2 (JAX ``run_stage2``): logs, grids and checkpoints
    under ``output_dir``, as the stage-1 run's (``train/loop.py:train``,
    under a process group too), and a torch.profiler trace into
    ``profile_dir`` when given. Returns the per-epoch mean losses."""
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
            epoch, extra = prev.restore(state, generator)
            restore_data_rng(loader, extra)
            start_epoch = epoch + 1
            print(f"resumed from {resume_dir} at epoch {start_epoch}",
                  flush=True)
    mesh.replicate_state(state)
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
            writer=writer, epoch_end_fn=single_process(epoch_grids),
            checkpoint_extra=data_rng_extra(loader),
            profile_dir=profile_dir)
    finally:
        writer.close()


def sampling_generators(cfg, s1_cfg: Stage1Config, s2_cfg: Stage1Config, *,
                        seed: int, device):
    """The frozen G1 and G2 a sampling run uses (JAX ``sample_stage2``,
    :211-231): G1 from cfg STAGE1_G (:func:`frozen_stage1_g`); G2 from cfg
    NET_G, a reference STAGE2_G ``.pth`` (its ``STAGE1_G.`` part, when it
    has one, into G1) or a port run directory (its latest checkpoint),
    else the reference's random init from ``seed`` after a WARNING."""
    g1 = frozen_stage1_g(s1_cfg, cfg.get("STAGE1_G", ""), seed=seed,
                         device=device)
    net_g, s2_sd = cfg.get("NET_G", ""), None
    if net_g and os.path.isfile(net_g):
        part1, s2_sd = split_stage2_g(load_reference_g(net_g))
        if part1 is not None:
            g1.load_state_dict(part1, strict=True)
        print(f"Load from: {net_g}", flush=True)
    elif net_g and os.path.isdir(net_g):
        mgr = CheckpointManager(os.path.join(net_g, "models"))
        if mgr.latest_epoch() is not None:
            ckpt, epoch = mgr.load()
            s2_sd = ckpt["g"]
            print(f"restored G2 from {net_g} (epoch {epoch})", flush=True)
    else:
        print(f"WARNING: NET_G={net_g!r} not found — sampling from random "
              "stage-2 weights", flush=True)
    return g1, build_stage2_g(s2_cfg, s2_sd, seed=seed, device=device)


def sample_inputs(seed: int, s: int, z_dim: int, c_dim: int,
                  stochastic_ca: bool):
    """Grid ``s``'s z (9, z_dim) and CA eps (9, c_dim), or None for c = mu:
    the stage-1 sampler's draw from (seed, s) and one from (seed, 10000 +
    s), as the JAX sampler folds s and 10000 + s into its key."""
    z = sample_noise(seed, s, SAMPLE_FAKES, z_dim)
    eps = (sample_noise(seed, CA_NOISE_KEY + s, SAMPLE_FAKES, c_dim)
           if stochastic_ca else None)
    return z, eps


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _caption_stem(caption: str) -> str:
    return "".join(c if c.isalnum() or c in " _-" else "_"
                   for c in caption).strip() or "sample"


def sample_stage2(cfg, s1_cfg: Stage1Config, s2_cfg: Stage1Config,
                  output_dir: str, *, seed: int, device,
                  stochastic_ca: bool = False,
                  num_samples: int = SAMPLE_GRIDS,
                  inputs: Optional[Callable] = None, g1=None,
                  g2=None) -> str:
    """Write ``num_samples`` grids to ``<output_dir>/samples`` (JAX
    ``sample_stage2``). Each picks a test item with ``RandomState(seed)``
    and renders it in one 10-tile row: the real image, then G2's images of
    9 z (and, under ``stochastic_ca``, one CA eps each, given to both CA
    nets; else c = mu), each tile outlined at the item's stage-2 boxes.

    With ``<DATA_DIR>/test/val_captions.t7`` the items are its captions
    and embeddings beside the validation pickles, the real image
    ``<IMG_DIR>/<filename>.jpg`` resized to IMSIZE with PIL's LANCZOS, the
    boxes unchanged at both scales, and each grid is named after its
    caption (``<caption>.png``); otherwise they are the test split's items
    through :class:`CocoStackganDataset` (its crop, flip and caption draw)
    and the grids are ``sample_NNN.png``. ``inputs(s)`` returns grid s's
    (z, eps) (default :func:`sample_inputs`); ``g1``/``g2`` default to
    :func:`sampling_generators`. Returns the directory."""
    device = torch.device(device)
    if g1 is None or g2 is None:
        g1, g2 = sampling_generators(cfg, s1_cfg, s2_cfg, seed=seed,
                                     device=device)
    if inputs is None:
        def inputs(s):
            return sample_inputs(seed, s, s1_cfg.z_dim, s1_cfg.condition_dim,
                                 stochastic_ca)
    imsize = int(cfg.IMSIZE)
    test_dir = os.path.join(cfg.DATA_DIR, "test")
    t7_path = os.path.join(test_dir, "val_captions.t7")
    captions = None
    if os.path.isfile(t7_path):
        captions, embeddings = load_val_captions(t7_path)
        bboxes = np.array(load_pickle(os.path.join(test_dir,
                                                   "bboxes.pickle")),
                          np.float32)
        labels = np.array(load_pickle(os.path.join(test_dir,
                                                   "labels.pickle")))
        names = load_pickle(os.path.join(test_dir, "filenames.pickle"))
        n_items = len(captions)
        print(f"Successfully load sentences from: {test_dir}", flush=True)
        print(f"Total number of sentences: {n_items}", flush=True)

        def get_item(index):
            path = os.path.join(cfg.IMG_DIR, f"{names[index]}.jpg")
            real = resize(_host(decode_batch([path], device)[0]),
                          (imsize, imsize), "lanczos")
            return {"image": real, "bbox": bboxes[index],
                    "bbox_s2": bboxes[index],
                    "label_onehot": labels_to_onehot(labels[index]),
                    "text_embedding": embeddings[index]}
    else:
        ds = CocoStackganDataset(cfg.DATA_DIR, cfg.IMG_DIR, split="test",
                                 stage=2, imsize=imsize, seed=seed,
                                 device=device)
        n_items = len(ds)
        get_item = ds.__getitem__

    out_dir = os.path.join(output_dir, "samples")
    os.makedirs(out_dir, exist_ok=True)
    rnd = np.random.RandomState(seed)
    n = SAMPLE_FAKES
    for s in range(num_samples):
        index = int(rnd.randint(n_items))
        item = get_item(index)
        batch = {k: torch.from_numpy(np.repeat(
            np.asarray(item[k], np.float32)[None], n, axis=0)).to(device)
            for k in ("bbox", "bbox_s2", "label_onehot", "text_embedding")}
        z, eps = inputs(s)
        fakes = stage2_images(
            g1, g2, torch.as_tensor(z, dtype=torch.float32).to(device),
            batch, None if eps is None else
            torch.as_tensor(eps, dtype=torch.float32).to(device))
        fakes = fakes.permute(0, 2, 3, 1).cpu().numpy()
        bb = np.asarray(item["bbox_s2"])
        tiles = [draw_bboxes(tile_uint8(_host(item["image"])), bb)]
        tiles += [draw_bboxes(tile_uint8(f), bb) for f in fakes]
        name = (f"{_caption_stem(captions[index])}.png" if captions
                is not None else f"sample_{s:03d}.png")
        save_grid(np.stack([t / 127.5 - 1.0 for t in tiles]),
                  os.path.join(out_dir, name), nrow=10)
    print(f"wrote {num_samples} stage-2 sample grids to {out_dir}",
          flush=True)
    return out_dir
