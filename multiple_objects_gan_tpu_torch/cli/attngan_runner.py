"""COCO AttnGAN training with the PyTorch port (the port's counterpart of
the train path of the JAX package's ``cli/attngan_runner.py:run``).

Parity target: condGANTrainer.train (code/coco/attngan/trainer.py:249-366):
the frozen DAMSM encoders of cfg ``NET_E`` (:func:`init_encoders`), G and a
D a branch with their Adams and G's EMA, the warm start from a NET_G
``.pth`` (:func:`maybe_warm_start_attngan`), and per run:

* ``logs/metrics.jsonl``: the losses at the first step of every epoch and
  every 500 steps;
* ``images/fake_samples_step_NNNNNNN.png`` and
  ``images/attention_maps_step_NNNNNNN.png`` every 1000 steps, and
  ``..._epoch_NNN.png`` after every epoch (trainer.py:345-353): the
  eval-mode G's 256px images of up to 8 items of the last batch, and the
  first attention stage's maps over its 128px images, word by word
  (``utils/attention_viz.py``); ``images/real_samples.png`` once;
* ``models/<epoch>/state.pth`` every SNAPSHOT_INTERVAL epochs and after
  the last, with the train set's random state, so that ``--resume``
  continues bit for bit on the CPU.

The learning rates never decay (the reference's condGANTrainer keeps
them). The montages' z is drawn from (seed, step) and (seed, 1000000 +
epoch); they and the epoch grids key on the global step, so a resumed run
writes what an uninterrupted one writes (the JAX loop counts the steps of
each process from 0). The data are the in-memory synthetic train set
(``data/attngan.py:AttnGanTrainSet``). Left for later (ROADMAP Queue 1):
the eval modes ``sample``, ``sampling`` and ``gen_example``, and
``--profile``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from multiple_objects_gan_tpu_torch.config.config import (
    attngan_train_settings)
from multiple_objects_gan_tpu_torch.data.attngan import (
    AttnGanTrainSet, synthetic_train_images)
from multiple_objects_gan_tpu_torch.data.datasets import Loader
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.io.weights import (
    load_image_encoder, load_reference_attngan_d, load_reference_attngan_g,
    load_text_encoder)
from multiple_objects_gan_tpu_torch.models.attngan import AttnGanConfig
from multiple_objects_gan_tpu_torch.nn.encoders import (
    build_image_encoder, build_text_encoder)
from multiple_objects_gan_tpu_torch.train.attngan_step import (
    make_attngan_train_step)
from multiple_objects_gan_tpu_torch.train.loop import grid_noise, run_epochs
from multiple_objects_gan_tpu_torch.train.state import (
    AttnGanTrainState, create_attngan_state)
from multiple_objects_gan_tpu_torch.utils.attention_viz import (
    save_attention_montage)
from multiple_objects_gan_tpu_torch.utils.images import save_grid
from multiple_objects_gan_tpu_torch.utils.logging import MetricWriter

VIZ_ITEMS = 8            # items of a montage (JAX :284)
VIZ_EVERY = 1000         # steps between montages (trainer.py:345-353)
EPOCH_NOISE_KEY = 1_000_000


def init_encoders(net_e: str, n_words: int, mcfg: AttnGanConfig, *, seed,
                  device):
    """The frozen DAMSM text and image encoders (JAX ``init_encoders``,
    :65-102) and their provenance, ``{"text_encoder": "imported" |
    "random", "image_encoder": ...}``. The text encoder is NET_E's
    ``text_encoder*.pth`` when it exists, else random after a WARNING; the
    image encoder the file of the same name with ``text_encoder`` replaced
    by ``image_encoder`` beside it, else random after a WARNING. An
    imported text encoder keeps its own embedding rows, as the JAX import
    does; it must have one for every word of the vocabulary. The image
    encoder's backbone computes in ``mcfg.compute_dtype``."""
    prov = {"text_encoder": "random", "image_encoder": "random"}
    text_sd = image_sd = None
    if net_e and os.path.exists(net_e):
        text_sd = load_text_encoder(net_e)
        rows = text_sd["encoder.weight"].shape[0]
        if rows < n_words:
            raise ValueError(f"NET_E={net_e!r} embeds {rows} words, the "
                             f"vocabulary has {n_words}")
        n_words = rows
        prov["text_encoder"] = "imported"
        print(f"Load text encoder from: {net_e}", flush=True)
        img_path = net_e.replace("text_encoder", "image_encoder")
        if os.path.exists(img_path):
            image_sd = load_image_encoder(img_path)
            prov["image_encoder"] = "imported"
            print(f"Load image encoder from: {img_path}", flush=True)
        else:
            print(f"WARNING: {img_path!r} not found: the DAMSM image encoder "
                  "uses random weights", flush=True)
    else:
        print(f"WARNING: NET_E={net_e!r} not found: DAMSM encoders use "
              "random weights", flush=True)
    text_enc = build_text_encoder(n_words, mcfg.embedding_dim, text_sd,
                                  seed=seed, device=device)
    image_enc = build_image_encoder(mcfg.embedding_dim, image_sd, seed=seed,
                                    compute_dtype=mcfg.compute_dtype,
                                    device=device)
    return text_enc.requires_grad_(False), image_enc, prov


def maybe_warm_start_attngan(state: AttnGanTrainState, net_g: str,
                             b_net_d: bool = True) -> int:
    """The NET_G ``.pth`` warm start (reference build_models,
    trainer.py:110-126; JAX ``maybe_warm_start_attngan``): G loaded
    strictly and the EMA seeded from it; with B_NET_D the ``netD{i}.pth``
    beside it, each missing one a WARNING (the reference would stop).
    Returns the start epoch the file's name gives (``..._<epoch>.pth`` ->
    epoch + 1), else 0."""
    if not (net_g.endswith(".pth") and os.path.exists(net_g)):
        return 0
    state.g.load_state_dict(load_reference_attngan_g(net_g), strict=True)
    with torch.no_grad():
        for k, p in state.g.named_parameters():
            state.g_ema[k].copy_(p)
    print(f"Load G from: {net_g}", flush=True)
    tail = net_g[net_g.rfind("_") + 1:net_g.rfind(".")]
    start_epoch = int(tail) + 1 if tail.isdigit() else 0
    if b_net_d:
        for i, (name, d) in enumerate(state.ds.items()):
            path = os.path.join(os.path.dirname(net_g), f"netD{i}.pth")
            if not os.path.exists(path):
                print(f"WARNING: {path} not found: {name} keeps its random "
                      "init (the reference would stop; B_NET_D: False "
                      "silences this)", flush=True)
                continue
            d.load_state_dict(load_reference_attngan_d(path), strict=True)
            print(f"Load D from: {path}", flush=True)
    return start_epoch


def _record_encoders(output_dir: str, prov: dict, net_e: str,
                     smooth_lambda: float) -> None:
    """Add the encoders' provenance, NET_E and LAMBDA to the run's
    ``run_flags.json`` (JAX :223-235): a run with random encoders is
    another experiment."""
    path = os.path.join(output_dir, "run_flags.json")
    if not os.path.isfile(path):
        return
    with open(path) as f:
        flags = json.load(f)
    flags.update(encoders=prov, net_e=net_e, smooth_lambda=smooth_lambda)
    with open(path, "w") as f:
        json.dump(flags, f, indent=1, sort_keys=True)


def run_attngan(cfg, mcfg: AttnGanConfig, output_dir: str, *, device,
                seed: int = 0, max_epochs: Optional[int] = None,
                resume_dir: Optional[str] = None) -> list[dict]:
    """Train AttnGAN on the synthetic set in cfg DATA_DIR (JAX ``run``,
    :185-331). Returns the per-epoch mean losses."""
    device = torch.device(device)
    st = attngan_train_settings(cfg)
    ds = AttnGanTrainSet(cfg.DATA_DIR,
                         synthetic_train_images(cfg.DATA_DIR, seed,
                                                st.captions_per_image),
                         base_size=st.base_size, branch_num=st.branch_num,
                         captions_per_image=st.captions_per_image,
                         words_num=st.words_num, seed=seed)
    text_enc, image_enc, prov = init_encoders(st.net_e, ds.n_words, mcfg,
                                              seed=seed, device=device)
    _record_encoders(output_dir, prov, st.net_e,
                     float(st.smooth.get("LAMBDA", 0.0)))
    state = create_attngan_state(mcfg, seed=seed, device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    start_epoch = 0
    if resume_dir:
        prev = CheckpointManager(os.path.join(resume_dir, "models"))
        if prev.latest_epoch() is not None:
            epoch, extra = prev.restore(state, generator)
            ds.set_rng_state(extra["data_rng"])
            start_epoch = epoch + 1
            print(f"resumed from {resume_dir} at epoch {start_epoch}",
                  flush=True)
    if start_epoch == 0:
        start_epoch = maybe_warm_start_attngan(state, st.net_g, st.b_net_d)
    n_epochs = st.max_epoch if max_epochs is None else int(max_epochs)
    img_dir = os.path.join(output_dir, "images")

    def viz(state, batch, noise_key: int, tag: str):
        b = min(VIZ_ITEMS, batch["captions"].shape[0])
        caps, lens = batch["captions"][:b], batch["cap_lens"][:b]
        g = state.g.eval()
        try:
            with torch.inference_mode():
                words, sent = text_enc(caps, lens)
                out = g.outputs(grid_noise(seed, noise_key, b, mcfg.z_dim,
                                           device),
                                sent, words, caps == 0, batch["bbox"][:b],
                                batch["label_onehot"][:b])
        finally:
            g.train()
        imgs = [im.float().permute(0, 2, 3, 1).cpu().numpy()
                for im in out.imgs]
        save_grid(imgs[-1], os.path.join(img_dir, f"fake_samples_{tag}.png"),
                  nrow=4)
        if out.att_maps:
            save_attention_montage(
                os.path.join(img_dir, f"attention_maps_{tag}.png"),
                imgs[1] if len(imgs) > 1 else imgs[0],
                out.att_maps[0].float().cpu().numpy(), caps.cpu().numpy(),
                ds.ixtoword, lens.cpu().numpy())

    def epoch_end(state, batch, epoch):
        viz(state, batch, EPOCH_NOISE_KEY + epoch, f"epoch_{epoch:03d}")
        if epoch == start_epoch:
            top = f"image{ds.imsizes[-1]}"
            save_grid(batch[top][:VIZ_ITEMS].cpu().numpy(),
                      os.path.join(img_dir, "real_samples.png"), nrow=4)

    def step_viz(state, batch, step):
        if step % VIZ_EVERY == 0:
            viz(state, batch, step, f"step_{step:07d}")

    writer = MetricWriter(os.path.join(output_dir, "logs"))
    try:
        return run_epochs(
            state, Loader(ds, st.batch_size, seed=seed),
            make_attngan_train_step(mcfg, text_enc, image_enc,
                                    smooth=st.smooth),
            generator, lr_g=st.generator_lr, lr_d=st.discriminator_lr,
            n_epochs=n_epochs, start_epoch=start_epoch, lr_decay_epochs=0,
            snapshot_every=st.snapshot_interval,
            ckpt=CheckpointManager(os.path.join(output_dir, "models")),
            writer=writer, epoch_end_fn=epoch_end,
            step_hook=step_viz,
            checkpoint_extra=lambda: {"data_rng": ds.rng_state()})
    finally:
        writer.close()
