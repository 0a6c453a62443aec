"""COCO AttnGAN training and evaluation with the PyTorch port (the port's
counterpart of the JAX package's ``cli/attngan_runner.py``).

Parity target for training: condGANTrainer.train (code/coco/attngan/
trainer.py:249-366): the frozen DAMSM encoders of cfg ``NET_E``
(:func:`init_encoders`), G and a D a branch with their Adams and G's EMA,
the warm start from a NET_G ``.pth`` (:func:`maybe_warm_start_attngan`),
and per run:

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
each process from 0). The data are cfg DATA_DIR's train split with its
JPEGs in IMG_DIR (``data/attngan.py:AttnGanTrainSet``), decoded per batch
on the run's device. Under a process group (``parallel/``) each rank
trains on its shard of every global batch, the state replicated from rank
0; the montages and grids are left out (``train/loop.py``), and every
rank's reader state goes into the checkpoints.

With ``TRAIN.FLAG: False`` (:func:`run_attngan_eval`) the EMA G of cfg
NET_G (:func:`restore_g`) and the text encoder of NET_E run one of the
eval modes, picked as the reference's main.py:153-160 picks them under
``--eval_mode auto``:

* ``sample`` (B_VALIDATION True; trainer.py:474-579): for each of the
  first 25 test items, one row of 10 tiles, the real image and 9 fakes of
  its caption and layout with fresh z, the boxes' edges white on every
  tile, named after the caption's words (``samples/<words>_<i>.png``);
* ``gen_example`` (trainer.py:581-667): the captions of DATA_DIR's
  example files (:func:`load_example_captions`), every object's box at
  (0.3, 0.3, 0.4, 0.4), each scale's image and each attention stage's
  montage a caption (``<key>/0_s_<j>_g<k>.png``, ``..._a<k>.png``) and
  ``<key>.png``, the last scale 4 a row.

* ``sampling`` (trainer.py:387-472; JAX ``sampling``, :403-540): the
  test split in order, a batch at a time (cfg BATCH_SIZE, clamped to the
  split), each fake saved as ``single_samples/s_%06d.png`` up to
  ``--num_images``, then FID against the split's real images and the
  Inception Score, with their provenance, in ``eval_metrics.json``
  (:func:`sampling`).

z is the stage-1 sampler's draw from (seed, row), ``cli/sample.py:
sample_noise`` (row 0 for gen_example, whose caption files share it, as
in the JAX runner; for sampling the row is the count of images written
before the batch, as the JAX runner folds it into its key). Training
takes ``profile_dir`` (``--profile``): a torch.profiler trace of steps
2-5 of the first epoch (``train/loop.py:run_epochs``).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from multiple_objects_gan_tpu_torch.cli.sample import (
    N_VARIATIONS, _draw_white_bbox_edges, sample_noise)
from multiple_objects_gan_tpu_torch.config.config import (
    attngan_train_settings)
from multiple_objects_gan_tpu_torch.data.attngan import (
    AttnGanDataset, AttnGanTrainSet, attngan_split, tokenize)
from multiple_objects_gan_tpu_torch.data.datasets import Loader
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.io.weights import (
    load_image_encoder, load_reference_attngan_d, load_reference_attngan_g,
    load_text_encoder)
from multiple_objects_gan_tpu_torch.models.attngan import (
    AttnGanConfig, GNet, build_attngan_g)
from multiple_objects_gan_tpu_torch.nn.encoders import (
    build_image_encoder, build_text_encoder)
from multiple_objects_gan_tpu_torch.train.attngan_step import (
    make_attngan_train_step)
from multiple_objects_gan_tpu_torch.parallel import mesh
from multiple_objects_gan_tpu_torch.parallel.multihost import (
    is_main_process, rank, shard_loader_kwargs, world_size)
from multiple_objects_gan_tpu_torch.train.loop import (
    grid_noise, restore_rng, rng_extra, run_epochs, single_process,
    to_device)
from multiple_objects_gan_tpu_torch.train.state import (
    AttnGanTrainState, create_attngan_state)
from multiple_objects_gan_tpu_torch.utils.attention_viz import (
    save_attention_montage)
from multiple_objects_gan_tpu_torch.utils.images import save_grid, save_image
from multiple_objects_gan_tpu_torch.utils.logging import MetricWriter
from multiple_objects_gan_tpu_torch.utils.metrics import (
    BATCH as FID_BATCH, fid_from_activations, inception_activations,
    inception_score, resolve_fid_encoder, resolve_inception_fc)

VIZ_ITEMS = 8            # items of a montage (JAX :284)
VIZ_EVERY = 1000         # steps between montages (trainer.py:345-353)
EPOCH_NOISE_KEY = 1_000_000
EVAL_MODES = ("auto", "sample", "gen_example", "sampling")
SAMPLE_ROWS = 25         # sample()'s rows (JAX num_samples)
EXAMPLE_BOX = (0.3, 0.3, 0.4, 0.4)   # gen_example's box of every object
BUILT_IN_CAPTIONS = ["a man riding a horse on a beach",
                     "two dogs playing with a ball in a park"]


def init_encoders(net_e: str, n_words: int, mcfg: AttnGanConfig, *, seed,
                  device, with_image: bool = True,
                  float32_image: bool = False):
    """The frozen DAMSM text and image encoders (JAX ``init_encoders``,
    :65-102) and their provenance, ``{"text_encoder": "imported" |
    "random", "image_encoder": ...}``. The text encoder is NET_E's
    ``text_encoder*.pth`` when it exists, else random after a WARNING; the
    image encoder the file of the same name with ``text_encoder`` replaced
    by ``image_encoder`` beside it, else random after a WARNING. An
    imported text encoder keeps its own embedding rows, as the JAX import
    does; it must have one for every word of the vocabulary. The image
    encoder's backbone computes in ``mcfg.compute_dtype`` (in float32
    with ``float32_image``: the metrics' features). Without
    ``with_image`` (``sample`` and ``gen_example``) no image encoder is
    built: it is None."""
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
        if with_image and os.path.exists(img_path):
            image_sd = load_image_encoder(img_path)
            prov["image_encoder"] = "imported"
            print(f"Load image encoder from: {img_path}", flush=True)
        elif with_image:
            print(f"WARNING: {img_path!r} not found: the DAMSM image encoder "
                  "uses random weights", flush=True)
    else:
        print(f"WARNING: NET_E={net_e!r} not found: DAMSM encoders use "
              "random weights", flush=True)
    text_enc = build_text_encoder(n_words, mcfg.embedding_dim, text_sd,
                                  seed=seed, device=device)
    image_enc = None
    if with_image:
        image_enc = build_image_encoder(
            mcfg.embedding_dim, image_sd, seed=seed,
            compute_dtype=None if float32_image else mcfg.compute_dtype,
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
                resume_dir: Optional[str] = None,
                profile_dir: Optional[str] = None) -> list[dict]:
    """Train AttnGAN on cfg DATA_DIR and IMG_DIR (JAX ``run``, :185-331),
    with a torch.profiler trace into ``profile_dir`` when given. Returns
    the per-epoch mean losses."""
    device = torch.device(device)
    st = attngan_train_settings(cfg)
    ds = attngan_split(cfg.DATA_DIR, cfg.IMG_DIR, st, seed, device=device)
    text_enc, image_enc, prov = init_encoders(st.net_e, ds.n_words, mcfg,
                                              seed=seed, device=device)
    if is_main_process():
        _record_encoders(output_dir, prov, st.net_e,
                         float(st.smooth.get("LAMBDA", 0.0)))
    state = create_attngan_state(mcfg, seed=seed, device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    start_epoch = 0
    if resume_dir:
        prev = CheckpointManager(os.path.join(resume_dir, "models"))
        if prev.latest_epoch() is not None:
            epoch, extra = prev.restore(state, generator)
            restore_rng(ds, extra, "data_rng")
            start_epoch = epoch + 1
            print(f"resumed from {resume_dir} at epoch {start_epoch}",
                  flush=True)
    if start_epoch == 0:
        start_epoch = maybe_warm_start_attngan(state, st.net_g, st.b_net_d)
    mesh.replicate_state(state)
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
            state, Loader(ds, seed=seed,
                          **shard_loader_kwargs(st.batch_size)),
            make_attngan_train_step(mcfg, text_enc, image_enc,
                                    smooth=st.smooth),
            generator, lr_g=st.generator_lr, lr_d=st.discriminator_lr,
            n_epochs=n_epochs, start_epoch=start_epoch, lr_decay_epochs=0,
            snapshot_every=st.snapshot_interval,
            ckpt=CheckpointManager(os.path.join(output_dir, "models")),
            writer=writer, epoch_end_fn=single_process(epoch_end),
            step_hook=single_process(step_viz),
            checkpoint_extra=lambda: rng_extra(data_rng=ds),
            profile_dir=profile_dir)
    finally:
        writer.close()


# ------------------------------------------------------------ eval modes


def restore_g(net_g: str, mcfg: AttnGanConfig, *, seed: int,
              device) -> GNet:
    """The eval-mode G of cfg NET_G (JAX ``restore_g``, :105-142): a
    reference-format ``.pth`` (``{'netG': ...}`` or a bare state dict,
    such as the flagship's ``netG_ema_final.pth``), or a port run
    directory (or its ``models/``), whose latest checkpoint's EMA weights
    replace G's parameters, as the reference samples from its EMA-swapped
    G. Otherwise random from ``seed`` after a WARNING, as the JAX runner
    does (the reference prints an error, trainer.py:480-481)."""
    if net_g and os.path.isfile(net_g) and net_g.endswith(".pth"):
        g = build_attngan_g(mcfg, load_reference_attngan_g(net_g),
                            device=device)
        print(f"Load G from: {net_g}", flush=True)
        return g
    if net_g and os.path.isdir(net_g):
        mdir = os.path.join(net_g, "models")
        mgr = CheckpointManager(mdir if os.path.isdir(mdir) else net_g)
        if mgr.latest_epoch() is not None:
            ckpt, epoch = mgr.load()
            g = build_attngan_g(mcfg, {**ckpt["g"], **ckpt["g_ema"]},
                                device=device)
            print(f"Load G from: {net_g} (epoch {epoch}, EMA weights)",
                  flush=True)
            return g
    print(f"WARNING: TRAIN.NET_G={net_g!r} not found: G uses random "
          "weights", flush=True)
    return build_attngan_g(mcfg, seed=seed, device=device)


def _tile(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.repeat(n, *([1] * (t.dim() - 1)))


def sample_row(text_enc, g: GNet, batch: dict, z: torch.Tensor
               ) -> torch.Tensor:
    """The fakes of a 1-item ``batch`` (captions, cap_lens, bbox,
    label_onehot on the device): its caption encoded once, the conditioning
    tiled to z's batch (trainer.py:525-546), c = mu; returns the last
    branch's images (n, 3, H, W) in float32."""
    n = z.shape[0]
    caps = batch["captions"]
    with torch.inference_mode():
        words, sent = text_enc(caps, batch["cap_lens"])
        return g(z, _tile(sent, n), _tile(words, n), _tile(caps == 0, n),
                 _tile(batch["bbox"], n),
                 _tile(batch["label_onehot"], n)).float()


def caption_words(caption_ids, ixtoword: dict) -> str:
    """A caption's words up to its first ``<end>`` (id 0), or "empty"
    (trainer.py:571-578)."""
    words = []
    for c in caption_ids:
        if c == 0:
            break
        words.append(str(ixtoword.get(int(c), "?")))
    return " ".join(words) or "empty"


def sample(ds: AttnGanTrainSet, mcfg: AttnGanConfig, g: GNet, text_enc,
           output_dir: str, *, seed: int, device) -> str:
    """The qualitative rows of the test split (JAX ``sample``, :333-400):
    for each of its first :data:`SAMPLE_ROWS` items in order, at batch 1, the
    real image and N_VARIATIONS fakes of z from (seed, item) at the last
    scale, the boxes' edges white on every tile, saved as
    ``samples/<caption words>_<item>.png`` (10 tiles a row). Returns the
    directory."""
    device = torch.device(device)
    imsize = ds.imsizes[-1]
    save_dir = os.path.join(output_dir, "samples")
    os.makedirs(save_dir, exist_ok=True)
    n_written = 0
    for step in range(min(SAMPLE_ROWS, len(ds))):
        batch = ds.get_batch([step])      # the unshuffled loader's batch
        z = torch.from_numpy(sample_noise(seed, step, N_VARIATIONS,
                                          mcfg.z_dim)).to(device)
        fakes = sample_row(text_enc, g, to_device(batch, device), z)
        real = batch[f"image{imsize}"][:1]
        if isinstance(real, torch.Tensor):
            real = real.cpu().numpy()
        real = real.astype(np.float32) / 127.5 - 1.0
        tiles = np.concatenate(
            [real, fakes.permute(0, 2, 3, 1).cpu().numpy()])
        _draw_white_bbox_edges(tiles, batch["bbox"][0], imsize)
        sentence = caption_words(batch["captions"][0], ds.ixtoword)
        save_grid(tiles, os.path.join(save_dir, f"{sentence}_{step}.png"),
                  nrow=10)
        n_written += 1
    print(f"Saved {n_written} files to {save_dir}", flush=True)
    return save_dir


def sampling(ds: AttnGanTrainSet, mcfg: AttnGanConfig, g: GNet, text_enc,
             image_enc, output_dir: str, *, image_prov: str,
             batch_size: int, seed: int, device, num_images: int = 0,
             noise: Optional[Callable[[int, int], torch.Tensor]] = None
             ) -> dict:
    """The bulk dump and its metrics (JAX ``sampling``, :403-540;
    trainer.py:387-472): the test split in order, ``batch_size`` items a
    batch (clamped to the split), z from (seed, images written so far)
    unless ``noise(written, batch)`` gives it, c = mu; each fake saved
    as ``single_samples/s_%06d.png`` until ``num_images`` (0: the whole
    split). Under a process group every rank reads the whole batch,
    generates its contiguous slice of it (padded to a multiple of the
    world, as JAX pads it) and writes its images under their global
    indices; the features go to rank 0, which alone computes the metrics,
    writes ``eval_metrics.json`` and returns them (the others return
    ``metrics`` None). Each batch's 2048-d features of the fakes and of its real
    images are kept, not the images (:data:`FID_BATCH` images a
    forward, the remainder padded, as JAX batches them). FID runs on the
    canonical encoder when ``$FID_INCEPTION_WEIGHTS`` names one, else on
    ``image_enc``'s backbone ("damsm" when ``image_prov`` is "imported",
    else "random"); IS on ``image_enc``'s features of the fakes (a second
    sweep only when FID is canonical and the backbone imported). Writes
    ``eval_metrics.json`` with JAX's seven keys and returns {"dir",
    "metrics", "real_acts", "fake_acts"}."""
    device = torch.device(device)
    damsm_prov = "damsm" if image_prov == "imported" else "random"
    fid_enc, fid_prov = resolve_fid_encoder(image_enc, damsm_prov,
                                            device=device)
    if len(ds) == 0:
        raise ValueError("sampling(): empty test split")
    bs = int(batch_size)
    if bs > len(ds):
        # a drop-last loader would otherwise make no batch
        print(f"sampling(): batch {bs} > test split {len(ds)} — "
              f"clamping to {len(ds)}", flush=True)
        bs = len(ds)
    out_dir = os.path.join(output_dir, "single_samples")
    os.makedirs(out_dir, exist_ok=True)
    written, limit = 0, num_images or len(ds)
    world, mine = world_size(), []
    top = f"image{ds.imsizes[-1]}"
    with_is = fid_prov == "fid_canonical" and damsm_prov == "damsm"
    for batch in Loader(ds, bs, shuffle=False, seed=seed).epoch(0):
        batch = to_device(batch, device)
        z = (noise(written, bs) if noise is not None else torch.from_numpy(
            sample_noise(seed, written, bs, mcfg.z_dim)))
        take = min(bs, limit - written)
        # each rank generates its contiguous slice of the batch, padded to
        # a multiple of the world with copies of row 0 (JAX :469-481)
        per = -(-bs // world)
        idx = torch.arange(rank() * per, (rank() + 1) * per)
        rows = torch.where(idx < bs, idx, 0).to(device)
        caps = batch["captions"][rows]
        with torch.inference_mode():
            words, sent = text_enc(caps, batch["cap_lens"][rows])
            imgs = g(z.to(device)[rows], sent, words, caps == 0,
                     batch["bbox"][rows],
                     batch["label_onehot"][rows]).float()
        keep = idx < take
        if bool(keep.any()):
            kept = keep.to(device)
            fakes = imgs[kept].permute(0, 2, 3, 1)
            reals = batch[top][rows[kept]].float() / 127.5 - 1.0
            mine.append((written + idx[keep].numpy(),
                         inception_activations(fid_enc, fakes, FID_BATCH),
                         inception_activations(fid_enc, reals, FID_BATCH),
                         # IS stays on the DAMSM backbone, whose pool the
                         # torchvision head matches; a random backbone's
                         # sweep would re-dress noise
                         inception_activations(image_enc, fakes, FID_BATCH)
                         if with_is else None))
            for i, img in zip(idx[keep].tolist(), fakes.cpu().numpy()):
                save_image(img, os.path.join(out_dir,
                                             f"s_{written + i:06d}.png"))
        written += take
        if written >= limit:
            break
    if is_main_process():
        print(f"wrote {written} single images to {out_dir}", flush=True)
    # the features of every rank's images to rank 0, in the images' order
    parts = [p for ranks in mesh.gather_objects(mine) for p in ranks]
    if not is_main_process():
        return {"dir": out_dir, "metrics": None}
    order = np.argsort(np.concatenate([p[0] for p in parts]))
    fake_acts = np.concatenate([p[1] for p in parts])[order]
    real_acts = np.concatenate([p[2] for p in parts])[order]
    is_acts = (np.concatenate([p[3] for p in parts])[order] if with_is
               else None)
    fid = fid_from_activations(real_acts, fake_acts)
    fc, is_head = resolve_inception_fc()
    is_backbone = "imported" if damsm_prov == "damsm" else "random"
    if is_backbone == "random" or is_head == "random":
        print("WARNING: IS is not comparable to published numbers "
              f"(backbone={is_backbone}, head={is_head})", flush=True)
    is_mean, is_std = inception_score(
        acts=fake_acts if is_acts is None else is_acts, fc=fc)
    print(f"FID: {fid:.3f}  IS: {is_mean:.3f} +/- {is_std:.3f}", flush=True)
    # provenance: is_head the 1000-class head, is_backbone the features
    # under it, fid_encoder the network behind both FID sides
    metrics = {"fid": fid, "inception_score_mean": is_mean,
               "inception_score_std": is_std, "n_images": written,
               "is_head": is_head, "is_backbone": is_backbone,
               "fid_encoder": fid_prov}
    with open(os.path.join(output_dir, "eval_metrics.json"), "w") as f:
        json.dump(metrics, f)
    return {"dir": out_dir, "metrics": metrics, "real_acts": real_acts,
            "fake_acts": fake_acts}


def encode_captions(captions_text: list, wordtoix: dict, words_num: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Free-text captions -> (ids (B, words_num) int64, zero-padded;
    lengths (B,), at least 1): the tokenizer's words in the vocabulary,
    cut at ``words_num`` (JAX ``gen_example``, :550-556)."""
    caps = np.zeros((len(captions_text), words_num), np.int64)
    lens = np.ones((len(captions_text),), np.int64)
    for i, text in enumerate(captions_text):
        ids = [wordtoix[t] for t in tokenize(text) if t in wordtoix]
        ids = ids[:words_num]
        caps[i, :len(ids)] = ids
        lens[i] = max(len(ids), 1)
    return caps, lens


def gen_example(captions_text: list, ds, mcfg: AttnGanConfig, g: GNet,
                text_enc, output_dir: str, *, words_num: int, seed: int,
                device, key: str = "gen_example",
                z: Optional[torch.Tensor] = None):
    """Free-text captions -> images and attention maps (JAX
    ``gen_example``, :542-602; trainer.py:581-667): every object's box at
    :data:`EXAMPLE_BOX` with label 0, z from (seed, 0) unless given, c =
    mu. Writes ``<output_dir>/<key>/0_s_<j>_g<k>.png`` (caption j, scale
    k), ``..._a<k>.png`` (attention stage k over the next scale's image)
    and ``<output_dir>/<key>.png`` (the last scale, 4 a row). Returns the
    images (B, H, W, 3) a scale and the attention maps (B, h, w, T) a
    stage, float32 numpy."""
    device = torch.device(device)
    caps_np, lens_np = encode_captions(captions_text, ds.wordtoix,
                                       words_num)
    b, o = len(captions_text), mcfg.num_objects
    bbox = torch.tensor(EXAMPLE_BOX, device=device).repeat(b, o, 1)
    labels = torch.zeros((b, o, mcfg.label_dim), device=device)
    labels[:, :, 0] = 1.0
    if z is None:
        z = torch.from_numpy(sample_noise(seed, 0, b, mcfg.z_dim))
    caps = torch.from_numpy(caps_np).to(device)
    with torch.inference_mode():
        words, sent = text_enc(caps, torch.from_numpy(lens_np))
        out = g.outputs(z.to(device), sent, words, caps == 0, bbox, labels)
    imgs = [im.float().permute(0, 2, 3, 1).cpu().numpy() for im in out.imgs]
    atts = [a.float().cpu().numpy() for a in out.att_maps]
    base = os.path.join(output_dir, key)
    os.makedirs(base, exist_ok=True)
    for j in range(b):
        name = os.path.join(base, f"0_s_{j}")
        for k, im in enumerate(imgs):
            save_image(im[j], f"{name}_g{k}.png")
        for k, att in enumerate(atts):
            im_for_att = imgs[k + 1] if len(imgs) > 1 else imgs[0]
            save_attention_montage(f"{name}_a{k}.png", im_for_att[j:j + 1],
                                   att[j:j + 1], caps_np[j:j + 1],
                                   ds.ixtoword, lens_np[j:j + 1])
    path = os.path.join(output_dir, f"{key}.png")
    save_grid(imgs[-1], path, nrow=4)
    print(f"wrote {path} + per-caption images/attention maps in {base}",
          flush=True)
    return imgs, atts


def load_example_captions(data_dir: str) -> dict:
    """The reference's gen_example caption sources (main.py:39-60; JAX
    ``load_example_captions``, :605-640): ``<DATA_DIR>/
    example_filenames.txt`` names caption files (relative to DATA_DIR, no
    extension), each ``<name>.txt`` one sentence a line and one key, the
    file's stem; else ``example_captions.txt``; else two built-in
    captions."""
    index = os.path.join(data_dir, "example_filenames.txt")
    if os.path.isfile(index):
        data = {}
        with open(index) as f:
            names = [line.strip() for line in f if line.strip()]
        for name in names:
            path = os.path.join(data_dir, f"{name}.txt")
            if not os.path.isfile(path):
                print(f"WARNING: caption file {path} not found — skipped",
                      flush=True)
                continue
            with open(path) as f:
                sents = [line.strip() for line in f if line.strip()]
            if sents:
                print(f"Load from: {name}", flush=True)
                data[os.path.basename(name)] = sents
        if data:
            return data
    cap_file = os.path.join(data_dir, "example_captions.txt")
    if os.path.isfile(cap_file):
        with open(cap_file) as f:
            captions = [line.strip() for line in f if line.strip()]
        if captions:
            return {"example_captions": captions}
    print(f"no example caption files under {data_dir} - using built-in "
          "example captions", flush=True)
    return {"gen_example": list(BUILT_IN_CAPTIONS)}


def eval_mode(mode: str, cfg) -> str:
    """``--eval_mode``: ``auto`` is ``sample`` under B_VALIDATION, else
    ``gen_example`` (the reference's main.py:153-160)."""
    if mode == "auto":
        return "sample" if bool(cfg.B_VALIDATION) else "gen_example"
    return mode


def run_attngan_eval(cfg, mcfg: AttnGanConfig, output_dir: str, mode: str,
                     *, device, seed: int = 0, num_images: int = 0) -> str:
    """The eval mode ``mode`` (``sample``, ``gen_example`` or
    ``sampling``) from cfg NET_G's EMA G and NET_E's text encoder (and,
    for ``sampling``, the image encoder beside it, in float32), on the set
    of DATA_DIR (its test split, with IMG_DIR's JPEGs, for ``sample`` and
    ``sampling``; its vocabulary for all three). ``num_images`` caps the
    ``sampling`` dump. Returns the directory written."""
    device = torch.device(device)
    st = attngan_train_settings(cfg)
    if mode in ("sample", "sampling"):
        ds = attngan_split(cfg.DATA_DIR, cfg.IMG_DIR, st, seed, "test",
                           device=device)
    else:
        ds = AttnGanDataset(cfg.DATA_DIR, "test", st.captions_per_image)
    metrics = mode == "sampling"
    text_enc, image_enc, prov = init_encoders(
        st.net_e, ds.n_words, mcfg, seed=seed, device=device,
        with_image=metrics, float32_image=metrics)
    g = restore_g(st.net_g, mcfg, seed=seed, device=device)
    if metrics:
        sampling(ds, mcfg, g, text_enc, image_enc, output_dir,
                 image_prov=prov["image_encoder"],
                 batch_size=st.batch_size, seed=seed, device=device,
                 num_images=num_images)
        return output_dir
    if mode == "sample":
        return sample(ds, mcfg, g, text_enc, output_dir, seed=seed,
                      device=device)
    for key, captions in load_example_captions(cfg.DATA_DIR).items():
        gen_example(captions, ds, mcfg, g, text_enc, output_dir,
                    words_num=st.words_num, seed=seed, device=device,
                    key=key)
    return output_dir
