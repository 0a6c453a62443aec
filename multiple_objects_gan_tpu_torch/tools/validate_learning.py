"""Whether a port run learns (the port's counterpart of the JAX package's
``tools/validate_learning.py``): train on the synthetic set, restore the
checkpoint, generate on fresh layouts, and measure whether the generated
content sits INSIDE the conditioned boxes and whether a FID trend over the
checkpoints falls.

    python -m multiple_objects_gan_tpu_torch.tools.validate_learning \\
        [mnist|clevr|coco-stackgan-1|coco-stackgan-2|coco-attngan] \\
        [--epochs 20] [--n N] [--bf16 | --no-bf16] [--seed 7] \\
        [--fid_images 128] [--segments 2] [--damsm_epochs N] \\
        [--snapshot_interval N] [--sampling_images N] [--workdir DIR] \\
        [--export_pth PATH] [--device cuda|cpu]

The synthetic sets draw bright label-coloured objects in the boxes on dark
backgrounds, so a G that learned the conditioning puts light in its boxes
and dark outside them. The set is written first at the JAX tool's sizes
(mnist 5120, clevr 2560, COCO 2048 items); the train entry's own
``--synthetic`` set is too small a signal. Training runs through the
port's ``cli/main.py`` in ``--segments`` runs, each resuming the one
before, ``--bf16`` by default. After the seeded initial G and after each
segment, 32 images (16 for stage 2 and AttnGAN) are generated on fresh
random layouts from ``RandomState(seed + 1)`` with z from
``cli/sample.py:sample_noise(seed, 0, ...)``, in the run's compute dtype
(images float32):

* ``separation``: mean luminance inside the boxes minus outside, on
  [-1, 1];
* ``fid_trend``: [[epoch, FID]] against the set's first ``--fid_images``
  images, over the 448 features of :class:`TrendEncoder` (three random
  strided convs with mean and std pooling, its init pinned by the tests);
  its values compare only with each other: the question is whether they
  fall (:func:`fid_decreasing`);
* mnist and clevr: ``layout_fidelity`` (``utils/layout_fidelity.py``:
  recall and loc_iou of a crop classifier, chance 0.1 for digits and 1/24
  for clevr's shape and colour both).

coco-attngan trains with cfg/coco_attn_train.yml at LAMBDA 0 and no NET_E
by default (random DAMSM encoders' word and sentence losses at x50 diverge
by design), and with ``--damsm_epochs N`` the full chain: DAMSM
pretraining for N epochs on the same set, its text encoder as NET_E,
LAMBDA 50. ``--sampling_images N`` then runs AttnGAN's sampling dump and
records its ``eval_metrics.json``. ``--export_pth`` writes the final G as
a reference ``.pth`` through ``tools/export_checkpoint.py`` (stage 2 with
its frozen stage-1 G embedded, AttnGAN's EMA G). Everything runs on the
card unless ``--device cpu`` is given; without a card it raises. Prints
one JSON line with the JAX tool's keys, and returns it as a dict.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multiple_objects_gan_tpu_torch import float32_pinned, resolve_device
from multiple_objects_gan_tpu_torch.cli.attngan_runner import (
    init_encoders, restore_g)
from multiple_objects_gan_tpu_torch.cli.main import main as cli_main
from multiple_objects_gan_tpu_torch.cli.sample import sample_noise
from multiple_objects_gan_tpu_torch.cli.stage2_runner import (
    frozen_stage1_g, stage2_images)
from multiple_objects_gan_tpu_torch.config.config import (
    attngan_model_config, attngan_train_settings, cfg_from_file,
    stage1_model_config, stage2_model_config)
from multiple_objects_gan_tpu_torch.data.attngan import (
    AttnGanDataset, write_synthetic_attngan)
from multiple_objects_gan_tpu_torch.data.coco import write_synthetic_coco
from multiple_objects_gan_tpu_torch.data.datasets import (
    write_synthetic_clevr, write_synthetic_multimnist)
from multiple_objects_gan_tpu_torch.data.nvjpeg import decode_resized
from multiple_objects_gan_tpu_torch.data.png import read_png, resize_bilinear
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.models.stage1 import build_stage1_g
from multiple_objects_gan_tpu_torch.models.stage2 import build_stage2_g
from multiple_objects_gan_tpu_torch.nn.blocks import env_compute_dtype
from multiple_objects_gan_tpu_torch.tools import export_checkpoint
from multiple_objects_gan_tpu_torch.train.step import make_sample_fn
from multiple_objects_gan_tpu_torch.utils import layout_fidelity as lf
from multiple_objects_gan_tpu_torch.utils.metrics import fid_from_activations

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
VARIANTS = {"mnist": "multi-mnist", "clevr": "clevr",
            "coco-stackgan-1": "coco-stackgan-1",
            "coco-stackgan-2": "coco-stackgan-2",
            "coco-attngan": "coco-attngan"}
# the train cfg of each variant (coco-attngan's is patched, below)
CFG_FILES = {"multi-mnist": os.path.join(ROOT, "cfg", "mnist_train.yml"),
             "clevr": os.path.join(ROOT, "cfg", "clevr_train.yml"),
             "coco-stackgan-1": os.path.join(ROOT, "cfg", "coco_s1_train.yml"),
             "coco-stackgan-2": os.path.join(ROOT, "cfg", "coco_s2_train.yml"),
             "coco-attngan": os.path.join(ROOT, "cfg", "coco_attn_train.yml"),
             "damsm": os.path.join(ROOT, "cfg", "coco_damsm.yml")}
SET_SIZES = {"mnist": 5120, "clevr": 2560, "coco-stackgan-1": 2048,
             "coco-stackgan-2": 2048, "coco-attngan": 2048}
GEN_BATCH = 32              # stage-1 images a trend point
GEN_BATCH_256 = 16          # stage-2 and AttnGAN images a trend point
TREND_BATCH = 16            # the trend encoder's batch
TREND_SEED = 0              # the trend encoder's init


# ------------------------------------------------------------ measurements

def _separation(imgs: np.ndarray, bbox: np.ndarray) -> tuple[float, float]:
    """Mean luminance inside vs outside the conditioned boxes."""
    size = imgs.shape[1]
    inside = np.zeros(imgs.shape[:3], bool)
    for i in range(imgs.shape[0]):
        for j in range(bbox.shape[1]):
            if bbox[i, j, 0] < 0:
                continue
            x0, y0 = (int(bbox[i, j, 0] * size), int(bbox[i, j, 1] * size))
            x1 = min(int((bbox[i, j, 0] + bbox[i, j, 2]) * size), size)
            y1 = min(int((bbox[i, j, 1] + bbox[i, j, 3]) * size), size)
            inside[i, y0:y1, x0:x1] = True
    lum = imgs.mean(axis=-1)
    return float(lum[inside].mean()), float(lum[~inside].mean())


def _glob_images(*dirs) -> list:
    exts = (".png", ".jpg", ".jpeg")
    files = []
    for d in dirs:
        if os.path.isdir(d):
            files += [os.path.join(r, f) for r, _, fs in os.walk(d)
                      for f in fs if f.lower().endswith(exts)]
    return files


def _load_real_images(paths: list, size: int, limit: int = 128,
                      device="cpu") -> np.ndarray:
    """Real side of the FID trend: the set's first ``limit`` images (by
    path), RGB, resized to the generator's size with PIL's bilinear
    filter, in [-1, 1]. PNGs are read by ``data/png.py`` on the host,
    JPEGs by nvjpeg on a CUDA ``device`` (``data/nvjpeg.py``) or the numpy
    codec on the CPU."""
    out = []
    for p in sorted(paths)[:limit]:
        if p.lower().endswith(".png"):
            img = read_png(p, "RGB")
            if img.shape[:2] != (size, size):
                img = resize_bilinear(img, (size, size))
        else:
            img = decode_resized([p], size, device)[0]
            img = img.cpu().numpy() if isinstance(img, torch.Tensor) else img
        out.append(np.asarray(img, np.float32) / 127.5 - 1.0)
    if not out:
        raise FileNotFoundError("no real images found for the FID trend")
    return np.stack(out)


def _rgb(x):
    x = np.asarray(x, np.float32)
    return np.repeat(x, 3, axis=-1) if x.shape[-1] == 1 else x


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Pad NCHW ``x`` as XLA's 'SAME' does for a k x k, stride-s conv:
    ceil(n / s) outputs, the odd pixel of padding at the high end."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class TrendEncoder(nn.Module):
    """The trend FID's features: three 4x4 stride-2 convs (32, 64, 128
    channels, 'SAME' padding, bias) with leaky-relu 0.2, and at each scale
    the spatial mean and (population) std, 448 values an image: the JAX
    tool's ``make_trend_encoder`` (``tools/validate_learning.py:101-131``).
    A shallow random net keeps distributions apart where a random deep
    one collapses every input to the same activations. Its orthogonal
    init is drawn from ``torch.Generator().manual_seed(TREND_SEED)``; the
    JAX tool draws its own from ``PRNGKey(0)``, so the two trends compare
    only through carried weights (the tests do)."""

    WIDTHS = (32, 64, 128)

    def __init__(self):
        super().__init__()
        chans = (3,) + self.WIDTHS
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 4, stride=2)
                                   for a, b in zip(chans, chans[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 3, H, W) -> (B, 448) float32."""
        feats = []
        for conv in self.convs:
            x = F.leaky_relu(conv(_same_pad(x, 4, 2)), 0.2)
            feats += [x.mean(dim=(2, 3)), x.std(dim=(2, 3), unbiased=False)]
        return torch.cat(feats, dim=-1)


def make_trend_encoder(device="cpu") -> TrendEncoder:
    """The pinned trend encoder on ``device``: orthogonal conv weights and
    zero biases drawn on the CPU from ``TREND_SEED``, so that every
    machine draws the same."""
    enc = TrendEncoder()
    gen = torch.Generator().manual_seed(TREND_SEED)
    with torch.no_grad():
        for conv in enc.convs:
            nn.init.orthogonal_(conv.weight, generator=gen)
            conv.bias.zero_()
    return enc.to(device).eval()


def trend_features(enc: TrendEncoder, imgs: np.ndarray) -> np.ndarray:
    """(N, H, W, C) images in [-1, 1] (one channel repeated to three) ->
    (N, 448) float32 features, TREND_BATCH images a forward, in float32
    on any device."""
    dev = next(enc.parameters()).device
    imgs = _rgb(imgs)
    out = []
    with torch.inference_mode(), float32_pinned():
        for i in range(0, len(imgs), TREND_BATCH):
            x = torch.from_numpy(np.ascontiguousarray(
                imgs[i:i + TREND_BATCH])).to(dev).permute(0, 3, 1, 2)
            out.append(enc(x).float().cpu().numpy())
    return np.concatenate(out)


def _fid(real: np.ndarray, fake: np.ndarray, device="cpu") -> float:
    """FID over :class:`TrendEncoder`'s features (self-comparable only:
    the same encoder, real set, z and layouts at every point, so the
    differences come from the generator alone)."""
    enc = make_trend_encoder(device)
    return fid_from_activations(trend_features(enc, real),
                                trend_features(enc, fake))


def fid_decreasing(fids) -> bool:
    """The learning verdict over the FID trend: trained beats random init,
    and the final point is (near-)best: within 10 % of the best, or within
    2 % of the init-to-best drop, whichever is larger (the trend encoder's
    noise at the floor); a flat trend fails, ``final < init`` being
    strict."""
    fids = list(fids)
    return bool(
        fids[-1] < fids[0]
        and fids[-1] - min(fids) <= max(
            0.10 * min(fids), 0.02 * (fids[0] - min(fids))))


def _random_layouts(b: int, o: int, label_dim: int, seed: int,
                    n_classes: int = 0, clevr: bool = False):
    """Fresh layouts from ``RandomState(seed)``: 1..o objects an image,
    boxes of side 0.25-0.4 inside the canvas, the rest padded (-1). Labels
    one-hot among the ``n_classes`` leading slots (default label_dim - 1:
    clevr and COCO reserve the last slot for pads, Multi-MNIST passes 10);
    with ``clevr`` the dataset's two-hot (shape in [0:3], colour in
    [4:12]). Returns (bbox, labels, the RandomState)."""
    n_classes = n_classes or label_dim - 1
    rs = np.random.RandomState(seed)
    bbox = np.full((b, o, 4), -1.0, np.float32)
    labels = np.zeros((b, o, label_dim), np.float32)
    for i in range(b):
        n_obj = rs.randint(1, o + 1)
        for j in range(n_obj):
            w, h = rs.uniform(0.25, 0.4, 2)
            bbox[i, j] = [rs.uniform(0, 1 - w), rs.uniform(0, 1 - h), w, h]
            if clevr:
                labels[i, j, rs.randint(0, 3)] = 1.0
                labels[i, j, 4 + rs.randint(0, 8)] = 1.0
            else:
                labels[i, j, rs.randint(0, n_classes)] = 1.0
    return bbox, labels, rs


def _damsm_loss_trend(damsm_out: str) -> list:
    """[[epoch, eval loss total], ...] of the DAMSM run's per-epoch
    eval-split records: whether pretraining converged."""
    trend = []
    with open(os.path.join(damsm_out, "logs", "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            keys = [k for k in row if k.startswith("eval_")]
            if keys:
                trend.append([int(row["step"]),
                              round(sum(float(row[k]) for k in keys), 4)])
    return trend


def _damsm_word_stats(seg_dirs: list) -> dict:
    """s_loss and w_loss over every segment of an AttnGAN run (each logs
    to its own metrics.jsonl): first- and last-quarter means, and whether
    all are finite and nonzero."""
    s, w = [], []
    for seg in seg_dirs:
        path = os.path.join(seg, "logs", "metrics.jsonl")
        if not os.path.isfile(path):
            continue
        with open(path) as f:
            for line in f:
                row = json.loads(line)
                if "s_loss" in row:
                    s.append(float(row["s_loss"]))
                    w.append(float(row["w_loss"]))
    if not s:
        return {}
    q = max(1, len(s) // 4)
    arr_s, arr_w = np.asarray(s), np.asarray(w)
    return {
        "n_logged": len(s),
        "s_loss_first_quarter": round(float(arr_s[:q].mean()), 4),
        "s_loss_last_quarter": round(float(arr_s[-q:].mean()), 4),
        "w_loss_first_quarter": round(float(arr_w[:q].mean()), 4),
        "w_loss_last_quarter": round(float(arr_w[-q:].mean()), 4),
        "all_finite": bool(np.isfinite(arr_s).all()
                           and np.isfinite(arr_w).all()),
        "all_nonzero": bool((arr_s != 0.0).all() and (arr_w != 0.0).all()),
    }


# ------------------------------------------------------------ generation

def _latest(out_dir: str):
    """(checkpoint, epoch) of ``out_dir``'s run, or (None, None)."""
    mgr = CheckpointManager(os.path.join(out_dir, "models"))
    if mgr.latest_epoch() is None:
        print("no checkpoint — random-init G (FID-trend baseline point)",
              flush=True)
        return None, None
    ckpt, epoch = mgr.load()
    print(f"restored epoch {epoch}", flush=True)
    return ckpt, epoch


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).float().cpu().numpy()


def _generate_stage1(cfg_file, variant, out_dir, seed, device, dtype):
    """The stage-1 G of ``out_dir``'s latest checkpoint (the seeded init G
    of the run when there is none) on GEN_BATCH fresh layouts, through
    ``train/step.py:make_sample_fn``."""
    mcfg = stage1_model_config(cfg_from_file(cfg_file, variant), variant,
                               compute_dtype=dtype)
    ckpt, _ = _latest(out_dir)
    g = (build_stage1_g(mcfg, seed=seed, device=device) if ckpt is None
         else build_stage1_g(mcfg, ckpt["g"], device=device))
    b = GEN_BATCH
    bbox, labels, rs = _random_layouts(
        b, mcfg.num_objects, mcfg.label_dim, seed + 1,
        n_classes=mcfg.label_dim if variant == "multi-mnist" else 0,
        clevr=variant == "clevr")
    text = (torch.from_numpy(rs.randn(b, mcfg.text_dim).astype(np.float32)
                             ).to(device) if mcfg.use_ca else None)
    z = torch.from_numpy(sample_noise(seed, 0, b, mcfg.z_dim)).to(device)
    imgs = make_sample_fn(mcfg)(g, z, torch.from_numpy(bbox).to(device),
                                torch.from_numpy(labels).to(device), text)
    return _nhwc(imgs), bbox, labels


def _generate_stage2(cfg_file, out_dir, seed, device, dtype):
    """Stage 2's G1 and G2 as ``cli/stage2_runner.py:run_stage2`` builds
    them (the frozen G1 of cfg STAGE1_G, or the seeded one the run trained
    against) on GEN_BATCH_256 fresh layouts, 256px."""
    cfg = cfg_from_file(cfg_file, "coco-stackgan-2")
    s1_cfg, s2_cfg = stage2_model_config(cfg, compute_dtype=dtype)
    g1 = frozen_stage1_g(s1_cfg, cfg.get("STAGE1_G", ""), seed=seed,
                         device=device)
    ckpt, _ = _latest(out_dir)
    g2 = (build_stage2_g(s2_cfg, seed=seed, device=device) if ckpt is None
          else build_stage2_g(s2_cfg, ckpt["g"], device=device))
    b = GEN_BATCH_256
    bbox, labels, rs = _random_layouts(b, s1_cfg.num_objects,
                                       s1_cfg.label_dim, seed + 1)
    text = rs.randn(b, s1_cfg.text_dim).astype(np.float32)
    z = torch.from_numpy(sample_noise(seed, 0, b, s1_cfg.z_dim)).to(device)
    box = torch.from_numpy(bbox).to(device)
    imgs = stage2_images(g1, g2, z, {
        "bbox": box, "bbox_s2": box,
        "label_onehot": torch.from_numpy(labels).to(device),
        "text_embedding": torch.from_numpy(text).to(device)})
    return _nhwc(imgs), bbox, labels


def _generate_attngan(cfg_file, data_dir, img_dir, out_dir, seed, device,
                      dtype):
    """AttnGAN's EMA G of ``out_dir`` through ``cli/attngan_runner.py:
    restore_g`` (the seeded init G when there is no checkpoint) and the
    frozen text encoder the run trained against (``init_encoders``: cfg
    NET_E, or the seeded random one), final-branch 256px images of
    GEN_BATCH_256 fresh layouts and random captions."""
    cfg = cfg_from_file(cfg_file, "coco-attngan")
    cfg.DATA_DIR, cfg.IMG_DIR = data_dir, img_dir
    st = attngan_train_settings(cfg)
    mcfg = attngan_model_config(cfg, compute_dtype=dtype)
    n_words = AttnGanDataset(data_dir, "test", st.captions_per_image).n_words
    text_enc, _, _ = init_encoders(st.net_e, n_words, mcfg, seed=seed,
                                   device=device, with_image=False)
    g = restore_g(out_dir, mcfg, seed=seed, device=device)
    b, words_num = GEN_BATCH_256, st.words_num
    bbox, labels, rs = _random_layouts(b, 3, mcfg.label_dim, seed + 1)
    lens = rs.randint(4, min(10, words_num) + 1, b)
    caps = np.zeros((b, words_num), np.int64)
    for i, ln in enumerate(lens):
        caps[i, :ln] = rs.randint(1, n_words, ln)
    z = torch.from_numpy(sample_noise(seed, 0, b, mcfg.z_dim)).to(device)
    caps_t = torch.from_numpy(caps).to(device)
    g.eval()
    with torch.inference_mode():
        words, sent = text_enc(caps_t, torch.from_numpy(lens).to(device))
        imgs = g(z, sent, words, caps_t == 0,
                 torch.from_numpy(bbox).to(device),
                 torch.from_numpy(labels).to(device)).float()
    return _nhwc(imgs), bbox, labels


# ------------------------------------------------------------ cfg patches

def _read_attngan_train_cfg() -> str:
    with open(CFG_FILES["coco-attngan"]) as f:
        return f.read()


def _write_attngan_validate_cfg(work: str) -> str:
    """coco_attn_train.yml at LAMBDA 0 and no NET_E: without pretrained
    DAMSM encoders the word and sentence losses at x50 diverge by design,
    so the adversarial and KL losses alone must learn placement, which is
    what this tool checks."""
    txt = _read_attngan_train_cfg()
    txt = txt.replace("LAMBDA: 50.0", "LAMBDA: 0.0")
    txt = txt.replace("NET_E: 'DAMSMencoders/coco/text_encoder100.pth'",
                      "NET_E: ''")
    assert "LAMBDA: 0.0" in txt and "NET_E: ''" in txt
    path = os.path.join(work, "coco_attn_validate.yml")
    with open(path, "w") as f:
        f.write(txt)
    return path


def _write_attngan_full_cfg(work: str, net_e: str) -> str:
    """coco_attn_train.yml at the reference's composition (LAMBDA 50,
    code/coco/attngan/cfg/coco_train.yml:24) with NET_E the DAMSM text
    encoder this chain just pretrained: G's loss includes the word and
    sentence losses through the frozen encoders (trainer.py:330-340)."""
    txt = _read_attngan_train_cfg()
    txt = txt.replace("NET_E: 'DAMSMencoders/coco/text_encoder100.pth'",
                      f"NET_E: '{net_e}'")
    assert f"NET_E: '{net_e}'" in txt and "LAMBDA: 50.0" in txt
    path = os.path.join(work, "coco_attn_full.yml")
    with open(path, "w") as f:
        f.write(txt)
    return path


def _write_attngan_eval_cfg(work: str, train_cfg_file: str,
                            net_g_dir: str) -> str:
    """The eval cfg of the chain's train cfg (its WORDS_NUM and NET_E, the
    encoders the run trained against) with TRAIN.FLAG False,
    B_VALIDATION True and NET_G the finished run: the sampling dump's
    (trainer.py:387-472)."""
    with open(train_cfg_file) as f:
        txt = f.read()
    txt = txt.replace("FLAG: True", "FLAG: False")
    txt = txt.replace("NET_G: ''", f"NET_G: '{net_g_dir}'")
    txt = txt.replace("DATASET_NAME: 'coco'",
                      "DATASET_NAME: 'coco'\nB_VALIDATION: True")
    assert "FLAG: False" in txt and f"NET_G: '{net_g_dir}'" in txt
    path = os.path.join(work, "coco_attn_sampling.yml")
    with open(path, "w") as f:
        f.write(txt)
    return path


def _export_frozen_s1(cfg_file: str, seed: int, out_path: str,
                      device="cpu") -> str:
    """Write the stage-2 run's frozen stage-1 G as a reference ``.pth``:
    ``frozen_stage1_g`` with the cfg's STAGE1_G and the run's seed, the
    call ``cli/stage2_runner.py:run_stage2`` makes, so it is the G1 the
    stage-2 G trained against. Returns ``out_path``."""
    cfg = cfg_from_file(cfg_file, "coco-stackgan-2")
    s1_cfg, _ = stage2_model_config(cfg)
    g1 = frozen_stage1_g(s1_cfg, cfg.get("STAGE1_G", ""), seed=seed,
                         device=device)
    export_checkpoint.save_reference_checkpoint(out_path, 0,
                                                net_g=g1.state_dict())
    return out_path


# ------------------------------------------------------------ the tool

def _write_set(variant: str, data_dir: str, img_dir: str, n: int,
               seed: int, device) -> None:
    if variant == "mnist":
        write_synthetic_multimnist(data_dir, n=n, split="train", seed=seed)
    elif variant == "clevr":
        write_synthetic_clevr(data_dir, n=n, split="train", seed=seed)
    elif variant == "coco-attngan":
        write_synthetic_attngan(data_dir, img_dir, n=n, seed=seed,
                                device=device)
    else:
        write_synthetic_coco(data_dir, img_dir, n=n, seed=seed,
                             device=device)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("variant", nargs="?", default="mnist",
                   choices=sorted(VARIANTS))
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--n", type=int, default=0,
                   help="synthetic set size (0 = the variant's default)")
    p.add_argument("--fid_images", type=int, default=128,
                   help="real images of the FID trend")
    p.add_argument("--segments", type=int, default=2,
                   help="trend points across the schedule (train runs, "
                        "each resuming the one before)")
    p.add_argument("--damsm_epochs", type=int, default=0,
                   help="coco-attngan: pretrain the DAMSM encoders for N "
                        "epochs on the same set and train at the full "
                        "composition (LAMBDA 50, the pretrained NET_E)")
    p.add_argument("--snapshot_interval", type=int, default=0,
                   help="checkpoint cadence inside a segment (0 = each "
                        "segment's last epoch only)")
    p.add_argument("--sampling_images", type=int, default=0,
                   help="coco-attngan: run the sampling dump over N "
                        "images after training (0 = skip)")
    p.add_argument("--workdir", default="",
                   help="work directory kept after the run (default: a "
                        "new temporary directory)")
    p.add_argument("--export_pth", default="",
                   help="export the final G as a reference .pth here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    # MOG_COMPUTE_DTYPE=bf16 computes bf16 under --no-bf16 too, as the JAX
    # package's import-time knob does; the train entries read it as well
    args.bf16 = args.bf16 or env_compute_dtype() == torch.bfloat16
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else None
    work = (os.path.abspath(args.workdir) if args.workdir
            else tempfile.mkdtemp(prefix=f"validate_{args.variant}_"))
    os.makedirs(work, exist_ok=True)
    data_dir = os.path.join(work, "data")
    img_dir = os.path.join(work, "imgs")
    n = args.n or SET_SIZES[args.variant]
    _write_set(args.variant, data_dir, img_dir, n, args.seed, device)
    variant = VARIANTS[args.variant]
    cfg_file = CFG_FILES[variant]
    common = ["--manualSeed", str(args.seed), "--device", args.device]
    if args.bf16:
        common.append("--bf16")
    damsm_trend, net_e = [], ""
    if variant == "coco-attngan":
        if args.damsm_epochs > 0:
            damsm_out = os.path.join(work, "damsm")
            cli_main(["--variant", "damsm", "--cfg", CFG_FILES["damsm"],
                      "--data_dir", data_dir, "--img_dir", img_dir,
                      "--output_dir", damsm_out,
                      "--max_epochs", str(args.damsm_epochs),
                      "--snapshot_interval", str(args.damsm_epochs),
                      *common])
            net_e = os.path.join(damsm_out, "DAMSMencoders",
                                 f"text_encoder{args.damsm_epochs - 1}.pth")
            if not os.path.isfile(net_e):
                raise FileNotFoundError(f"DAMSM export missing: {net_e}")
            damsm_trend = _damsm_loss_trend(damsm_out)
            print(f"DAMSM eval-loss trend: {damsm_trend[:2]} ... "
                  f"{damsm_trend[-2:]}", flush=True)
            cfg_file = _write_attngan_full_cfg(work, net_e)
        else:
            cfg_file = _write_attngan_validate_cfg(work)

    def generate(from_dir):
        if variant == "coco-attngan":
            return _generate_attngan(cfg_file, data_dir, img_dir, from_dir,
                                     args.seed, device, dtype)
        if variant == "coco-stackgan-2":
            return _generate_stage2(cfg_file, from_dir, args.seed, device,
                                    dtype)
        return _generate_stage1(cfg_file, variant, from_dir, args.seed,
                                device, dtype)

    def run_cli(to_dir, max_epochs, resume_from=None):
        cli_args = ["--variant", variant, "--cfg", cfg_file,
                    "--data_dir", data_dir, "--output_dir", to_dir,
                    "--synthetic", "--max_epochs", str(max_epochs),
                    "--snapshot_interval",
                    str(args.snapshot_interval or 10 * args.epochs),
                    *common]
        if resume_from:
            cli_args += ["--resume", resume_from]
        if variant.startswith("coco-"):
            cli_args += ["--img_dir", img_dir]
        cli_main(cli_args)

    # the FID trend: the set's images against fresh fixed z and layouts at
    # every point, so that only G's weights move the number
    imgs0, _, _ = generate(os.path.join(work, "never_trained"))
    real = _load_real_images(_glob_images(data_dir, img_dir),
                             size=imgs0.shape[1], limit=args.fid_images,
                             device=device)
    fid_points = [(0, _fid(real, imgs0, device))]
    print(f"FID @ init: {fid_points[0][1]:.2f}", flush=True)

    seg_epochs = sorted({max(1, args.epochs * k // args.segments)
                         for k in range(1, args.segments + 1)})
    prev = imgs = bbox = labels = None
    seg_dirs, sep_points, lf_points = [], [], []
    lf_clf = lf_score = None
    if args.variant == "mnist":
        lf_clf = lf.train_digit_classifier(device=device)
        lf_score = lf.layout_fidelity
    elif args.variant == "clevr":
        lf_clf = lf.train_clevr_classifier(device=device)
        lf_score = lf.clevr_layout_fidelity
    for e in seg_epochs:
        seg_out = os.path.join(work, f"out_e{e}")
        run_cli(seg_out, e, resume_from=prev)
        seg_dirs.append(seg_out)
        imgs, bbox, labels = generate(seg_out)
        fid_points.append((e, _fid(real, imgs, device)))
        sb, so = _separation(imgs, bbox)
        sep_points.append((e, round(sb - so, 3)))
        lf_msg = ""
        if lf_clf is not None:
            score = lf_score(imgs, bbox, labels, lf_clf)
            recall = score.get("recall", score.get("recall_both"))
            lf_points.append((e, recall, score["loc_iou"]))
            lf_msg = f"  recall: {recall:.3f}  loc_iou: {score['loc_iou']:.3f}"
        print(f"FID @ epoch {e}: {fid_points[-1][1]:.2f}  "
              f"separation: {sep_points[-1][1]:.3f}{lf_msg}", flush=True)
        prev = seg_out

    exported = ""
    if args.export_pth:
        dev = ["--device", args.device]
        if args.variant == "coco-stackgan-2":
            # a strict reference load of a stage-2 .pth needs its frozen
            # STAGE1_G (ref model.py:317-320): the one the run trained with
            s1_pth = _export_frozen_s1(cfg_file, args.seed, os.path.join(
                work, "netG_s1_frozen.pth"), device)
            export_checkpoint.main(["stage2", "--cfg", cfg_file, "--ckpt",
                                    prev, "--out", args.export_pth,
                                    "--s1_net_g", s1_pth, *dev])
        elif args.variant == "coco-attngan":
            export_checkpoint.main(["attngan", "--cfg", cfg_file, "--ckpt",
                                    prev, "--out", args.export_pth, *dev])
        else:
            fam = {"mnist": "multi-mnist", "clevr": "clevr",
                   "coco-stackgan-1": "coco-stackgan"}[args.variant]
            export_checkpoint.main(["stage1", "--variant", fam, "--cfg",
                                    cfg_file, "--ckpt", prev, "--out",
                                    args.export_pth, *dev])
        exported = args.export_pth

    sampling_metrics = {}
    if args.sampling_images and variant == "coco-attngan":
        eval_cfg = _write_attngan_eval_cfg(work, cfg_file, prev)
        eval_out = os.path.join(work, "sampling")
        cli_main(["--variant", variant, "--cfg", eval_cfg,
                  "--data_dir", data_dir, "--img_dir", img_dir,
                  "--output_dir", eval_out, "--eval_mode", "sampling",
                  "--num_images", str(args.sampling_images), *common])
        with open(os.path.join(eval_out, "eval_metrics.json")) as f:
            sampling_metrics = json.load(f)

    in_box, out_box = _separation(imgs, bbox)
    out = {
        "workdir": work, "exported_pth": exported,
        "variant": args.variant, "epochs": args.epochs,
        "in_box": round(in_box, 3), "out_box": round(out_box, 3),
        "separation": round(in_box - out_box, 3),
        "separation_trend": [[e, s] for e, s in sep_points],
        "fid_trend": [[e, round(f, 2)] for e, f in fid_points],
        "fid_decreasing": fid_decreasing([f for _, f in fid_points])}
    if args.damsm_epochs and variant == "coco-attngan":
        out["damsm_epochs"] = args.damsm_epochs
        out["net_e"] = net_e
        out["damsm_eval_loss_trend"] = (
            damsm_trend[:1] + damsm_trend[-1:] if damsm_trend else [])
        out["damsm_word_sent"] = _damsm_word_stats(seg_dirs)
    if sampling_metrics:
        out["sampling_eval"] = sampling_metrics
    if lf_clf is not None:
        out["layout_fidelity"] = lf_score(imgs, bbox, labels, lf_clf)
        out["layout_fidelity_trend"] = [[e, r, i] for e, r, i in lf_points]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
