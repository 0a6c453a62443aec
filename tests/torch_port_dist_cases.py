"""What the port's multi-process tests run on each rank (not a test module).

tests/test_torch_port_multihost.py, tests/test_torch_port_sync_bn.py and
tests/test_torch_port_bn_span.py write lists of cases and hand them to
``multiple_objects_gan_tpu_torch.tools.dist_steps.spawn``: two or four
processes, a process group over gloo on localhost, on the CPU. Step cases
run the port's train steps; call cases name a function of this module.
The module imports no JAX, so that a rank starts in a few seconds, and the
stand-in image encoders live here so that a rank can unpickle them.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
ATTN_TRAIN = os.path.join(ROOT, "cfg", "coco_attn_train.yml")
FEATURES = 2048             # the pooled features of an Inception encoder


# -------------------------------------------------- stand-in encoders


def _pool_matrix(size: int, out: int = 17) -> np.ndarray:
    """(out, size): the mean of each of ``out`` contiguous bins (as
    tests/test_torch_port_attngan_step.py pools)."""
    m = np.zeros((out, size), np.float32)
    for p in range(out):
        lo, hi = (p * size) // out, -((-(p + 1) * size) // out)
        m[p, lo:hi] = 1.0 / (hi - lo)
    return m


class PoolImageEncoder(nn.Module):
    """AttnGAN's image-encoder stand-in (tests/test_torch_port_attngan_
    step.py:TinyImageEncoder): regions (B, nef, 17, 17), a fixed average
    pool of the image and a 3 -> nef map, and their mean as the code; with
    ``return_pool`` also (B, 2048) pooled features, a fixed 3 -> 2048 map
    of the image's mean colour. It computes in its weights' dtype (float64
    after ``.double()``)."""

    def __init__(self, nef: int = 16, seed: int = 5):
        super().__init__()
        rs = np.random.RandomState(seed)
        self.register_buffer("w", torch.from_numpy(
            rs.randn(3, nef).astype(np.float32) * 0.5))
        self.w_pool = nn.Parameter(torch.from_numpy(
            rs.randn(3, FEATURES).astype(np.float32)), requires_grad=False)

    def forward(self, x, return_pool: bool = False):
        x = x.to(self.w.dtype)
        m = torch.from_numpy(_pool_matrix(x.shape[-1])).to(x)
        pooled = torch.einsum("ph,bchw,qw->bcpq", m, x, m)
        region = torch.einsum("bcpq,cd->bdpq", pooled, self.w)
        code = region.mean(dim=(2, 3))
        if not return_pool:
            return region, code
        return region, code, torch.tanh(x.mean(dim=(2, 3)) @ self.w_pool)


class HeadImageEncoder(nn.Module):
    """DAMSM's image-encoder stand-in (tests/test_torch_port_damsm_step.py:
    TinyImageEncoder): a frozen 3x3/4 conv, its map resized to 17x17,
    and the trained heads ``emb_features`` and ``emb_cnn_code``."""

    def __init__(self, nef: int = 16):
        super().__init__()
        self.backbone_conv = nn.Conv2d(3, 8, 3, stride=4)
        self.emb_features = nn.Conv2d(8, nef, 1, bias=False)
        self.emb_cnn_code = nn.Linear(8, nef)

    def forward(self, x):
        h = self.backbone_conv(x)
        feat = F.interpolate(h, size=(17, 17), mode="bilinear",
                             align_corners=False)
        return self.emb_features(feat), self.emb_cnn_code(h.mean(dim=(2, 3)))


# --------------------------------------------------------- sync-BN


def bn_input(counts: tuple, seed: int = 0) -> dict:
    """A float64 batch of sum(counts) rows for a BatchNorm2d (4 channels)
    and an object-pathway BatchNorm2d (3 objects folded O-minor), with the
    weights of a loss on each output."""
    rs = np.random.RandomState(seed)
    n = sum(counts)
    x = rs.randn(n, 4, 3, 3) * 2.0 + 0.5
    xo = rs.randn(n * 3, 4, 2, 2) * 1.5 - 0.3
    return {"x": torch.from_numpy(x), "xo": torch.from_numpy(xo),
            "w": torch.from_numpy(rs.randn(*x.shape)),
            "wo": torch.from_numpy(rs.randn(*xo.shape))}


def _bn_run(x, w, module, steps: int = 2) -> dict:
    """``steps`` train-mode forwards of ``module`` on ``x``, the loss
    sum(y * w) back each time: the last output, the input's and the
    weight's gradients, and the running statistics."""
    for _ in range(steps):
        module.zero_grad()
        xi = x.clone().requires_grad_(True)
        y = module(xi)
        (y * w).sum().backward()
    return {"y": y.detach(), "x_grad": xi.grad, "w_grad":
            module.weight.grad.clone(), "running_mean":
            module.running_mean.clone(), "running_var":
            module.running_var.clone()}


def sync_bn_rank(counts: tuple, seed: int = 0) -> dict:
    """This rank's rows (``counts[rank]`` of them, in rank order) of
    :func:`bn_input` through the port's BatchNorm2d and ObjectBatchNorm2d
    in float64, under the process group: the sync-BN of nn/blocks.py."""
    from multiple_objects_gan_tpu_torch.nn.blocks import (
        BatchNorm2d, ObjectBatchNorm2d)
    from multiple_objects_gan_tpu_torch.parallel.multihost import rank

    inp = bn_input(counts, seed)
    lo = sum(counts[:rank()])
    rows = slice(lo, lo + counts[rank()])
    orows = slice(3 * lo, 3 * (lo + counts[rank()]))
    torch.manual_seed(seed)
    plain = BatchNorm2d(4).double().train()
    obj = ObjectBatchNorm2d(4, 3).double().train()
    with torch.no_grad():
        for m in (plain, obj):
            m.weight.uniform_(0.5, 1.5)
            m.bias.normal_()
    return {"plain": _bn_run(inp["x"][rows], inp["w"][rows], plain),
            "object": _bn_run(inp["xo"][orows], inp["wo"][orows], obj)}


def span_bn_rank(counts: tuple, object_counts: tuple, groups: int,
                 seed: int = 0) -> dict:
    """This rank's rows (``counts[rank]`` of them, in rank order) of
    :func:`bn_input`'s ``x`` through the port's BatchNorm2d, and its rows
    (``object_counts[rank]``, equal on every rank, as an object pathway
    sees the full batch) of ``xo`` of :func:`bn_input` (``object_counts``)
    through an ObjectBatchNorm2d, in float32 at ``groups`` statistic
    groups of the global batch, one train-mode forward and backward each:
    the groups may span ranks (nn/blocks.py). Returns each module's
    initial weights and buffers beside :func:`_bn_run`'s record."""
    from multiple_objects_gan_tpu_torch.nn.blocks import (
        BatchNorm2d, ObjectBatchNorm2d)
    from multiple_objects_gan_tpu_torch.parallel.multihost import rank

    def mine(key, cts, scale):
        inp = bn_input(cts, seed)
        lo = sum(cts[:rank()])
        rows = slice(scale * lo, scale * (lo + cts[rank()]))
        return inp[key][rows].float(), inp["w" + key[1:]][rows].float()

    torch.manual_seed(seed)
    out = {}
    for kind, m, (x, w) in (
            ("plain", BatchNorm2d(4, groups=groups), mine("x", counts, 1)),
            ("object", ObjectBatchNorm2d(4, 3, groups=groups),
             mine("xo", object_counts, 3))):
        with torch.no_grad():
            m.weight.uniform_(0.5, 1.5)
            m.bias.normal_()
            m.running_mean.normal_(0.0, 0.2)
            m.running_var.uniform_(0.5, 1.5)
        init = {k: v.clone() for k, v in m.state_dict().items()}
        out[kind] = {"init": init, **_bn_run(x, w, m.train(), steps=1)}
    return out


# ----------------------------------------------------- the sharded dump


def sampling_dump(data: str, imgs: str, out: str, n_words: int,
                  batch: int, num_images: int, seed: int = 3) -> dict:
    """``cli/attngan_runner.py:sampling`` of the test split at GF 4,
    embedding 16, R_NUM 1 (G, text encoder from seeds, the
    :class:`PoolImageEncoder` as the FID and IS encoder), under whatever
    process group runs it. The host FID, a 2048-square matrix root that
    takes tens of seconds here, is replaced by the squared distance of the
    feature means; the features it is computed from are returned."""
    from multiple_objects_gan_tpu_torch.cli import attngan_runner
    from multiple_objects_gan_tpu_torch.data.attngan import attngan_split
    from multiple_objects_gan_tpu_torch.models.attngan import (
        COCO_ATTN, build_attngan_g)
    from multiple_objects_gan_tpu_torch.nn.encoders import (
        build_text_encoder)
    import dataclasses

    mcfg = dataclasses.replace(COCO_ATTN, gf_dim=4, df_dim=4, r_num=1,
                               embedding_dim=16)
    st = _Split(words_num=12)
    ds = attngan_split(data, imgs, st, seed, "test", device="cpu")
    g = build_attngan_g(mcfg, seed=4, device="cpu")
    text = build_text_encoder(n_words, 16, seed=5, device="cpu")
    fid = attngan_runner.fid_from_activations
    attngan_runner.fid_from_activations = lambda a, b: float(
        np.square(a.mean(0) - b.mean(0)).sum())
    try:
        got = attngan_runner.sampling(
            ds, mcfg, g, text, PoolImageEncoder(), out,
            image_prov="imported", batch_size=batch, seed=seed,
            device="cpu", num_images=num_images)
    finally:
        attngan_runner.fid_from_activations = fid
    return {k: got.get(k) for k in ("metrics", "real_acts", "fake_acts")}


class _Split:
    """The TEXT and TREE settings ``attngan_split`` reads."""

    def __init__(self, words_num: int):
        self.base_size, self.branch_num = 64, 3
        self.captions_per_image, self.words_num = 5, words_num


# ------------------------------------------------------- the entries


def tiny_attngan_cfg(path: str, data_dir: str, batch: int = 8) -> str:
    """cfg/coco_attn_train.yml at GF 4, DF 4, embedding 16, R_NUM 1 and
    the global ``batch`` (tests/test_torch_port_attngan_entry.py:
    tiny_cfg), no NET_G and no NET_E, WORDS_NUM 5: longer captions are
    subsampled, a draw that depends on the item, so each rank's reader
    state is its own."""
    with open(ATTN_TRAIN) as f:
        text = f.read()
    text = (text.replace("BATCH_SIZE: 14", f"BATCH_SIZE: {batch}")
            .replace("GF_DIM: 48", "GF_DIM: 4")
            .replace("DF_DIM: 96", "DF_DIM: 4")
            .replace("R_NUM: 3", "R_NUM: 1")
            .replace("EMBEDDING_DIM: 256", "EMBEDDING_DIM: 16")
            .replace("WORDS_NUM: 12", "WORDS_NUM: 5")
            .replace("DATA_DIR: 'data/coco/coco'", f"DATA_DIR: '{data_dir}'")
            .replace("NET_E: 'DAMSMencoders/coco/text_encoder100.pth'",
                     "NET_E: ''"))
    with open(path, "w") as f:
        f.write(text)
    return path


def attngan_entry(argv: list) -> list:
    """``cli/main.py`` with ``argv`` and AttnGAN's image encoder replaced
    by the :class:`PoolImageEncoder`, under the running process group;
    returns its history."""
    from multiple_objects_gan_tpu_torch.cli import attngan_runner
    from multiple_objects_gan_tpu_torch.cli import main as port_main

    build = attngan_runner.build_image_encoder
    attngan_runner.build_image_encoder = (
        lambda nef=256, *a, **k: PoolImageEncoder(nef))
    try:
        return port_main.main(argv)
    finally:
        attngan_runner.build_image_encoder = build
