"""The port's AttnGAN generator side (multiple_objects_gan_tpu_torch: the GLU
blocks, the GLU CA net, word attention, the DAMSM text encoder, GNet,
their weight mappings, and the text side of the AttnGAN data) against the
JAX package, on the CPU.

Inputs come from a numpy seed; the JAX weights and statistics are drawn
anew (tests/test_torch_port_stage1g.py:_randomize: BatchNorm away from its
init, kernels at He scale) and carried across by
``attngan_g_state_dict_from_jax`` and ``text_encoder_state_dict_from_jax``.
JAX runs at "highest" precision, both sides in float32. Tolerances:

* blocks, CA net, attention, text encoder: SMALL_ATOL 2e-5;
* GNet at gf 4, condition 8, embedding 8, R_NUM 1, branches 2 and 3,
  batch 2, eval: images and attention maps at GNET_ATOL 5e-5 (JAX
  composes nearest-2x + conv3x3 into one dilated conv, a different order
  of float32 sums, over up to eleven convs in a row; read: 1.3e-5);
* GNet in train mode: the port in float32 against itself in float64 at
  TRAIN_F64_ATOL 5e-4 (read: 1.0e-4), JAX against that at TRAIN_ATOL
  1e-2 (read: 2.7e-3; its BatchNorm's E[x^2] - E[x]^2 variance loses
  digits at batch 2), the port the nearer; running statistics: the port
  at STATS_ATOL 1e-5 of float64, JAX at TRAIN_ATOL (both relative for
  variances too);
* the flagship ``netG_ema_final.pth`` and ``text_encoder29.pth`` loaded by
  both packages, batch 1: word and sentence embeddings at SMALL_ATOL, the
  64, 128 and 256px images at FLAGSHIP_ATOL 2e-4 (read: 3.9e-5, 4.0e-6,
  1.3e-5), the attention maps at SMALL_ATOL;
* the synthetic data and the vocabulary: exact.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multiple_objects_gan_tpu.data import attngan as jdata
from multiple_objects_gan_tpu.io.damsm_import import import_text_encoder
from multiple_objects_gan_tpu.io.torch_import import import_attngan_g
from multiple_objects_gan_tpu.models.attngan import (
    COCO_ATTN as JCOCO_ATTN, GNet as JGNet)
from multiple_objects_gan_tpu.nn import blocks as jblocks
from multiple_objects_gan_tpu.nn.attention import (
    GlobalAttention as JGlobalAttention)
from multiple_objects_gan_tpu.nn.encoders import RNNEncoder as JRNNEncoder
from multiple_objects_gan_tpu.nn.pathways import CANet as JCANet
from multiple_objects_gan_tpu_torch.data import attngan as pdata
from multiple_objects_gan_tpu_torch.io import weights as pweights
from multiple_objects_gan_tpu_torch.io.pycompat import load_pickle
from multiple_objects_gan_tpu_torch.models.attngan import (
    COCO_ATTN, GNet, build_attngan_g)
from multiple_objects_gan_tpu_torch.nn.attention import GlobalAttention
from multiple_objects_gan_tpu_torch.nn.blocks import (
    ResBlockGLU, UpBlockGLU, glu)
from multiple_objects_gan_tpu_torch.nn.encoders import (
    RNNEncoder, build_text_encoder)
from multiple_objects_gan_tpu_torch.nn.pathways import CANet
from test_torch_port_stage1g import _randomize

SMALL_ATOL = 2e-5
GNET_ATOL = 5e-5
TRAIN_F64_ATOL = 5e-4
TRAIN_ATOL = 1e-2
STATS_ATOL = 1e-5
FLAGSHIP_ATOL = 2e-4
B = 2
T = 6
FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "runs_r5", "attngan_flagship")
NET_G = os.path.join(FLAGSHIP, "netG_ema_final.pth")
NET_E = os.path.join(FLAGSHIP, "damsm", "DAMSMencoders",
                     "text_encoder29.pth")
_TINY = dict(gf_dim=4, condition_dim=8, embedding_dim=8, r_num=1)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _highest_precision():
    prev = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", prev)


def _nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(x), (0, 3, 1, 2))))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, what, atol=SMALL_ATOL, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _stats_close(port_sd, want_sd, what):
    keys = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        _close(port_sd[k], want_sd[k].numpy(), f"{what}:{k}",
               rtol=SMALL_ATOL if k.endswith("var") else 0.0)


def _jax_vars(module, rng, *args, **kw):
    v = jax.jit(lambda r: module.init(r, *args, **kw))(jax.random.PRNGKey(0))
    p = _randomize(jax.tree.map(np.asarray, v["params"]), rng, "params")
    s = _randomize(jax.tree.map(np.asarray, v.get("batch_stats", {})), rng,
                   "stats")
    return p, s


# --------------------------------------------------------------- the blocks


class _Holder(nn.Module):
    """One block under the name ``blk``, so the weight helpers' prefixes
    apply."""

    def __init__(self, blk):
        super().__init__()
        self.blk = blk

    def forward(self, x):
        return self.blk(x)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", ["up", "res"])
def test_glu_blocks_match_jax(kind, train):
    """UpBlockGLU (8 -> 2 * 6 -> GLU 6, 8x8 -> 16x16) and ResBlockGLU (6
    channels, no final ReLU) against the JAX blocks, eval and train; in
    train mode the running statistics too."""
    rng = np.random.RandomState(10)
    cin = 8 if kind == "up" else 6
    x = rng.randn(3, 8, 8, cin).astype(np.float32)
    jmod = jblocks.UpBlockGLU(6) if kind == "up" else jblocks.ResBlockGLU(6)
    p, s = _jax_vars(jmod, rng, jnp.asarray(x), train=False)
    want, new = jmod.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                           train=train, mutable=["batch_stats"])
    sd, want_sd = {}, {}
    helper = (pweights._upblock if kind == "up" else pweights._resblock)
    helper(sd, "blk", p, s)
    helper(want_sd, "blk", p, jax.tree.map(np.asarray, new["batch_stats"]))
    port = _Holder(UpBlockGLU(cin, 6) if kind == "up" else ResBlockGLU(6))
    port.load_state_dict(sd, strict=True)
    port.train(train)
    got = port(_nchw(x))
    _close(_nhwc(got), want, f"{kind} train={train}")
    if train:
        _stats_close(port.state_dict(), want_sd, kind)


def test_glu_halves_the_channels():
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 6, 3, 3).astype(
        np.float32))
    want = jblocks.glu(jnp.asarray(_nhwc(x)))
    _close(_nhwc(glu(x)), want, "glu")


def test_glu_ca_net_mu_path_matches_jax():
    """The GLU CA net (fc 8 -> 4 * 5, GLU, mu and logvar) with no rng: c =
    mu on both sides."""
    rng = np.random.RandomState(11)
    text = rng.randn(4, 8).astype(np.float32)
    jmod = JCANet(5, use_glu=True)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(text))
    fc = v["params"]["Dense_0"]["Dense_0"]
    fc = {"kernel": rng.randn(*fc["kernel"].shape).astype(np.float32),
          "bias": rng.randn(*fc["bias"].shape).astype(np.float32)}
    want = jmod.apply({"params": {"Dense_0": {"Dense_0": fc}}},
                      jnp.asarray(text))
    port = CANet(8, 5, use_glu=True)
    port.load_state_dict({"fc.weight": torch.from_numpy(fc["kernel"].T.copy()),
                          "fc.bias": torch.from_numpy(fc["bias"])})
    got = port(torch.from_numpy(text))
    for g, w, name in zip(got, want, ("c", "mu", "logvar")):
        _close(g, w, name)
    assert torch.equal(got[0], got[1])


def test_global_attention_ragged_masks_match_jax():
    """Batch 3 with 2, 6 and 4 valid words of 6: context and maps, each
    sample's padded words at weight 0."""
    rng = np.random.RandomState(12)
    h = rng.randn(3, 5, 7, 4).astype(np.float32)
    words = rng.randn(3, T, 8).astype(np.float32)
    mask = np.arange(T)[None, :] >= np.array([2, 6, 4])[:, None]
    jmod = JGlobalAttention(4)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(words),
                  jnp.asarray(mask))
    kernel = rng.randn(8, 4).astype(np.float32)
    want_ctx, want_att = jmod.apply(
        {"params": {"conv_context": {"kernel": kernel}}}, jnp.asarray(h),
        jnp.asarray(words), jnp.asarray(mask))
    assert v["params"]["conv_context"]["kernel"].shape == kernel.shape
    port = GlobalAttention(4, 8)
    port.load_state_dict({"conv_context.weight": torch.from_numpy(
        kernel.T.copy())[:, :, None, None]})
    ctx, att = port(_nchw(h), torch.from_numpy(words),
                    torch.from_numpy(mask))
    _close(_nhwc(ctx), want_ctx, "context")
    _close(att, want_att, "attention maps")
    assert att.shape == (3, 5, 7, T)
    assert float(att[0, ..., 2:].detach().abs().max()) == 0.0


def _text_batch(rng, ntoken, lens, t=T):
    """Captions with words at every position, padding included: the
    encoder must not read past a sentence's length."""
    caps = rng.randint(1, ntoken, (len(lens), t)).astype(np.int32)
    return caps, np.asarray(lens, np.int32)


def test_rnn_encoder_ragged_lengths_match_jax():
    """Lengths 6, 1, 3, 5 of 6, unsorted: word embeddings (zeros past each
    length) and sentence embeddings (the forward state at len - 1, the
    backward one at step 0)."""
    rng = np.random.RandomState(13)
    caps, lens = _text_batch(rng, 20, [6, 1, 3, 5])
    jmod = JRNNEncoder(ntoken=20, ninput=10, nhidden=16)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(caps),
                  jnp.asarray(lens))
    want_w, want_s = jmod.apply(v, jnp.asarray(caps), jnp.asarray(lens))
    port = RNNEncoder(20, ninput=10, nhidden=16)
    port.load_state_dict(pweights.text_encoder_state_dict_from_jax(v),
                         strict=True)
    port.eval()
    with torch.no_grad():
        words, sent = port(torch.from_numpy(caps), torch.from_numpy(lens))
    _close(words, want_w, "words")
    _close(sent, want_s, "sentence")
    assert float(words[1, 1:].abs().max()) == 0.0
    with pytest.raises(ValueError):
        port(torch.from_numpy(caps), torch.zeros(4, dtype=torch.int64))


# -------------------------------------------------------------------- GNet


def _gnet_inputs(seed, cfg, b=B):
    """z, a sentence and word embeddings with ragged masks, boxes (one
    partly off the canvas, the last item's last object padded) and
    one-hots (the padded one in slot 80)."""
    rng = np.random.RandomState(seed)
    o = cfg.num_objects
    w, h = rng.uniform(0.2, 0.45, (b, o)), rng.uniform(0.2, 0.45, (b, o))
    bbox = np.stack([rng.uniform(0, 1 - w), rng.uniform(0, 1 - h), w, h],
                    -1).astype(np.float32)
    bbox[0, 0, 0] = -0.1
    bbox[-1, -1] = -1.0
    labels = np.zeros((b, o, 81), np.float32)
    labels[np.arange(b)[:, None], np.arange(o)[None, :],
           rng.randint(0, 80, (b, o))] = 1.0
    labels[-1, -1] = 0.0
    labels[-1, -1, 80] = 1.0
    mask = np.arange(T)[None, :] >= rng.randint(1, T + 1, b)[:, None]
    return {"z": rng.randn(b, cfg.z_dim).astype(np.float32),
            "sent": rng.randn(b, cfg.embedding_dim).astype(np.float32),
            "words": rng.randn(b, T, cfg.embedding_dim).astype(np.float32),
            "mask": mask, "bbox": bbox, "labels": labels}


_ORDER = ("z", "sent", "words", "mask", "bbox", "labels")


@pytest.fixture(scope="module", params=[2, 3])
def gnets(request):
    """JAX GNet at the tiny widths and ``branch_num`` 2 or 3, every weight
    and statistic drawn anew, and the port's from the same values."""
    jcfg = dataclasses.replace(JCOCO_ATTN, branch_num=request.param, **_TINY)
    pcfg = dataclasses.replace(COCO_ATTN, branch_num=request.param, **_TINY)
    jg = JGNet(jcfg)
    data = _gnet_inputs(0, jcfg)
    p, s = _jax_vars(jg, np.random.RandomState(20 + request.param),
                     *(jnp.asarray(data[k]) for k in _ORDER), train=False)
    sd = pweights.attngan_g_state_dict_from_jax(p, s, request.param, 1)
    return jg, (p, s), build_attngan_g(pcfg, sd, device="cpu"), pcfg


def _jax_gnet(jg, p, s, data, train):
    return jg.apply({"params": p, "batch_stats": s},
                    *(jnp.asarray(data[k]) for k in _ORDER), train=train,
                    ca_rng=None, mutable=["batch_stats"])


def _port_gnet(g, data):
    return g.outputs(*(torch.from_numpy(data[k]) for k in _ORDER))


def _held(out, want, what):
    assert len(out.imgs) == len(want["imgs"])
    for i, (got, w) in enumerate(zip(out.imgs, want["imgs"])):
        _close(_nhwc(got), w, f"{what} image {i}", atol=GNET_ATOL)
    assert len(out.att_maps) == len(want["att_maps"])
    for i, (got, w) in enumerate(zip(out.att_maps, want["att_maps"])):
        _close(got, w, f"{what} attention {i}", atol=GNET_ATOL)
    _close(out.mu, want["mu"], f"{what} mu")
    _close(out.logvar, want["logvar"], f"{what} logvar")


def test_gnet_eval_forward_matches_jax(gnets):
    jg, (p, s), g, cfg = gnets
    data = _gnet_inputs(1, cfg)
    want, _ = _jax_gnet(jg, p, s, data, train=False)
    with torch.no_grad():
        out = _port_gnet(g, data)
    _held(out, want, "eval")
    assert out.imgs[-1].shape == (B, 3, 64 * 2 ** (cfg.branch_num - 1),
                                  64 * 2 ** (cfg.branch_num - 1))
    assert float(out.imgs[-1].std()) > 0.1


def _worst(got, want) -> float:
    return max(float(np.abs(np.asarray(g, np.float64)
                            - np.asarray(w, np.float64)).max())
               for g, w in zip(got, want))


def test_gnet_train_forward_and_statistics_match_jax(gnets):
    """Train mode (batch statistics, c = mu): images, maps, and every
    running statistic after the forward, the object pathway's and the
    label embedding's with their per-object updates. At batch 2 the JAX
    BatchNorm's E[x^2] - E[x]^2 variance loses digits (its images sit up
    to 2.7e-3 from float64 here), so the port in float32 is held against
    itself in float64 at TRAIN_F64_ATOL, JAX against that at TRAIN_ATOL,
    and the port must be the nearer of the two."""
    jg, (p, s), g, cfg = gnets
    data = _gnet_inputs(2, cfg)
    want, new = _jax_gnet(jg, p, s, data, train=True)
    outs, sds = {}, {}
    for dt in (torch.float32, torch.float64):
        port = GNet(cfg)
        port.load_state_dict(g.state_dict())
        port.to(dt).train()
        with torch.no_grad():
            outs[dt] = port.outputs(*(
                torch.from_numpy(data[k]).to(dt) if k != "mask"
                else torch.from_numpy(data[k]) for k in _ORDER))
        sds[dt] = port.state_dict()
    f32, f64 = outs[torch.float32], outs[torch.float64]
    jimgs = [np.transpose(np.asarray(w), (0, 3, 1, 2)) for w in want["imgs"]]
    for name, got, ref, jax_out in (
            ("images", f32.imgs, f64.imgs, jimgs),
            ("attention", f32.att_maps, f64.att_maps, want["att_maps"])):
        port_gap, jax_gap = _worst(got, ref), _worst(jax_out, ref)
        assert port_gap <= TRAIN_F64_ATOL, (name, port_gap)
        assert jax_gap <= TRAIN_ATOL, (name, jax_gap)
        assert port_gap <= jax_gap, (name, port_gap, jax_gap)
    want_sd = pweights.attngan_g_state_dict_from_jax(
        p, jax.tree.map(np.asarray, new["batch_stats"]), cfg.branch_num, 1)
    keys = [k for k in want_sd if k.endswith(("running_mean",
                                              "running_var"))]
    for k in keys:
        ref = sds[torch.float64][k]
        _close(sds[torch.float32][k].double(), ref.numpy(), k,
               atol=STATS_ATOL, rtol=STATS_ATOL)
        _close(want_sd[k].double(), ref.numpy(), k, atol=TRAIN_ATOL,
               rtol=TRAIN_ATOL)


def test_gnet_reference_state_dict_loads_in_both(gnets):
    """A reference-format G_NET state dict drawn in the port (He-scale
    weights, BatchNorm away from its init) loads into the JAX GNet through
    its importer, and both give the same images; the key set equals the
    JAX export's."""
    jg, (p, s), g, cfg = gnets
    gen = torch.Generator().manual_seed(5)
    sd = {}
    for k, v in g.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
        elif k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=gen) + 0.5
        elif v.dim() == 1:
            sd[k] = torch.randn(v.shape, generator=gen) * 0.2 + (
                1.0 if k.endswith("weight") else 0.0)
        else:
            sd[k] = torch.randn(v.shape, generator=gen) * (
                2.0 / v[0].numel()) ** 0.5
    port = build_attngan_g(cfg, sd, device="cpu")
    jp, js = import_attngan_g({"netG": {k: v.numpy() for k, v in sd.items()}},
                              branch_num=cfg.branch_num, r_num=1)
    data = _gnet_inputs(3, cfg)
    want, _ = _jax_gnet(jg, jp, js, data, train=False)
    with torch.no_grad():
        out = _port_gnet(port, data)
    _held(out, want, "reference state dict")
    assert set(sd) == set(pweights.attngan_g_state_dict_from_jax(
        p, s, cfg.branch_num, 1))


def test_random_init_is_seeded_and_orthogonal():
    cfg = dataclasses.replace(COCO_ATTN, **_TINY)
    a = build_attngan_g(cfg, seed=3, device="cpu").state_dict()
    b = build_attngan_g(cfg, seed=3, device="cpu").state_dict()
    c = build_attngan_g(cfg, seed=4, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["h_net1.fc.0.weight"], c["h_net1.fc.0.weight"])
    w = a["h_net2.residual.0.block.0.weight"]          # (16, 8, 3, 3)
    w = w.reshape(w.shape[0], -1)
    torch.testing.assert_close(w @ w.t(), torch.eye(w.shape[0]), atol=1e-5,
                               rtol=0)
    e = build_text_encoder(30, 8, seed=3, device="cpu").state_dict()
    assert float(e["encoder.weight"].abs().max()) <= 0.1


# ------------------------------------------------- the flagship, full width


def test_flagship_weights_full_width_match_jax():
    """The repository's trained EMA G (GF 48, ngf 768, R_NUM 3, three
    branches) and DAMSM text encoder (140 words), loaded by both packages,
    batch 1, a 5-word caption of 12 and two objects of three."""
    ckpt = pweights.load_reference_attngan_g(NET_G)
    jp, js = import_attngan_g(ckpt)
    rng = np.random.RandomState(30)
    caps = np.zeros((1, 12), np.int32)
    caps[0, :5] = rng.randint(1, 140, 5)
    lens = np.array([5], np.int32)
    jenc = JRNNEncoder(ntoken=140, nhidden=256)
    tv = import_text_encoder(NET_E, jenc.init(
        jax.random.PRNGKey(0), jnp.asarray(caps), jnp.asarray(lens)))
    want_w, want_s = jenc.apply(tv, jnp.asarray(caps), jnp.asarray(lens))
    enc = build_text_encoder(140, 256, pweights.load_text_encoder(NET_E),
                             device="cpu")
    with torch.no_grad():
        words, sent = enc(torch.from_numpy(caps), torch.from_numpy(lens))
    _close(words, want_w, "flagship words")
    _close(sent, want_s, "flagship sentence")

    bbox = np.full((1, 3, 4), -1.0, np.float32)
    bbox[0, :2] = [[0.1, 0.2, 0.3, 0.35], [0.5, 0.4, 0.3, 0.3]]
    labels = np.zeros((1, 3, 81), np.float32)
    labels[0, 0, 5] = labels[0, 1, 17] = 1.0
    data = {"z": rng.randn(1, 100).astype(np.float32),
            "sent": np.array(want_s), "words": np.array(want_w),
            "mask": caps == 0, "bbox": bbox, "labels": labels}
    want = jax.jit(lambda v, *a: JGNet(JCOCO_ATTN).apply(v, *a, train=False))(
        {"params": jp, "batch_stats": js},
        *(jnp.asarray(data[k]) for k in _ORDER))
    g = build_attngan_g(COCO_ATTN, ckpt, device="cpu")
    with torch.no_grad():
        out = _port_gnet(g, data)
    for i, (got, w) in enumerate(zip(out.imgs, want["imgs"])):
        assert got.shape[-1] == 64 * 2 ** i
        _close(_nhwc(got), w, f"flagship image {i}", atol=FLAGSHIP_ATOL)
    for i, (got, w) in enumerate(zip(out.att_maps, want["att_maps"])):
        _close(got, w, f"flagship attention {i}")
    assert float(out.imgs[-1].std()) > 0.2


# ---------------------------------------------------------------- the data


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            out[os.path.relpath(path, root)] = path
    return out


def test_synthetic_set_matches_the_jax_writer(tmp_path):
    """n 16: the same text files and pickles (the JAX writer's JPEGs
    aside), and the same vocabulary and caption ids from either
    package's reader."""
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jdata.write_synthetic_attngan(jdir, str(tmp_path / "imgs"), n=16, seed=3)
    pdata.write_synthetic_attngan(pdir, n=16, seed=3)
    jfiles, pfiles = _tree(jdir), _tree(pdir)
    assert set(jfiles) == set(pfiles)
    assert len([f for f in pfiles if f.startswith("text")]) == 16 + 4
    assert os.listdir(tmp_path / "imgs")              # JAX wrote JPEGs
    for rel in jfiles:
        with open(jfiles[rel], "rb") as a, open(pfiles[rel], "rb") as b:
            ja, pb = a.read(), b.read()
        if rel.endswith(".pickle"):
            ja, pb = pickle.loads(ja), pickle.loads(pb)
            np.testing.assert_array_equal(np.asarray(ja), np.asarray(pb),
                                          err_msg=rel)
        else:
            assert ja == pb, rel
    jds = jdata.AttnGanDataset(jdir, str(tmp_path / "imgs"), split="test",
                               captions_per_image=5)
    pds = pdata.AttnGanDataset(pdir, split="test", captions_per_image=5)
    assert pds.wordtoix == jds.wordtoix and pds.n_words == jds.n_words
    assert pds.captions == jds.captions
    np.testing.assert_array_equal(pds.bboxes, jds.bboxes)
    np.testing.assert_array_equal(pds.labels, jds.labels)
    assert pds.filenames == jds.filenames and len(pds) == len(jds)


def test_captions_cache_reads_across(tmp_path):
    """The captions.pickle one package writes, the other reads to the same
    vocabulary; tokenize agrees on mixed text."""
    for writer, reader in ((jdata, pdata), (pdata, jdata)):
        d = str(tmp_path / writer.__name__.split(".")[0])
        if writer is jdata:
            jdata.write_synthetic_attngan(d, str(tmp_path / "imgs"), n=8,
                                          seed=4)
            built = jdata.AttnGanDataset(d, str(tmp_path / "imgs"),
                                         split="train")
            read = pdata.AttnGanDataset(d, split="train")
        else:
            pdata.write_synthetic_attngan(d, n=8, seed=4)
            built = pdata.AttnGanDataset(d, split="train")
            read = jdata.AttnGanDataset(d, str(tmp_path / "imgs"),
                                        split="train")
        assert os.path.isfile(os.path.join(d, "captions.pickle"))
        assert read.wordtoix == built.wordtoix
        assert read.ixtoword == built.ixtoword
        assert read.captions == built.captions
        assert load_pickle(os.path.join(d, "captions.pickle"))[3] \
            == built.wordtoix
    text = "A Cat, on the  MAT! obj3's café 42"
    assert pdata.tokenize(text) == jdata.tokenize(text)


def test_flagship_vocabulary_rebuilds_from_its_seed(tmp_path):
    """write_synthetic_attngan(n=2048, seed=7), the flagship's data, gives
    exactly the 140 words of text_encoder29.pth's embedding rows."""
    pdata.write_synthetic_attngan(str(tmp_path), n=2048, seed=7)
    ds = pdata.AttnGanDataset(str(tmp_path), split="test")
    rows = pweights.load_text_encoder(NET_E)["encoder.weight"].shape[0]
    assert ds.n_words == len(ds.wordtoix) == rows == 140
    assert ds.ixtoword[0] == "<end>"
    assert sum(w.startswith("obj") for w in ds.wordtoix) == 80
    assert sum(w.startswith("loc") for w in ds.wordtoix) == 9
    assert sum(w.startswith("word") for w in ds.wordtoix) == 50
