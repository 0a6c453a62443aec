"""The port's AttnGAN discriminator side (multiple_objects_gan_tpu_torch:
``func_attention``, the DAMSM losses, ``DNet64``/``DNetScale`` with their
heads and blocks, the Inception-v3 ``CNNEncoder`` and their weight
mappings) against the JAX package, on the CPU.

Inputs come from a numpy seed; the JAX D weights and statistics are drawn
anew (tests/test_torch_port_stage1g.py:_randomize) and carried across by
``attngan_d_state_dict_from_jax``. JAX runs at "highest" precision.
Tolerances:

* ``func_attention``, ``words_loss``, ``sent_loss`` (ragged lengths,
  repeated class ids) and their gradients: SMALL_ATOL 1e-5, and 1e-5 of
  the value for the losses;
* the Ds at df 8, batch 4, eval: features and probabilities at
  D_ATOL 5e-5 (read: 4.5e-6 on the features, 3.0e-7 on the
  probabilities);
* the Ds in train mode: the port in float32 against itself in float64 at
  TRAIN_F64_ATOL 5e-4, JAX against that at TRAIN_ATOL 1e-2 (its
  BatchNorm's E[x^2] - E[x]^2 variance loses digits), the port the nearer;
  the running statistics, the object pathway's three updates among them,
  at STATS_ATOL 1e-5 of float64 (relative for variances) and JAX's at
  TRAIN_ATOL;
* the resize to 299: ``F.interpolate(bilinear, align_corners=False)``
  against ``jax.image.resize(bilinear)`` from 64 and from 256 at
  RESIZE_ATOL 1e-6 (read: 1.2e-7);
* ``CNNEncoder`` loaded with runs_r5's ``image_encoder29.pth`` in both
  packages, one 64px and one 256px image (the JAX side traced once, at
  299x299 after its own resize): regions and codes at ENCODER_ATOL 1e-5
  (read: 3.2e-8 and 7.5e-8, on values up to 0.021), well inside the 2e-3
  that tests/test_cnn_encoder_parity.py holds the JAX encoder to against
  a torch replica.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multiple_objects_gan_tpu.io.damsm_import import import_image_encoder
from multiple_objects_gan_tpu.io.torch_export import export_attngan_d
from multiple_objects_gan_tpu.losses.damsm import (
    sent_loss as jsent_loss, words_loss as jwords_loss)
from multiple_objects_gan_tpu.models.attngan import (
    COCO_ATTN as JCOCO_ATTN, DNet64 as JDNet64, DNetScale as JDNetScale)
from multiple_objects_gan_tpu.nn.attention import (
    func_attention as jfunc_attention)
from multiple_objects_gan_tpu.nn.encoders import CNNEncoder as JCNNEncoder
from multiple_objects_gan_tpu_torch.io.weights import (
    attngan_d_state_dict_from_jax, image_encoder_state_dict_from_jax,
    load_image_encoder)
from multiple_objects_gan_tpu_torch.losses.damsm import sent_loss, words_loss
from multiple_objects_gan_tpu_torch.models.attngan import (
    COCO_ATTN, build_attngan_d)
from multiple_objects_gan_tpu_torch.nn.attention import func_attention
from multiple_objects_gan_tpu_torch.nn.encoders import build_image_encoder
from test_torch_port_stage1g import _randomize

SMALL_ATOL = 1e-5
D_ATOL = 5e-5
TRAIN_F64_ATOL = 5e-4
TRAIN_ATOL = 1e-2
STATS_ATOL = 1e-5
RESIZE_ATOL = 1e-6
ENCODER_ATOL = 1e-5
ROUNDING = 1e-6     # below it neither side is "the nearer" to float64
B = 4
T = 7
NEF = 16
_TINY = dict(gf_dim=8, df_dim=8, condition_dim=16, embedding_dim=NEF)
JCFG = dataclasses.replace(JCOCO_ATTN, **_TINY)
PCFG = dataclasses.replace(COCO_ATTN, **_TINY)
IMAGE_ENCODER = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "runs_r5",
    "attngan_flagship", "damsm", "DAMSMencoders", "image_encoder29.pth")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _highest_precision():
    prev = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", prev)


def _nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(x), (0, 3, 1, 2))))


def _close(got, want, what, atol=SMALL_ATOL, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=what)


# ------------------------------------------------ attention and DAMSM


def _damsm_inputs(seed):
    rs = np.random.RandomState(seed)
    region = rs.randn(B, 17, 17, NEF).astype(np.float32)
    words = rs.randn(B, T, NEF).astype(np.float32)
    lens = np.array([3, T, 1, 5], np.int64)
    words[np.arange(T)[None, :] >= lens[:, None]] = 0.0  # as the encoder
    code = rs.randn(B, NEF).astype(np.float32)
    sent = rs.randn(B, NEF).astype(np.float32)
    return region, words, lens, code, sent


def test_func_attention_matches_jax_with_ragged_masks():
    region, words, lens, _, _ = _damsm_inputs(0)
    mask = np.arange(T)[None, :] >= lens[:, None]
    wei, attn = jfunc_attention(jnp.asarray(words), jnp.asarray(region), 4.0,
                                query_mask=jnp.asarray(mask))
    got_wei, got_attn = func_attention(
        torch.from_numpy(words), _nchw(region), 4.0, torch.from_numpy(mask))
    _close(got_wei, wei, "weighted context")
    _close(got_attn, attn, "attention")
    # a padded word's column is uniform over the regions
    np.testing.assert_allclose(got_attn[2, :, :, 1].numpy(), 1.0 / 289,
                               rtol=1e-5)


@pytest.mark.parametrize("class_ids", [None, [4, 2, 4, 4]],
                         ids=["no_classes", "repeated_classes"])
def test_words_and_sent_loss_match_jax(class_ids):
    """Both losses, both directions, the own-image attention maps, and
    the gradients of the summed losses with respect to the regions and
    the image codes."""
    region, words, lens, code, sent = _damsm_inputs(1)
    jcls = None if class_ids is None else jnp.asarray(class_ids)
    pcls = None if class_ids is None else torch.tensor(class_ids)

    def jtotal(r, c):
        w0, w1, att = jwords_loss(r, jnp.asarray(words), jnp.asarray(lens),
                                  jcls, 4.0, 5.0, 10.0)
        s0, s1 = jsent_loss(c, jnp.asarray(sent), jcls, 10.0)
        return w0 + w1 + s0 + s1, (w0, w1, s0, s1, att)

    (_, (w0, w1, s0, s1, att)), (gr, gc) = jax.value_and_grad(
        jtotal, argnums=(0, 1), has_aux=True)(jnp.asarray(region),
                                               jnp.asarray(code))
    r = _nchw(region).requires_grad_(True)
    c = torch.from_numpy(code).requires_grad_(True)
    pw0, pw1, patt = words_loss(r, torch.from_numpy(words),
                                torch.from_numpy(lens), pcls, 4.0, 5.0, 10.0)
    ps0, ps1 = sent_loss(c, torch.from_numpy(sent), pcls, 10.0)
    for name, got, want in (("w0", pw0, w0), ("w1", pw1, w1),
                            ("s0", ps0, s0), ("s1", ps1, s1)):
        _close(got, want, name, rtol=SMALL_ATOL)
    _close(patt, att, "own attention maps")
    (pw0 + pw1 + ps0 + ps1).backward()
    _close(r.grad, np.transpose(np.asarray(gr), (0, 3, 1, 2)),
           "d/d regions")
    _close(c.grad, gc, "d/d codes")


# --------------------------------------------------------- the Ds


def _jax_d(scale, seed):
    """A JAX D of ``scale`` (its heads' variables merged in, as JAX
    create_attngan_state merges them), every weight and statistic drawn
    anew."""
    mod = JDNet64(JCFG) if scale == 64 else JDNetScale(JCFG, scale=scale)
    img = jnp.zeros((2, scale, scale, 3))
    labels = jnp.zeros((2, 3, 81)).at[:, :, 0].set(1.0)
    bbox = jnp.tile(jnp.array([0.25, 0.25, 0.5, 0.5]), (2, 3, 1))
    r = jax.random.PRNGKey(0)
    v = mod.init(r, img, labels, bbox, train=True) if scale == 64 else \
        mod.init(r, img, train=True)
    h = jnp.zeros((2, 4, 4, JCFG.df_dim * 8))
    vh = mod.init(r, h, jnp.zeros((2, NEF)), train=True,
                  method="cond_logits")
    vu = mod.init(r, h, train=True, method="uncond_logits")
    p = {**v["params"], **vh["params"], **vu["params"]}
    s = {**v["batch_stats"], **vh["batch_stats"]}
    rng = np.random.RandomState(seed)
    p = _randomize(jax.tree.map(np.asarray, p), rng, "params")
    s = _randomize(jax.tree.map(np.asarray, s), rng, "stats")
    return mod, p, s


def _d_inputs(scale, seed):
    rs = np.random.RandomState(seed)
    bbox = rs.uniform(0.05, 0.4, (B, 3, 4)).astype(np.float32)
    bbox[:, :, 2:] += 0.15
    bbox[1, 2] = -1.0                       # a padded object
    labels = np.zeros((B, 3, 81), np.float32)
    labels[np.arange(B)[:, None], np.arange(3)[None, :],
           rs.randint(0, 81, (B, 3))] = 1.0
    return {"img": rs.uniform(-1, 1, (B, scale, scale, 3)).astype(
        np.float32), "labels": labels, "bbox": bbox,
            "cond": rs.randn(B, NEF).astype(np.float32)}


def _jax_d_apply(mod, p, s, x, train):
    """Features, conditional and unconditional probabilities, and the
    batch statistics after the three calls, in the step's order."""
    mut = ["batch_stats"] if train else False
    dv = {"params": p, "batch_stats": s}
    args = (x["img"], x["labels"], x["bbox"]) if isinstance(mod, JDNet64) \
        else (x["img"],)
    out = mod.apply(dv, *map(jnp.asarray, args), train=train, mutable=mut)
    feat, s = out if train else (out, {"batch_stats": s})
    dv = {"params": p, **s}
    out = mod.apply(dv, feat, jnp.asarray(x["cond"]), train=train,
                    method="cond_logits", mutable=mut)
    pc, s = out if train else (out, s)
    dv = {"params": p, **s}
    out = mod.apply(dv, feat, train=train, method="uncond_logits",
                    mutable=mut)
    pu, s = out if train else (out, s)
    return (np.transpose(np.asarray(feat), (0, 3, 1, 2)), np.asarray(pc),
            np.asarray(pu)), jax.tree.map(np.asarray, s["batch_stats"])


def _port_d_apply(d, x, dtype):
    t = {k: torch.from_numpy(v).to(dtype) for k, v in x.items()}
    img = t["img"].permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        feat = d(img, t["labels"], t["bbox"])
        return feat, d.cond_logits(feat, t["cond"]), d.uncond_logits(feat)


@pytest.fixture(scope="module", params=[64, 128, 256],
                ids=["d64", "d128", "d256"])
def dnet(request):
    scale = request.param
    mod, p, s = _jax_d(scale, seed=scale)
    sd = attngan_d_state_dict_from_jax(p, s, scale)
    return scale, mod, p, s, sd


def test_d_eval_forward_matches_jax(dnet):
    scale, mod, p, s, sd = dnet
    x = _d_inputs(scale, 1)
    want, _ = _jax_d_apply(mod, p, s, x, train=False)
    d = build_attngan_d(PCFG, scale, sd, device="cpu").eval()
    got = _port_d_apply(d, x, torch.float32)
    for name, g, w in zip(("features", "cond", "uncond"), got, want):
        _close(g, w, f"d{scale} eval {name}", atol=D_ATOL)
    assert 0.0 < float(got[1].min()) and float(got[1].max()) < 1.0


def test_d_train_forward_and_statistics_match_float64_and_jax(dnet):
    """Train mode: the features and both heads' probabilities, then every
    running statistic after feat, cond and uncond."""
    scale, mod, p, s, sd = dnet
    x = _d_inputs(scale, 2)
    want, new_stats = _jax_d_apply(mod, p, s, x, train=True)
    outs, sds = {}, {}
    for dt in (torch.float32, torch.float64):
        d = build_attngan_d(PCFG, scale, sd, device="cpu").to(dt).train()
        outs[dt] = _port_d_apply(d, x, dt)
        sds[dt] = d.state_dict()
    for i, name in enumerate(("features", "cond", "uncond")):
        ref = outs[torch.float64][i].numpy()
        port_gap = float(np.abs(outs[torch.float32][i].double().numpy()
                                - ref).max())
        jax_gap = float(np.abs(want[i] - ref).max())
        assert port_gap <= TRAIN_F64_ATOL, (name, port_gap)
        assert jax_gap <= TRAIN_ATOL, (name, jax_gap)
        assert port_gap <= max(jax_gap, ROUNDING), (name, port_gap, jax_gap)
    want_sd = attngan_d_state_dict_from_jax(p, new_stats, scale)
    keys = [k for k in want_sd if k.endswith(("running_mean",
                                              "running_var"))]
    assert keys
    for k in keys:
        ref = sds[torch.float64][k].numpy()
        _close(sds[torch.float32][k].double(), ref, k, atol=STATS_ATOL,
               rtol=STATS_ATOL)
        _close(want_sd[k].double(), ref, k, atol=TRAIN_ATOL,
               rtol=TRAIN_ATOL)
    if scale == 64:     # three per-object updates of the object pathway
        assert int(sds[torch.float32]["local.1.num_batches_tracked"]) == 3


def test_d_state_dict_keys_are_the_jax_exports(dnet):
    """The port's state-dict keys equal JAX ``export_attngan_d``'s (the
    reference's netD%d.pth keys), and load strictly."""
    scale, _, p, s, sd = dnet
    port = build_attngan_d(PCFG, scale, device="cpu").state_dict()
    assert set(port) == set(sd) == set(export_attngan_d(p, s, scale))


# ------------------------------------------------------ the image encoder


@pytest.mark.parametrize("side", [64, 256])
def test_resize_to_299_matches_jax_image_resize(side):
    """F.interpolate(bilinear, align_corners=False) is the JAX encoder's
    jax.image.resize(bilinear) from 64 and from 256, edges included."""
    x = np.random.RandomState(side).uniform(-1, 1, (1, side, side, 3))
    want = jax.image.resize(jnp.asarray(x, jnp.float32), (1, 299, 299, 3),
                            method="bilinear")
    got = F.interpolate(_nchw(x.astype(np.float32)), size=(299, 299),
                        mode="bilinear", align_corners=False)
    _close(got.permute(0, 2, 3, 1), want, f"resize {side}",
           atol=RESIZE_ATOL)


@pytest.fixture(scope="module")
def image_encoders():
    variables = import_image_encoder(IMAGE_ENCODER, {"params": {}})
    port = build_image_encoder(256, load_image_encoder(IMAGE_ENCODER),
                               device="cpu")
    return variables, port


def test_image_encoder_state_dict_round_trips_the_jax_import(image_encoders):
    """image_encoder_state_dict_from_jax inverts JAX import_image_encoder:
    the result is image_encoder29.pth's tensors, key for key."""
    variables, port = image_encoders
    sd = image_encoder_state_dict_from_jax(variables)
    raw = load_image_encoder(IMAGE_ENCODER)
    assert set(sd) == set(raw) == set(port.state_dict())
    for k, v in raw.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], v.float()), k


def test_cnn_encoder_with_image_encoder29_matches_jax(image_encoders):
    """The flagship's image encoder in both packages, one 64px and one
    256px image: the JAX side takes both at 299 after its own
    jax.image.resize (one trace), the port each at its own size."""
    variables, port = image_encoders
    rs = np.random.RandomState(7)
    xs = [rs.uniform(-1, 1, (1, s, s, 3)).astype(np.float32)
          for s in (64, 256)]
    big = jnp.concatenate([jax.image.resize(jnp.asarray(x), (1, 299, 299, 3),
                                            method="bilinear") for x in xs])
    region, code = jax.jit(lambda v, x: JCNNEncoder(nef=256).apply(
        v, x, train=False))(variables, big)
    for i, x in enumerate(xs):
        with torch.no_grad():
            got_r, got_c = port(_nchw(x))
        assert got_r.shape == (1, 256, 17, 17) and got_c.shape == (1, 256)
        _close(got_r, np.transpose(np.asarray(region[i:i + 1]),
                                   (0, 3, 1, 2)),
               f"regions from {x.shape[1]}", atol=ENCODER_ATOL)
        _close(got_c, code[i:i + 1], f"code from {x.shape[1]}",
               atol=ENCODER_ATOL)
