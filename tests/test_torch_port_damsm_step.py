"""The port's DAMSM pretraining step on the CPU against the JAX package.

* ``RNNEncoder`` in train mode with the JAX dropout mask injected against
  JAX ``RNNEncoder(train=True, dropout_rng=...)`` at SMALL_ATOL; in eval
  mode without dropout; the mask it draws itself.
* One step of ``make_damsm_train_step`` and the eval function against
  JAX ``make_damsm_train_step`` / ``make_damsm_eval_fn``, both sides with
  the tiny image encoder of tests/test_damsm_pretrain.py (a frozen stride-4
  conv, a bilinear resize to 17x17, the two heads), from a warm Adam state
  (count ADAM_COUNT, first moments 0, second 1, where an update is linear
  in the gradient): losses and ``rnn_grad_norm`` at LOSS_RTOL of their
  value, per-tensor Adam-delta cosines above MIN_DELTA_COSINE, the
  backbone bit-identical; the clip of 0.25 biting (the norm above it) and
  a clip of 1e6 that does not.
* One step with the real Inception-v3 ``CNNEncoder`` at batch 2 from
  64px, both encoders from runs_r5's ``text_encoder29.pth`` and
  ``image_encoder29.pth`` written out again by the port's export and read
  by JAX ``io/damsm_import``: the import equals that of the original files,
  the eval losses at LOSS_RTOL of their value, the step's at REAL_RTOL.
* The export and import the other way (JAX ``damsm_export`` files load
  strictly into the port), the ``$INCEPTION_V3_WEIGHTS`` backbone warm
  start (``AuxLogits.`` and ``fc.`` dropped, the heads kept), and
  ``damsm_lr`` against the JAX schedule.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from multiple_objects_gan_tpu.cli.damsm_runner import damsm_lr as jdamsm_lr
from multiple_objects_gan_tpu.io.damsm_export import (
    export_image_encoder as jexport_image, export_text_encoder as jexport_text)
from multiple_objects_gan_tpu.io.damsm_import import (
    import_image_encoder, import_text_encoder)
from multiple_objects_gan_tpu.nn.encoders import (
    CNNEncoder as JCNNEncoder, RNNEncoder as JRNNEncoder)
from multiple_objects_gan_tpu.train.damsm_step import (
    create_damsm_state as jcreate_damsm_state,
    make_damsm_eval_fn as jmake_eval_fn,
    make_damsm_train_step as jmake_train_step)
from multiple_objects_gan_tpu_torch.cli import damsm_runner
from multiple_objects_gan_tpu_torch.io import weights as pweights
from multiple_objects_gan_tpu_torch.nn.encoders import (
    RNNEncoder, build_image_encoder, build_text_encoder)
from multiple_objects_gan_tpu_torch.train.damsm_step import (
    make_damsm_eval_fn, make_damsm_train_step)
from multiple_objects_gan_tpu_torch.train.state import (
    TRAINABLE_IMAGE_KEYS, create_damsm_state)
from test_damsm_pretrain import TinyImageEnc

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
DAMSM = os.path.join(ROOT, "runs_r5", "attngan_flagship", "damsm",
                     "DAMSMencoders")
TEXT29 = os.path.join(DAMSM, "text_encoder29.pth")
IMAGE29 = os.path.join(DAMSM, "image_encoder29.pth")
SMALL_ATOL = 1e-5
LOSS_RTOL = 1e-5
REAL_RTOL = 1e-4
MIN_DELTA_COSINE = 0.999
ADAM_COUNT = 10
LR = 2e-3
B, T, NTOKEN, NINPUT, NEF = 4, 6, 20, 8, 16
SMOOTH = {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0}


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


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _batch(b=B, t=T, size=32, seed=0, ntoken=NTOKEN):
    """tests/test_damsm_pretrain.py's batch: uint8 images, ragged captions
    (lengths 2..t, zero-padded) and class ids, one of them repeated."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(2, t + 1, b).astype(np.int32)
    caps = np.zeros((b, t), np.int32)
    for i, ln in enumerate(lens):
        caps[i, :ln] = rng.randint(1, ntoken, ln)
    return {f"image{size}": rng.randint(0, 255, (b, size, size, 3), np.uint8),
            "captions": caps, "cap_lens": lens,
            "class_ids": np.array([0, 1, 0, 3][:b], np.int32)}


def _port_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


def _keep(rng, step, shape):
    """The JAX step's dropout mask: bernoulli(fold_in(rng, step), 0.5)."""
    return _t(jax.random.bernoulli(jax.random.fold_in(rng, step), 0.5,
                                   shape))


# --------------------------------------------------------- text encoder


def test_rnn_encoder_train_mode_dropout_matches_jax():
    """The JAX mask injected: words and sentence at SMALL_ATOL; eval mode
    is the JAX eval forward; a drawn mask keeps about half the values,
    scaled by 2, the same from the same generator seed."""
    batch = _batch(seed=1)
    jenc = JRNNEncoder(ntoken=NTOKEN, ninput=10, nhidden=NEF)
    caps, lens = jnp.asarray(batch["captions"]), jnp.asarray(
        batch["cap_lens"])
    v = jenc.init(jax.random.PRNGKey(0), caps, lens)
    key = jax.random.PRNGKey(5)
    want_w, want_s = jenc.apply(v, caps, lens, train=True, dropout_rng=key)
    keep = _t(jax.random.bernoulli(key, 0.5, (B, T, 10)))
    port = RNNEncoder(NTOKEN, ninput=10, nhidden=NEF)
    port.load_state_dict(pweights.text_encoder_state_dict_from_jax(v),
                         strict=True)
    pcaps, plens = _t(batch["captions"]), _t(batch["cap_lens"])
    with torch.no_grad():
        got_w, got_s = port.train()(pcaps, plens, keep=keep)
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w),
                                   atol=SMALL_ATOL)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   atol=SMALL_ATOL)
        eval_w, _ = port.eval()(pcaps, plens)
        np.testing.assert_allclose(
            eval_w.numpy(), np.asarray(jenc.apply(v, caps, lens)[0]),
            atol=SMALL_ATOL)
        assert float((eval_w - got_w).abs().max()) > 0.01
        drawn = port.train()(pcaps, plens,
                             generator=torch.Generator().manual_seed(11))[0]
        keep_again = torch.rand((B, T, 10),
                                generator=torch.Generator().manual_seed(11))
        keep_again = keep_again < 0.5
        assert torch.equal(drawn, port(pcaps, plens, keep=keep_again)[0])
        assert 0.4 < float(keep_again.float().mean()) < 0.6


# ------------------------------------------------- the step, tiny encoder


class TinyImageEncoder(nn.Module):
    """The port's copy of tests/test_damsm_pretrain.py's TinyImageEnc:
    ``backbone_conv`` (3x3, stride 4, no padding at 32px, which is the JAX
    'SAME' there), a bilinear resize of its map to 17x17, ``emb_features``
    (a 1x1 conv, no bias) and ``emb_cnn_code`` of the pooled map."""

    def __init__(self, nef: int = NEF):
        super().__init__()
        self.backbone_conv = nn.Conv2d(3, 8, 3, stride=4)
        self.emb_features = nn.Conv2d(8, nef, 1, bias=False)
        self.emb_cnn_code = nn.Linear(8, nef)

    def forward(self, x):
        h = self.backbone_conv(x)
        feat = F.interpolate(h, size=(17, 17), mode="bilinear",
                             align_corners=False)
        return self.emb_features(feat), self.emb_cnn_code(h.mean(dim=(2, 3)))


def tiny_state_dict(params) -> dict:
    """TinyImageEnc's JAX params -> TinyImageEncoder's state dict."""
    p = jax.tree.map(np.asarray, params)
    return {"backbone_conv.weight": _t(p["backbone_conv"]["kernel"]
                                       .transpose(3, 2, 0, 1)),
            "backbone_conv.bias": _t(p["backbone_conv"]["bias"]),
            "emb_features.weight": _t(p["emb_features"]["kernel"].T[
                :, :, None, None]),
            "emb_cnn_code.weight": _t(p["emb_cnn_code"]["kernel"].T),
            "emb_cnn_code.bias": _t(p["emb_cnn_code"]["bias"])}


def _warm(jstate):
    """Both sides' Adams at count ADAM_COUNT, m 0, v 1."""
    s = jstate.opt
    return jstate.replace(opt=s._replace(
        count=jnp.full_like(s.count, ADAM_COUNT),
        mu=jax.tree.map(jnp.zeros_like, s.mu),
        nu=jax.tree.map(jnp.ones_like, s.nu)))


def warm_adam(opt):
    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p] = {"step": torch.tensor(float(ADAM_COUNT)),
                            "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.ones_like(p)}


def _cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def _port_params(state) -> dict:
    out = {f"text.{k}": v for k, v in state.text.named_parameters()}
    out.update({f"image.{k}": v for k, v in state.image.named_parameters()})
    return {k: v.detach().clone() for k, v in out.items()}


def _jax_params(jstate, image_sd) -> dict:
    text = pweights.text_encoder_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jstate.text_params)})
    out = {f"text.{k}": v for k, v in text.items()}
    out.update({f"image.{k}": v for k, v in image_sd(
        jstate.image_params).items()})
    return out


def _tiny_pair(seed=0):
    text_enc = JRNNEncoder(ntoken=NTOKEN, ninput=NINPUT, nhidden=NEF)
    image_enc = TinyImageEnc(nef=NEF)
    jstate = _warm(jcreate_damsm_state(text_enc, image_enc,
                                       jax.random.PRNGKey(seed),
                                       batch_size=2, seq_len=T,
                                       image_size=32))
    text = RNNEncoder(NTOKEN, ninput=NINPUT, nhidden=NEF)
    text.load_state_dict(pweights.text_encoder_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jstate.text_params)}),
        strict=True)
    image = TinyImageEncoder()
    image.load_state_dict(tiny_state_dict(jstate.image_params), strict=True)
    state = create_damsm_state(text, image.eval())
    warm_adam(state.opt)
    return (text_enc, image_enc, jstate), state


def _step_both(jside, state, batch, grad_clip, rng):
    text_enc, image_enc, jstate = jside
    jstep = jax.jit(jmake_train_step(text_enc, image_enc, smooth=SMOOTH,
                                     grad_clip=grad_clip))
    jnew, jm = jstep(jstate, batch, rng, np.float32(LR))
    keep = _keep(rng, 0, (B, T, NINPUT))
    pm = make_damsm_train_step(SMOOTH, grad_clip)(
        state, _port_batch(batch), None, LR, keep=keep)
    return jnew, {k: float(v) for k, v in jm.items()}, {
        k: float(v) for k, v in pm.items()}


@pytest.mark.parametrize("grad_clip,bites", [(0.25, True), (1e6, False)])
def test_damsm_step_matches_jax(grad_clip, bites):
    """One step from a warm Adam: the losses and the norm before the clip,
    the Adam deltas of every trained tensor, the step count; the backbone
    and the Adam's coverage (the text encoder and the two heads alone)."""
    jside, state = _tiny_pair()
    assert {id(p) for g in state.opt.param_groups for p in g["params"]} == {
        id(p) for p in [*state.text.parameters(),
                        *state.image.emb_features.parameters(),
                        *state.image.emb_cnn_code.parameters()]}
    before = _port_params(state)
    backbone = {k: v.clone() for k, v in state.image.state_dict().items()
                if not k.startswith(TRAINABLE_IMAGE_KEYS)}
    jnew, jm, pm = _step_both(jside, state, _batch(), grad_clip,
                              jax.random.PRNGKey(3))
    assert set(pm) == set(jm) == {"w_loss", "s_loss", "damsm_loss",
                                  "rnn_grad_norm"}
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=LOSS_RTOL, err_msg=k)
    assert (pm["rnn_grad_norm"] > grad_clip) == bites
    assert state.step == int(jnew.step) == 1
    for k, v in state.image.state_dict().items():
        if k in backbone:
            assert torch.equal(v, backbone[k]), k
    after = _port_params(state)
    want = _jax_params(jnew, tiny_state_dict)
    for k, v in after.items():
        delta, jdelta = v - before[k], want[k] - before[k]
        if k.startswith("image.backbone"):
            assert torch.equal(delta, torch.zeros_like(delta)), k
            continue
        assert float(delta.abs().max()) > 0, k
        assert _cos(delta, jdelta) > MIN_DELTA_COSINE, (k, _cos(delta,
                                                               jdelta))


def test_damsm_eval_fn_matches_jax():
    """No dropout, float32, the same three losses; the class_ids=None path
    (no class mask) too."""
    (text_enc, image_enc, jstate), state = _tiny_pair(seed=2)
    jeval = jax.jit(jmake_eval_fn(text_enc, image_enc, smooth=SMOOTH))
    peval = make_damsm_eval_fn(SMOOTH)
    for drop_ids in (False, True):
        batch = _batch(seed=4)
        if drop_ids:
            del batch["class_ids"]
        want = jeval(jstate, batch)
        got = peval(state, _port_batch(batch))
        assert set(got) == set(want) == {"w_loss", "s_loss", "damsm_loss"}
        for k, v in got.items():
            assert v.dtype == torch.float32
            np.testing.assert_allclose(float(v), float(want[k]),
                                       rtol=LOSS_RTOL, err_msg=k)


# ------------------------------------------------ the step, real encoders


def test_real_encoders_export_import_and_step_match_jax(tmp_path):
    """The flagship DAMSM pair in the port, exported again: JAX's import of
    the exports equals its import of the originals; the eval losses at
    LOSS_RTOL, one step from a warm Adam at REAL_RTOL (batch 2, 64px)."""
    text = build_text_encoder(140, 256, pweights.load_text_encoder(TEXT29),
                              device="cpu")
    image = build_image_encoder(256, pweights.load_image_encoder(IMAGE29),
                                device="cpu")
    state = create_damsm_state(text, image)
    warm_adam(state.opt)
    t_path, i_path = pweights.export_damsm_encoders(text, image,
                                                    str(tmp_path), 29)
    assert os.path.basename(t_path) == "text_encoder29.pth"
    jtext_enc, jimage_enc = JRNNEncoder(ntoken=140, nhidden=256), \
        JCNNEncoder(nef=256)
    tvars = import_text_encoder(t_path, {"params": {}})
    ivars = import_image_encoder(i_path, {"params": {}})
    for got, want in ((tvars, import_text_encoder(TEXT29, {"params": {}})),
                      (ivars, import_image_encoder(IMAGE29,
                                                   {"params": {}}))):
        jax.tree.map(np.testing.assert_array_equal, got, want)
    jstate = _warm(jcreate_damsm_state(
        jtext_enc, jimage_enc, jax.random.PRNGKey(0), text_vars=tvars,
        image_vars=ivars))
    batch = _batch(b=2, t=12, size=64, seed=6, ntoken=140)
    batch["class_ids"] = np.array([0, 1], np.int32)
    want = jax.jit(jmake_eval_fn(jtext_enc, jimage_enc, smooth=SMOOTH))(
        jstate, batch)
    got = make_damsm_eval_fn(SMOOTH)(state, _port_batch(batch))
    for k, v in got.items():
        np.testing.assert_allclose(float(v), float(want[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    rng = jax.random.PRNGKey(8)
    _, jm = jax.jit(jmake_train_step(jtext_enc, jimage_enc, smooth=SMOOTH))(
        jstate, batch, rng, np.float32(LR))
    backbone = image.Mixed_7c.branch_pool.conv.weight.clone()
    pm = make_damsm_train_step(SMOOTH)(state, _port_batch(batch), None, LR,
                                       keep=_keep(rng, 0, (2, 12, 300)))
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                   rtol=REAL_RTOL, err_msg=k)
    assert torch.equal(image.Mixed_7c.branch_pool.conv.weight, backbone)


def test_jax_exports_load_strictly_into_the_port(tmp_path):
    """JAX damsm_export of the flagship pair (after its import) loads into
    build_text_encoder / build_image_encoder with strict=True and gives
    the original tensors."""
    tvars = import_text_encoder(TEXT29, {"params": {}})
    ivars = import_image_encoder(IMAGE29, {"params": {}})
    t_path, i_path = str(tmp_path / "t.pth"), str(tmp_path / "i.pth")
    jexport_text(tvars, t_path)
    jexport_image(ivars, i_path)
    text = build_text_encoder(140, 256, pweights.load_text_encoder(t_path),
                              device="cpu")
    image = build_image_encoder(256, pweights.load_image_encoder(i_path),
                                device="cpu")
    for module, path in ((text, TEXT29), (image, IMAGE29)):
        for k, v in pweights.load_text_encoder(path).items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(module.state_dict()[k], v.float()), k


def test_inception_backbone_warm_start(tmp_path, monkeypatch, capsys):
    """$INCEPTION_V3_WEIGHTS: a torchvision-style state dict (the backbone
    with AuxLogits. and fc. besides) sets the backbone and leaves the
    heads at their seeded init; a file with other keys raises."""
    src = build_image_encoder(NEF, seed=9, device="cpu").state_dict()
    sd = {k: v for k, v in src.items()
          if not k.startswith(pweights.DAMSM_HEADS)}
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), \
        torch.zeros(1000)
    path = str(tmp_path / "inception_v3.pth")
    torch.save(sd, path)
    monkeypatch.setenv(damsm_runner.BACKBONE_ENV, path)
    text, image = damsm_runner.init_damsm_encoders(
        "", NTOKEN, NEF, seed=1, device="cpu")
    assert f"Load Inception backbone from: {path}" in capsys.readouterr().out
    fresh = build_image_encoder(NEF, seed=1, device="cpu").state_dict()
    for k, v in image.state_dict().items():
        want = fresh[k] if k.startswith(pweights.DAMSM_HEADS) else src[k]
        assert torch.equal(v, want), k
    sd["Mixed_8a.conv.weight"] = torch.zeros(1)
    torch.save(sd, path)
    with pytest.raises(KeyError, match="not an inception_v3 backbone"):
        damsm_runner.init_damsm_encoders("", NTOKEN, NEF, seed=1,
                                         device="cpu")


def test_without_backbone_or_net_e_warns(monkeypatch, capsys):
    monkeypatch.delenv(damsm_runner.BACKBONE_ENV, raising=False)
    damsm_runner.init_damsm_encoders("", NTOKEN, NEF, seed=1, device="cpu")
    assert "WARNING: $INCEPTION_V3_WEIGHTS unset and no NET_E" in \
        capsys.readouterr().out


def test_damsm_lr_matches_jax():
    for epoch in range(201):
        assert damsm_runner.damsm_lr(0.002, epoch) == jdamsm_lr(0.002, epoch)
    assert damsm_runner.damsm_lr(0.002, 200) == 0.0002
