"""The port's COCO StackGAN stage 2 models (multiple_objects_gan_tpu_torch:
Stage2G, Stage2D, their weight mappings and the reference ``.pth`` split)
against the JAX package, on the CPU.

Sizes: gf 8, df 4, text and condition 16, R_NUM 2, 256px, batch 2, inputs
from a numpy seed; every JAX weight and statistic drawn anew
(tests/test_torch_port_stage1g.py:_randomize) and carried across by
``stage2_*_state_dict_from_jax``. JAX runs at "highest" precision, both
sides in float32. Tolerances, as tests/test_torch_port_clevr.py holds
stage 1's:

* eval forwards: SMALL_ATOL 2e-5;
* train forwards: SMALL_ATOL against the port in float64, TRAIN_ATOL 1e-4
  against JAX, the port the nearer of the two to float64 (the JAX
  BatchNorm's E[x^2] - E[x]^2 variance loses digits);
* running statistics after a train forward: SMALL_ATOL against JAX (the
  relative SMALL_ATOL for variances); the object-fold BatchNorms' (O
  sequential updates a forward) at STATS_ATOL 1e-6 against the port in
  float64, and the label embedding's against JAX as well. The JAX
  statistics of local1 and local2, deep in the G, sit up to 1.8e-5 from
  float64 at these sizes, the port's within 2e-7;
* the plain place at stage 2's sides against the Pallas kernel in
  interpret mode and both against float64: PLACE_ULPS float32 ulps of the
  largest source coordinate (the test's docstring).
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import multiple_objects_gan_tpu.ops.stn_pallas as sp
from multiple_objects_gan_tpu.io import torch_export as tx
from multiple_objects_gan_tpu.models import common as jcommon
from multiple_objects_gan_tpu.models.stage1 import Stage1D as JStage1D
from multiple_objects_gan_tpu.models.stage1 import Stage1G as JStage1G
from multiple_objects_gan_tpu.models.stage2 import (
    COCO_S2 as JCOCO_S2, Stage2D as JStage2D, Stage2G as JStage2G)
from multiple_objects_gan_tpu.train.step import (
    create_state as jcreate_state, create_state_stage2 as jcreate_state2)
from multiple_objects_gan_tpu_torch.io.weights import (
    split_stage2_g, stage1_g_state_dict_from_jax,
    stage2_d_state_dict_from_jax, stage2_g_state_dict_from_jax, warm_start)
from multiple_objects_gan_tpu_torch.models import common
from multiple_objects_gan_tpu_torch.models.stage1 import build_stage1_g
from multiple_objects_gan_tpu_torch.models.stage2 import (
    Stage2D, Stage2G, build_stage2_d, build_stage2_g)
from multiple_objects_gan_tpu_torch.nn.blocks import ObjectBatchNorm2d
stn = importlib.import_module("multiple_objects_gan_tpu_torch.ops.stn")
from multiple_objects_gan_tpu_torch.ops.stn_place_cuda import (
    place_tile, stn_place_multi_plain)
from multiple_objects_gan_tpu_torch.train.state import create_state_stage2
from test_torch_port_stage1g import _randomize

SMALL_ATOL = 2e-5
TRAIN_ATOL = 1e-4
STATS_ATOL = 1e-6
PLACE_ULPS = 4
B = 2
R_NUM = 2
_TINY = dict(gf_dim=8, df_dim=4, text_dim=16, condition_dim=16,
             d_cond_dim=16)
JS1 = dataclasses.replace(jcommon.COCO_S1, **_TINY)
JS2 = dataclasses.replace(JCOCO_S2, **_TINY)
PS1 = dataclasses.replace(common.COCO_S1, **_TINY)
PS2 = dataclasses.replace(common.COCO_S2, r_num=R_NUM, **_TINY)


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


def stage2_inputs(seed: int, b: int = B) -> dict:
    """A 64px stage-1 image and a 256px image in [-1, 1], stage-1 and
    stage-2 boxes that differ (one partly off the canvas, the last object
    of the last item padded), one-hots (a padded object's in slot 80) and
    text embeddings."""
    rng = np.random.RandomState(seed)
    o = 3

    def boxes():
        w, h = rng.uniform(0.2, 0.45, (b, o)), rng.uniform(0.2, 0.45, (b, o))
        bb = np.stack([rng.uniform(0, 1 - w), rng.uniform(0, 1 - h), w, h],
                      -1).astype(np.float32)
        bb[0, 0, 0] = -0.1
        bb[-1, -1] = -1.0
        return bb

    labels = np.zeros((b, o, 81), np.float32)
    labels[np.arange(b)[:, None], np.arange(o)[None, :],
           rng.randint(0, 80, (b, o))] = 1.0
    labels[-1, -1] = 0.0
    labels[-1, -1, 80] = 1.0
    return {"stage1_img": rng.uniform(-1, 1, (b, 64, 64, 3)).astype(
                np.float32),
            "image": rng.uniform(-1, 1, (b, 256, 256, 3)).astype(np.float32),
            "bbox": boxes(), "bbox_s2": boxes(), "label_onehot": labels,
            "text_embedding": rng.randn(b, 16).astype(np.float32)}


def _nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(x), (0, 3, 1, 2))))


def _close(got, want, what, atol=SMALL_ATOL, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _stats_close(port_sd, want_sd, what, atol=SMALL_ATOL):
    keys = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        _close(port_sd[k], want_sd[k].numpy(), f"{what}:{k}", atol=atol,
               rtol=atol if k.endswith("var") else 0.0)


@pytest.fixture(scope="module")
def nets():
    """JAX Stage2G/Stage2D at the tiny widths with every weight and
    statistic drawn anew, and the JAX stage-1 G's for the ``.pth``."""
    jg, jd = JStage2G(JS2, r_num=R_NUM), JStage2D(JS2)
    st = jcreate_state2(JS2, jg, jd, jax.random.PRNGKey(0), batch_size=2)
    rng = np.random.RandomState(3)
    g = (_randomize(jax.tree.map(np.asarray, st.g_params), rng, "params"),
         _randomize(jax.tree.map(np.asarray, st.g_stats), rng, "stats"))
    d = (_randomize(jax.tree.map(np.asarray, st.d_params), rng, "params"),
         _randomize(jax.tree.map(np.asarray, st.d_stats), rng, "stats"))
    return jg, jd, g, d


def _g_args(data, dtype=torch.float32):
    s1 = _nchw(data["stage1_img"]).to(dtype)
    return [s1, torch.from_numpy(data["bbox"]),
            torch.from_numpy(data["bbox_s2"]),
            torch.from_numpy(data["label_onehot"]).to(dtype),
            torch.from_numpy(data["text_embedding"]).to(dtype)]


def _jax_g(jg, p, s, data, train, key=None):
    args = [jnp.asarray(data[k]) for k in ("stage1_img", "bbox", "bbox_s2",
                                           "label_onehot", "text_embedding")]
    return jg.apply({"params": p, "batch_stats": s}, *args, train=train,
                    ca_rng=key, mutable=["batch_stats"])


def test_stage2_g_eval_forward_matches_jax(nets):
    """Eval mode, c = mu (no CA rng on either side)."""
    jg, _, (p, s), _ = nets
    data = stage2_inputs(4)
    out, _ = _jax_g(jg, p, s, data, False)
    port = build_stage2_g(PS2, stage2_g_state_dict_from_jax(p, s, R_NUM),
                          device="cpu")
    with torch.no_grad():
        got = port.outputs(*_g_args(data))
    assert got.img.shape == (B, 3, 256, 256)
    _close(got.img.permute(0, 2, 3, 1), out["img"], "eval image")
    _close(got.mu, out["mu"], "mu")
    _close(got.logvar, out["logvar"], "logvar")
    assert float(got.img.std()) > 0.05


def test_stage2_g_train_forward_and_statistics_match_jax(nets):
    """Train mode with the JAX CA net's eps replayed: the image against
    float64 and JAX, mu, and every running statistic after the forward,
    the object-fold BatchNorms' O updates (local1, local2, the label
    embedding) included."""
    jg, _, (p, s), _ = nets
    data = stage2_inputs(5)
    key = jax.random.PRNGKey(6)
    out, new = _jax_g(jg, p, s, data, True, key)
    eps = torch.from_numpy(np.array(jax.random.normal(
        key, (B, JS2.condition_dim), jnp.float32)))
    sd = stage2_g_state_dict_from_jax(p, s, R_NUM)
    port = build_stage2_g(PS2, sd, device="cpu").train()
    assert isinstance(port.local1[2], ObjectBatchNorm2d)
    got = port.outputs(*_g_args(data), eps)
    port64 = build_stage2_g(PS2, sd, device="cpu").train().double()
    exact = port64.outputs(*_g_args(data, torch.float64),
                           eps.double()).img.detach()
    img = got.img.detach()
    want = np.transpose(np.asarray(out["img"]), (0, 3, 1, 2))
    _close(img, exact.float().numpy(), "image against float64")
    _close(img, want, "image against JAX", atol=TRAIN_ATOL)
    assert float((img.double() - exact).abs().max()) <= float(
        np.abs(want - exact.numpy()).max())
    _close(got.mu, out["mu"], "mu")
    want_sd = stage2_g_state_dict_from_jax(
        p, jax.tree.map(np.asarray, new["batch_stats"]), R_NUM)
    now, now64 = port.state_dict(), port64.state_dict()
    _stats_close(now, want_sd, "G2")
    for k in ("label.1", "local1.2", "local2.2"):
        for stat in ("running_mean", "running_var"):
            key = f"{k}.{stat}"
            _close(now[key], now64[key].float().numpy(),
                   f"{key} against float64", atol=STATS_ATOL)
        assert int(now[f"{k}.num_batches_tracked"]) == 3      # O updates
    _close(now["label.1.running_mean"], want_sd["label.1.running_mean"],
           "label.1 against JAX", atol=STATS_ATOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_stage2_d_features_and_both_heads_match_jax(nets, train):
    """D2's features on 256px images with the stage-2 boxes, the
    conditional head on a 16-d condition and the unconditional head; in
    train mode against float64 and JAX, then every running statistic."""
    _, jd, _, (p, s) = nets
    data = stage2_inputs(7)
    cond = np.random.RandomState(8).randn(B, 16).astype(np.float32)
    jargs = (jnp.asarray(data["image"]), jnp.asarray(data["label_onehot"]),
             jnp.asarray(data["bbox_s2"]))
    feat, new = jd.apply({"params": p, "batch_stats": s}, *jargs,
                         train=train, mutable=["batch_stats"])
    logits, new2 = jd.apply({"params": p, **new}, feat, jnp.asarray(cond),
                            train=train, method="cond_logits",
                            mutable=["batch_stats"])
    ulogits, _ = jd.apply({"params": p, **new}, feat, train=train,
                          method="uncond_logits", mutable=["batch_stats"])
    want = {"features": np.transpose(np.asarray(feat), (0, 3, 1, 2)),
            "cond logits": np.asarray(logits),
            "uncond logits": np.asarray(ulogits)}
    sd = stage2_d_state_dict_from_jax(p, s)

    def run(dtype):
        port = build_stage2_d(PS2, sd, device="cpu").train(train).to(dtype)
        h = port(_nchw(data["image"]).to(dtype),
                 torch.from_numpy(data["label_onehot"]).to(dtype),
                 torch.from_numpy(data["bbox_s2"]))
        c = torch.from_numpy(cond).to(dtype)
        return port, {"features": h.detach(),
                      "cond logits": port.cond_logits(h, c).detach(),
                      "uncond logits": port.uncond_logits(h).detach()}

    port, got = run(torch.float32)
    assert got["features"].shape == (B, 8 * PS2.df_dim, 4, 4)
    assert port.local[0].in_channels == 3 + 81
    assert port.conv4.in_channels == 6 * PS2.df_dim
    if not train:
        for k in want:
            _close(got[k], want[k], k)
        return
    _, exact = run(torch.float64)
    for k in want:
        _close(got[k], exact[k].float().numpy(), f"{k} against float64")
        _close(got[k], want[k], f"{k} against JAX", atol=TRAIN_ATOL)
    stats = {**s, **jax.tree.map(np.asarray, new2["batch_stats"])}
    want_sd = stage2_d_state_dict_from_jax(p, stats)
    now = port.state_dict()
    for k in ["local.1", "local.4", "get_cond_logits.outlogits.1"] + [
            f"bn{i}" for i in range(2, 9)]:
        _close(now[f"{k}.running_mean"], want_sd[f"{k}.running_mean"], k)
        _close(now[f"{k}.running_var"], want_sd[f"{k}.running_var"], k,
               rtol=SMALL_ATOL)
    _close(now["local.1.running_mean"], want_sd["local.1.running_mean"],
           "local.1, O sequential updates", atol=STATS_ATOL)
    assert int(now["local.1.num_batches_tracked"]) == 3


def test_state_dict_keys_equal_the_jax_exports(nets):
    """The port's mappings give the JAX package's export_stage2_g/_d keys
    and values, and Stage2G/Stage2D hold exactly those keys."""
    _, _, (gp, gs), (dp, ds) = nets
    for got, want, module in (
            (stage2_g_state_dict_from_jax(gp, gs, R_NUM),
             tx.export_stage2_g(None, None, gp, gs, JS1, r_num=R_NUM),
             Stage2G(PS2)),
            (stage2_d_state_dict_from_jax(dp, ds), tx.export_stage2_d(dp, ds),
             Stage2D(PS2))):
        assert sorted(got) == sorted(want) == sorted(module.state_dict())
        for k in got:
            np.testing.assert_array_equal(
                got[k].numpy(), np.asarray(want[k]).reshape(got[k].shape),
                err_msg=k)
        module.load_state_dict(got, strict=True)


def test_reference_pth_with_its_stage1_part_splits_and_loads(nets, tmp_path):
    """A STAGE2_G ``.pth`` as the JAX package exports it (the frozen
    STAGE1_G under ``STAGE1_G.``) and a STAGE2_D ``.pth``: the split gives
    the stage-1 keys to G1 and the rest to G2, each loaded strict=True, by
    the stage-2 warm start."""
    _, _, (gp, gs), (dp, ds) = nets
    j1 = jcreate_state(JS1, JStage1G(JS1), JStage1D(JS1),
                       jax.random.PRNGKey(1), batch_size=2)
    rng = np.random.RandomState(9)
    p1 = _randomize(jax.tree.map(np.asarray, j1.g_params), rng, "params")
    s1 = _randomize(jax.tree.map(np.asarray, j1.g_stats), rng, "stats")
    ref_g = {k: torch.as_tensor(np.array(v)) for k, v in tx.export_stage2_g(
        p1, s1, gp, gs, JS1, r_num=R_NUM).items()}
    ref_d = {k: torch.as_tensor(np.array(v))
             for k, v in tx.export_stage2_d(dp, ds).items()}
    torch.save({"netG": ref_g}, tmp_path / "netG.pth")
    torch.save(ref_d, tmp_path / "netD.pth")
    part1, part2 = split_stage2_g(ref_g)
    assert sorted(part1) == sorted(stage1_g_state_dict_from_jax(p1, s1, PS1))
    assert sorted(part2) == sorted(Stage2G(PS2).state_dict())
    assert split_stage2_g(part2) == (None, part2)

    state = create_state_stage2(PS2, seed=0, device="cpu")
    g1 = build_stage1_g(PS1, seed=0, device="cpu")
    loaded = warm_start(state, str(tmp_path / "netG.pth"),
                        str(tmp_path / "netD.pth"), frozen_g=g1)
    assert loaded == [str(tmp_path / "netG.pth"), str(tmp_path / "netD.pth")]
    for module, want in ((g1, part1), (state.g, part2), (state.d, ref_d)):
        now = module.state_dict()
        for k, v in want.items():
            torch.testing.assert_close(now[k], v.reshape(now[k].shape),
                                       rtol=0, atol=0, msg=k)


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run K1 in Pallas interpret mode, as tests/test_stn_pallas.py does."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(sp.pl, "pallas_call", patched)


def _place_float64(feats, bbox, out_side):
    """The place in float64 throughout, hat weights included: the exact
    value both float32 ways of computing it are held to."""
    b, o, _, hi, _ = feats.shape
    theta = stn.transformation_matrix_inverse(
        torch.from_numpy(bbox).double().reshape(b * o, 4))

    def weights(scale, trans):
        g = torch.linspace(-1.0, 1.0, out_side, dtype=torch.float64)
        src = (scale[:, None] * g + trans[:, None] + 1.0) * 0.5 * (hi - 1)
        j = torch.arange(hi, dtype=torch.float64)
        w = (1.0 - (src[:, :, None] - j).abs()).clamp(min=0.0)
        return w.reshape(b, o, out_side, hi), float(src.abs().max())

    wy, sy = weights(theta[:, 1, 1], theta[:, 1, 2])
    wx, sx = weights(theta[:, 0, 0], theta[:, 0, 2])
    out = torch.einsum("boip,bocpq,bojq->bijc", wy,
                       torch.from_numpy(feats).double(), wx)
    return out.numpy(), max(sy, sx)


@pytest.mark.parametrize("in_side, out_side, tile", [(64, 64, 1),
                                                     (30, 32, 4)],
                         ids=["G2-64-onto-64", "D2-30-onto-32"])
def test_plain_place_at_stage2_sides_matches_pallas_interpret(
        interpret_mode, in_side, out_side, tile):
    """K1's plain version at G2's and D2's place sides, (2, 3, 8) maps,
    against stn_place_multi_pallas in interpret mode and both against the
    place in float64; K1's channel tile at those sides.

    The tolerance is PLACE_ULPS float32 ulps of the largest source
    coordinate (one ulp of 186 is 1.5e-5 at these 64x64 boxes): each float32
    way rounds the hat weights' source coordinates on its own, and at
    these sides both sit up to 4.2e-5 from float64, past the 1e-5 of
    tests/test_torch_port_stn.py, whose 16x16 sources are smaller."""
    rng = np.random.RandomState(in_side)
    feats = rng.uniform(-1, 1, (2, 3, 8, in_side, in_side)).astype(
        np.float32)
    bbox = stage2_inputs(10)["bbox_s2"]
    want = np.asarray(sp.stn_place_multi_pallas(
        jnp.asarray(np.transpose(feats, (0, 1, 3, 4, 2))), jnp.asarray(bbox),
        (out_side, out_side)))
    got = stn_place_multi_plain(torch.from_numpy(feats),
                                torch.from_numpy(bbox), (out_side, out_side))
    assert got.shape == (2, 8, out_side, out_side)
    exact, max_src = _place_float64(feats, bbox, out_side)
    atol = PLACE_ULPS * float(np.spacing(np.float32(max_src)))
    got = got.permute(0, 2, 3, 1)
    _close(got, want, "place against Pallas", atol=atol)
    _close(got, exact, "place against float64", atol=atol)
    _close(want, exact, "Pallas against float64", atol=atol)
    assert float(np.abs(want).max()) > 0.1
    assert place_tile((in_side, in_side), (out_side, out_side)) == tile
