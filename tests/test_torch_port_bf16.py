"""The port's bf16 compute dtype (``Stage1Config.compute_dtype``, the CLIs'
``--bf16``) against the JAX package under ``COMPUTE_DTYPE = bfloat16``, on
the CPU, modelled on tests/test_bf16.py.

The JAX side sets its trace-time knob with ``monkeypatch`` (as
tests/test_bn_groups.py sets ``BN_GROUPS``) and jits after it; nothing of
the JAX package is edited. Both sides start from the same weights (those of
tests/test_step_parity.py, as tests/test_torch_port_step.py draws them) at
gf_dim and df_dim 8, batch 4.

Tolerances, and why:
* eval-mode G image: atol 2e-3. Each side rounds each layer's output to
  bf16 (one ulp is 2^-8 of the value) but not at the same places (the JAX
  upsample-conv sums its 3x3 kernel into a 4x4 one in bf16, XLA fuses
  elementwise work in f32), so the image carries a few ulps of [-1, 1].
* train-mode G image: atol 0.05. Batch statistics of bf16 activations over
  4 samples amplify those ulps; the JAX bf16 image itself stands 0.019
  from the JAX float32 one at these weights.
* one step: losses rtol 0.02 (tests/test_bf16.py holds bf16 against
  float32 at 0.05; port against JAX, both bf16, read 1.1e-2 at worst) and
  BatchNorm running statistics atol 5e-3 (read 2.3e-3).
* the plain bf16 K1 and K2 against JAX's bf16 ``stn_separable`` path:
  within 2 bf16 ulps of the largest |value|. The port rounds each hat
  weight to bf16 and the result once; JAX rounds also the first product
  and the object sum.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiple_objects_gan_tpu.nn import blocks as jblocks
from multiple_objects_gan_tpu.train.step import (
    make_sample_fn as jmake_sample_fn, make_train_step as jmake_train_step)
from multiple_objects_gan_tpu_torch.data.synthetic import synthetic_multimnist
from multiple_objects_gan_tpu_torch.io.weights import (
    stage1_d_state_dict_from_jax, stage1_g_state_dict_from_jax)
from multiple_objects_gan_tpu_torch.models.stage1 import build_stage1_g
from multiple_objects_gan_tpu_torch.ops import stn, stn_place_cuda
from multiple_objects_gan_tpu_torch.train.state import create_state
from multiple_objects_gan_tpu_torch.train.step import (
    make_sample_fn, make_train_step)
from test_step_parity import _replay_step_noise
from test_torch_port_step import B, JCFG, LR, PCFG, _batch, _randomized_states

# the JAX ops/stn.py module (the package's ``ops.stn`` name is a function)
jstn = importlib.import_module("multiple_objects_gan_tpu.ops.stn")
BF16 = dataclasses.replace(PCFG, compute_dtype=torch.bfloat16)
EVAL_IMAGE_ATOL = 2e-3
TRAIN_IMAGE_ATOL = 0.05
LOSS_RTOL = 0.02
STATS_ATOL = 5e-3
STN_ULPS = 2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_bf16(monkeypatch):
    """The JAX package's compute dtype set to bf16 for one test."""
    monkeypatch.setattr(jblocks, "COMPUTE_DTYPE", jnp.bfloat16)


@pytest.fixture(scope="module")
def weights():
    """(port state dicts of G and D, JAX state, JAX G and D modules)."""
    state, jstate, jg, jd = _randomized_states()
    return state.g.state_dict(), state.d.state_dict(), jstate, jg, jd


def _bf16_ulp(x: np.ndarray) -> float:
    """One bf16 ulp at the largest |x|: 2^(floor(log2 max|x|) - 7)."""
    return float(2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7))


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _layout(seed=3):
    rs = np.random.RandomState(seed)
    z = rs.randn(B, PCFG.z_dim).astype(np.float32)
    batch = _batch()
    return z, batch["bbox"], batch["label_onehot"]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bf16_stage1g_forward_matches_jax(jax_bf16, weights, train):
    sd_g, _, jstate, jg, _ = weights
    z, bbox, labels = _layout()
    out = jg.apply({"params": jstate.g_params, "batch_stats": jstate.g_stats},
                   jnp.asarray(z), jnp.asarray(bbox), jnp.asarray(labels),
                   None, train=train,
                   mutable=["batch_stats"] if train else False)
    want = (out[0] if train else out)["img"]
    assert want.dtype == jnp.bfloat16
    g = build_stage1_g(BF16, sd_g, device="cpu").train(train)
    with torch.no_grad():
        got = g(torch.from_numpy(z), torch.from_numpy(bbox),
                torch.from_numpy(labels))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(),
                               _f32(want),
                               atol=TRAIN_IMAGE_ATOL if train
                               else EVAL_IMAGE_ATOL)


def test_bf16_one_step_matches_jax(jax_bf16, weights):
    """One bf16 step, port against JAX: losses, BatchNorm running
    statistics; the state the port keeps stays float32."""
    sd_g, sd_d, jstate, jg, jd = weights
    batch = _batch()
    rng = jax.random.PRNGKey(42)
    step = jax.jit(jmake_train_step(JCFG, jg, jd))
    new_jstate, metrics = step(jstate, jax.tree.map(jnp.asarray, batch), rng,
                               jnp.float32(LR), jnp.float32(LR))
    z, _ = _replay_step_noise(rng, 0, B, JCFG.z_dim)
    state = create_state(BF16, device="cpu", g_state_dict=sd_g,
                         d_state_dict=sd_d)
    got = make_train_step(BF16)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, None, LR,
        LR, z=torch.from_numpy(np.array(z)))
    assert sorted(got) == sorted(metrics)
    for k in metrics:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   rtol=LOSS_RTOL, err_msg=f"loss {k}")
    want = {"G": stage1_g_state_dict_from_jax(new_jstate.g_params,
                                              new_jstate.g_stats, PCFG),
            "D": stage1_d_state_dict_from_jax(new_jstate.d_params,
                                              new_jstate.d_stats)}
    for net, module in (("G", state.g), ("D", state.d)):
        post = module.state_dict()
        for k, v in want[net].items():
            if k.endswith(("running_mean", "running_var")) \
                    and not k.startswith("label."):
                np.testing.assert_allclose(post[k].numpy(), v.numpy(),
                                           atol=STATS_ATOL,
                                           err_msg=f"{net}:{k}")


def test_bf16_step_keeps_weights_stats_and_adam_state_float32():
    state = create_state(BF16, seed=1, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_multimnist(4, seed=2).items()}
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        metrics = make_train_step(BF16)(state, batch, gen, LR, LR)
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v))
               for v in metrics.values())
    for module, opt in ((state.g, state.g_opt), (state.d, state.d_opt)):
        for k, v in module.state_dict().items():
            assert v.dtype in (torch.float32, torch.int64), k
        for p in module.parameters():
            assert p.dtype == torch.float32
            if p.grad is not None:
                assert p.grad.dtype == torch.float32
        moments = [t for s in opt.state.values() for t in s.values()
                   if torch.is_tensor(t) and t.dim() > 0]
        assert moments and all(t.dtype == torch.float32 for t in moments)
    # the modules compute in bf16: the G image is bf16
    with torch.no_grad():
        img = state.g(torch.zeros(4, BF16.z_dim), batch["bbox"],
                      batch["label_onehot"])
    assert img.dtype == torch.bfloat16


def test_bf16_sample_fn_returns_float32(jax_bf16, weights):
    """Sampling hands images back float32, as the JAX ``make_sample_fn``
    does (train/step.py:397-401), so PNG encoding never sees bf16."""
    sd_g, _, jstate, jg, _ = weights
    z, bbox, labels = _layout(5)
    want = jmake_sample_fn(JCFG, jg)(jstate.g_params, jstate.g_stats,
                                     jnp.asarray(z), jnp.asarray(bbox),
                                     jnp.asarray(labels), None)
    g = build_stage1_g(BF16, sd_g, device="cpu")
    got = make_sample_fn(BF16)(g, torch.from_numpy(z), torch.from_numpy(bbox),
                               torch.from_numpy(labels))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=EVAL_IMAGE_ATOL)


def _feats_and_boxes(seed, c=16, hw=(7, 7)):
    rs = np.random.RandomState(seed)
    feats = rs.randn(B, 3, hw[0], hw[1], c).astype(np.float32)
    return rs, feats, _batch()["bbox"]


@pytest.mark.parametrize("in_hw", [(7, 7), (15, 15)])
def test_bf16_plain_k1_matches_jax_bf16_place(in_hw):
    _, feats, bbox = _feats_and_boxes(6, hw=in_hw)
    jf = jnp.asarray(feats).astype(jnp.bfloat16)
    want = _f32(jstn.stn_place_multi_xla(jf, jnp.asarray(bbox), (16, 16)))
    pf = torch.from_numpy(feats).bfloat16().permute(0, 1, 4, 2, 3)
    got = stn_place_cuda.stn_place_multi_plain(
        pf.contiguous(), torch.from_numpy(bbox), (16, 16))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().permute(0, 2, 3, 1).numpy() - want).max()
    assert err <= STN_ULPS * _bf16_ulp(want), err


@pytest.mark.parametrize("in_hw", [(7, 7), (15, 15)])
def test_bf16_plain_k2_matches_jax_bf16_place_gradient(in_hw):
    rs, feats, bbox = _feats_and_boxes(7, hw=in_hw)
    g = rs.randn(B, 16, 16, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jstn.stn_place_multi_xla(
        f, jnp.asarray(bbox), (16, 16)), jnp.asarray(feats).astype(
            jnp.bfloat16))
    (want,) = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    want = _f32(want)
    got = stn_place_cuda.stn_place_multi_grad_plain(
        torch.from_numpy(g).bfloat16().permute(0, 3, 1, 2).contiguous(),
        torch.from_numpy(bbox), in_hw)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().permute(0, 1, 3, 4, 2).numpy() - want).max()
    assert err <= STN_ULPS * _bf16_ulp(want), err


def test_bf16_plain_k1_and_k2_round_once():
    """The bf16 plain versions compute on bf16-rounded hat weights in
    float32 and round once: each value within half a bf16 ulp (2^-8 of
    it) of the float64 evaluation on the same weights, plus float32 sums."""
    rs, feats, bbox = _feats_and_boxes(8)
    f = torch.from_numpy(feats).permute(0, 1, 4, 2, 3).contiguous().bfloat16()
    g = torch.from_numpy(rs.randn(B, 16, 16, 16).astype(np.float32)).bfloat16()
    box = torch.from_numpy(bbox)
    wy, wx = stn_place_cuda._weights(box, (16, 16), (7, 7), torch.bfloat16)
    assert torch.equal(wy, wy.bfloat16().float())
    wy, wx = wy.double(), wx.double()
    for got, want in (
            (stn_place_cuda.stn_place_multi_plain(f, box, (16, 16)),
             torch.einsum("bociq,bojq->bcij", torch.einsum(
                 "boip,bocpq->bociq", wy, f.double()), wx)),
            (stn_place_cuda.stn_place_multi_grad_plain(g, box, (7, 7)),
             torch.einsum("bocpj,bojq->bocpq", torch.einsum(
                 "boip,bcij->bocpj", wy, g.double()), wx))):
        assert got.dtype == torch.bfloat16
        err = (got.double() - want).abs()
        assert bool((err <= want.abs() * 2.0 ** -8 + 1e-5).all())


def test_k3_gradient_keeps_the_features_dtype():
    rs, feats, bbox = _feats_and_boxes(9)
    for dtype in (torch.bfloat16, torch.float32):
        f = torch.from_numpy(feats).permute(0, 1, 4, 2, 3).contiguous().to(
            dtype).requires_grad_(True)
        out = stn_place_cuda.stn_place_multi_nchw(f, torch.from_numpy(bbox),
                                                  (16, 16))
        assert out.dtype == dtype and out.grad_fn is not None
        (grad,) = torch.autograd.grad(out.float().square().sum(), f)
        assert grad.dtype == dtype


def test_bf16_stn_separable_and_const_place_match_jax():
    rs = np.random.RandomState(10)
    img = rs.randn(B, 9, 9, 5).astype(np.float32)
    bbox = _batch()["bbox"]
    theta = np.array(jstn.transformation_matrix_inverse(
        jnp.asarray(bbox[:, 0])))
    want = _f32(jstn.stn_separable(jnp.asarray(img).astype(jnp.bfloat16),
                                   jnp.asarray(theta), (16, 16)))
    got = stn.stn_separable(torch.from_numpy(img).bfloat16(),
                            torch.from_numpy(theta), (16, 16))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= _bf16_ulp(want)
    labels = rs.uniform(0, 1, (B, 3, 6)).astype(np.float32)
    want = _f32(jstn.stn_place_const_multi(
        jnp.asarray(labels).astype(jnp.bfloat16), jnp.asarray(bbox), (16, 16)))
    got = stn.stn_place_const_multi(torch.from_numpy(labels).bfloat16(),
                                    torch.from_numpy(bbox), (16, 16))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= _bf16_ulp(want)


# ----------------------------- chip_smoke.py's bf16 card-vs-CPU step check


def _bf16_smoke_step(wrong=None, threads=None):
    """chip_smoke.step_once for the bf16 config at gf/df 8, batch 4, from
    the weights of tests/test_step_parity.py, its place backward cut or
    mirrored when ``wrong`` says so."""
    import chip_smoke

    data = synthetic_multimnist(B, seed=5)
    z = np.random.RandomState(6).randn(B, BF16.z_dim).astype(np.float32)
    plain = stn_place_cuda.stn_place_multi_grad_plain
    n = torch.get_num_threads()
    torch.set_num_threads(threads or n)
    try:
        with pytest.MonkeyPatch.context() as mp:
            if wrong == "cut":
                mp.setattr(stn_place_cuda, "stn_place_multi_grad_plain",
                           lambda g, b, hw: torch.zeros_like(plain(g, b, hw)))
            elif wrong == "mirrored":
                mp.setattr(stn_place_cuda, "stn_place_multi_grad_plain",
                           lambda g, b, hw: plain(g, b, hw).flip(-1))
            return chip_smoke.step_once("cpu", data, z, BF16, True)
    finally:
        torch.set_num_threads(n)


def _bf16_disagreements(got, want):
    import chip_smoke

    return chip_smoke.step_disagreements(
        got, want, loss_atol=0.0, loss_rtol=chip_smoke.BF16_LOSS_RTOL,
        stats_atol=chip_smoke.BF16_STATS_ATOL,
        min_cosine=chip_smoke.BF16_MIN_GRAD_COSINE)


def test_chip_smoke_bf16_step_check():
    """Phase 13 of chip_smoke.py (the bf16 step, card against CPU), with
    its limits: it passes the same bf16 step on one thread and on two, and
    fails one whose place backward is cut or mirrored, on the object
    pathways' gradient cosines in G and in D."""
    right = _bf16_smoke_step()
    bad, _ = _bf16_disagreements(_bf16_smoke_step(threads=1), right)
    assert not bad, bad
    for wrong in ("cut", "mirrored"):
        bad, _ = _bf16_disagreements(_bf16_smoke_step(wrong), right)
        failed = [m for m in bad if "gradient cosine" in m]
        assert any(m.startswith("G:local") for m in failed), (wrong, bad)
        assert any(m.startswith("D:local") for m in failed), (wrong, bad)


# ------------------------------------------------------------- the CLIs


def test_serve_cli_bf16_serves_float32_pngs(tmp_path):
    import base64

    from multiple_objects_gan_tpu_torch.cli import serve as port_serve

    yml = tmp_path / "mnist.yml"
    yml.write_text("Z_DIM: 16\nGAN:\n    GF_DIM: 8\n")
    args = port_serve.parse_args(["--variant", "multi-mnist", "--cfg",
                                  str(yml), "--device", "cpu", "--bf16"])
    svc = port_serve.build_service(args)
    assert svc.mcfg.compute_dtype == torch.bfloat16 and svc.mcfg.ngf == 64
    assert svc.g.fc[0].compute_dtype == torch.bfloat16
    pngs = svc.run([{}, {"labels": [3], "bboxes": [[0.1, 0.1, 0.4, 0.4]]}])
    assert len(pngs) == 2
    assert base64.b64decode(pngs[0])[:8] == b"\x89PNG\r\n\x1a\n"
    assert port_serve.build_service(port_serve.parse_args(
        ["--variant", "multi-mnist", "--cfg", str(yml), "--device",
         "cpu"])).mcfg.compute_dtype is None


def test_train_cli_bf16_and_bn_groups_on_the_cpu(tmp_path, capsys):
    from multiple_objects_gan_tpu_torch.cli import main as port_main

    yml = tmp_path / "mnist_tiny.yml"
    yml.write_text("TRAIN:\n    FLAG: True\n    BATCH_SIZE: 128\n"
                   "    MAX_EPOCH: 5\n    LR_DECAY_EPOCH: 10\n"
                   "GAN:\n    DF_DIM: 8\n    GF_DIM: 8\n")
    hist = port_main.main(["--variant", "multi-mnist", "--cfg", str(yml),
                           "--synthetic", "--max_epochs", "1",
                           "--manualSeed", "3", "--device", "cpu", "--bf16",
                           "--bn_groups", "2"])
    assert len(hist) == 1 and hist[0]["steps"] == 4
    assert all(np.isfinite(hist[0][k]) for k in ("d_loss", "g_loss"))
    assert "bf16, BatchNorm groups 2" in capsys.readouterr().out
    with pytest.raises(ValueError, match="at least 1"):
        port_main.main(["--variant", "multi-mnist", "--cfg", str(yml),
                        "--synthetic", "--device", "cpu", "--bn_groups", "0"])
