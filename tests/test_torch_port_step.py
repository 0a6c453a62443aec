"""The port's Stage-1 training (multiple_objects_gan_tpu_torch: losses, the
alternating train step, the epoch loop, synthetic data, the cfg reader and
the train CLI) against the JAX package, on the CPU.

The one-step test runs the port's step and one jitted JAX
``make_train_step`` from the same weights, drawn as
tests/test_step_parity.py draws them and carried into the JAX package by
its importers, the same batch and the same z (the JAX step's internal
draw, replayed as that file does), at gf_dim and df_dim 8 and batch 4.
It holds them with that file's criteria: losses atol 1e-3; BatchNorm
running statistics atol 5e-4; per tensor, Adam-delta cosine > 0.999, mean
|delta difference| < 0.02 lr and at most 0.5 % of the elements flipped by
more than 0.5 lr. A first Adam step is about lr * sign(grad), so an element
whose gradient is near zero flips sign under float32 noise; how many there
are depends on the weights (see PERF.md). The loss functions are
held at atol 1e-6: the same float32 formula on both sides.

The card-vs-CPU step check of chip_smoke.py (phase 8) is rehearsed here
on two CPU steps: it passes the same step run on one thread and on two,
and fails a step whose place backward is wrong (the graph cut, the
gradient mirrored, x and y swapped), from the reference init and from the
weights above.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from multiple_objects_gan_tpu.data.datasets import (
    MultiMnistDataset, write_synthetic_multimnist)
from multiple_objects_gan_tpu.data.synthetic import (
    synthetic_batch as jsynthetic_batch)
from multiple_objects_gan_tpu.io.torch_import import (
    import_stage1_d, import_stage1_g)
from multiple_objects_gan_tpu.losses import gan as jgan
from multiple_objects_gan_tpu.models import common as jcommon
from multiple_objects_gan_tpu.models.stage1 import (
    Stage1D as JStage1D, Stage1G as JStage1G)
from multiple_objects_gan_tpu.train.step import (
    create_state as jcreate_state, make_train_step as jmake_train_step)
from multiple_objects_gan_tpu.utils.images import (
    as_model_image as jas_model_image)
import chip_smoke
from multiple_objects_gan_tpu_torch.cli import main as port_main
from multiple_objects_gan_tpu_torch.config.config import (
    cfg_from_file, parse_yaml)
from multiple_objects_gan_tpu_torch.data.synthetic import (
    synthetic_batch, synthetic_multimnist)
from multiple_objects_gan_tpu_torch.io.weights import (
    stage1_d_state_dict_from_jax, stage1_g_state_dict_from_jax)
from multiple_objects_gan_tpu_torch.losses import gan
from multiple_objects_gan_tpu_torch.models import common
from multiple_objects_gan_tpu_torch.ops import stn_place_cuda
from multiple_objects_gan_tpu_torch.train.loop import run_epochs
from multiple_objects_gan_tpu_torch.train.state import create_state
from multiple_objects_gan_tpu_torch.train.step import make_train_step
from multiple_objects_gan_tpu_torch.utils.images import as_model_image
from test_step_parity import _layout_batch, _replay_step_noise
from test_torch_parity import _randomize

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
JCFG = dataclasses.replace(jcommon.MNIST, gf_dim=8, df_dim=8)
PCFG = dataclasses.replace(common.MNIST, gf_dim=8, df_dim=8)
LR = 2e-4
B = 4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ losses


def _logits(seed, n):
    return np.random.RandomState(seed).randn(n).astype(np.float32) * 3


@pytest.mark.parametrize("uncond", [False, True], ids=["cond", "uncond"])
def test_discriminator_loss_matches_jax(uncond):
    real, wrong, fake, ur, uf = (_logits(i, 5 if i != 1 else 4)
                                 for i in range(5))
    jargs = [jnp.asarray(a) for a in (real, wrong, fake)]
    targs = [torch.from_numpy(a) for a in (real, wrong, fake)]
    if uncond:
        jargs += [jnp.asarray(ur), jnp.asarray(uf)]
        targs += [torch.from_numpy(ur), torch.from_numpy(uf)]
    want, want_parts = jgan.discriminator_loss(*jargs)
    got, got_parts = gan.discriminator_loss(*targs)
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    assert sorted(got_parts) == sorted(want_parts)
    for k in want_parts:
        np.testing.assert_allclose(float(got_parts[k]), float(want_parts[k]),
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("uncond", [False, True], ids=["cond", "uncond"])
def test_generator_loss_matches_jax(uncond):
    fake, uf = _logits(5, 6), _logits(6, 6)
    want = jgan.generator_adv_loss(jnp.asarray(fake),
                                   jnp.asarray(uf) if uncond else None)
    got = gan.generator_adv_loss(torch.from_numpy(fake),
                                 torch.from_numpy(uf) if uncond else None)
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)


def test_kl_and_bce_match_jax():
    rng = np.random.RandomState(7)
    mu, logvar = rng.randn(2, 4, 8).astype(np.float32)
    np.testing.assert_allclose(
        float(gan.kl_loss(torch.from_numpy(mu), torch.from_numpy(logvar))),
        float(jgan.kl_loss(jnp.asarray(mu), jnp.asarray(logvar))), atol=1e-6)
    x = _logits(8, 9) * 10          # large logits: the stable form matters
    for t in (0.0, 1.0):
        np.testing.assert_allclose(
            float(gan.bce_with_logits(torch.from_numpy(x), t)),
            float(jgan.bce_with_logits(jnp.asarray(x),
                                       jnp.full(x.shape, t))), atol=1e-6)


# --------------------------------------------------------------- the step


def _port_state(jstate):
    """The port's state from a JAX state's weights."""
    return create_state(
        PCFG, device="cpu",
        g_state_dict=stage1_g_state_dict_from_jax(jstate.g_params,
                                                  jstate.g_stats, PCFG),
        d_state_dict=stage1_d_state_dict_from_jax(jstate.d_params,
                                                  jstate.d_stats))


def _randomized_states():
    """The port's state with the weights tests/test_step_parity.py draws
    (test_torch_parity._randomize: every parameter N(0, 0.05), BatchNorm
    away from its init), and a JAX state holding the same weights through
    the JAX package's importers."""
    state = create_state(PCFG, device="cpu")
    _randomize(state.g, seed=3)
    _randomize(state.d, seed=11)
    sd_g = {k: v.numpy().copy() for k, v in state.g.state_dict().items()}
    sd_d = {k: v.numpy().copy() for k, v in state.d.state_dict().items()}
    g_params, g_stats = import_stage1_g({"netG": sd_g}, JCFG)
    d_params, d_stats = import_stage1_d(sd_d, JCFG)
    jg, jd = JStage1G(JCFG), JStage1D(JCFG)
    jstate = jcreate_state(JCFG, jg, jd, jax.random.PRNGKey(0), batch_size=2)
    jstate = jstate.replace(g_params=g_params, g_stats=g_stats,
                            d_params=d_params, d_stats=d_stats)
    return state, jstate, jg, jd


def _batch():
    bbox, onehot, rs = _layout_batch(B, 3, 10, seed=7)
    image_u8 = rs.randint(0, 256, (B, 64, 64, 1)).astype(np.uint8)
    return {"image": image_u8, "bbox": bbox, "label_onehot": onehot}


def _port_step(state, batch, z):
    pre_g = {k: v.clone() for k, v in state.g.state_dict().items()}
    pre_d = {k: v.clone() for k, v in state.d.state_dict().items()}
    metrics = make_train_step(PCFG)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, None, LR,
        LR, z=torch.from_numpy(z))
    return metrics, pre_g, pre_d


def _compared(key):
    """Keys both sides hold: the reference's unused ``label`` module
    (model.py:137-140) has no JAX counterpart."""
    return not key.startswith("label.")


def _is_param(key):
    return _compared(key) and not key.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))


def _compare_deltas(pre, post_port, post_jax, what, lr=LR):
    """tests/test_step_parity.py:_compare_deltas on state dicts."""
    for k in pre:
        if not _is_param(k):
            continue
        dp = (post_port[k] - pre[k]).numpy().ravel()
        dj = (post_jax[k] - pre[k]).numpy().ravel()
        norm = float(np.linalg.norm(dp) * np.linalg.norm(dj))
        if norm == 0.0:
            np.testing.assert_allclose(dj, dp, atol=1e-7,
                                       err_msg=f"{what}:{k}")
            continue
        cos = float(np.dot(dp, dj) / norm)
        diff = np.abs(dp - dj) / lr
        assert cos > 0.999, f"{what}:{k} delta cosine {cos}"
        assert float(diff.mean()) < 0.02, f"{what}:{k} mean delta diff"
        assert float((diff > 0.5).mean()) <= 0.005, f"{what}:{k} flips"


def _compare_stats(got, want, what):
    for k in want:
        if _compared(k) and k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=5e-4, err_msg=f"{what}:{k}")


def test_mnist_one_step_matches_jax_make_train_step():
    state, jstate, jg, jd = _randomized_states()
    batch = _batch()
    rng = jax.random.PRNGKey(42)
    step = jax.jit(jmake_train_step(JCFG, jg, jd))
    new_jstate, metrics = step(jstate, jax.tree.map(jnp.asarray, batch), rng,
                               jnp.float32(LR), jnp.float32(LR))
    z, _ = _replay_step_noise(rng, 0, B, JCFG.z_dim)

    got, pre_g, pre_d = _port_step(state, batch, np.array(z))
    assert state.step == 1
    assert sorted(got) == sorted(metrics)
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   atol=1e-3, err_msg=f"loss {k}")
    want_g = stage1_g_state_dict_from_jax(new_jstate.g_params,
                                          new_jstate.g_stats, PCFG)
    want_d = stage1_d_state_dict_from_jax(new_jstate.d_params,
                                          new_jstate.d_stats)
    post_g, post_d = state.g.state_dict(), state.d.state_dict()
    _compare_stats(post_g, want_g, "g_stats")
    _compare_stats(post_d, want_d, "d_stats")
    _compare_deltas(pre_g, post_g, want_g, "G")
    _compare_deltas(pre_d, post_d, want_d, "D")


def test_step_goes_through_the_place_four_times_each_way(monkeypatch):
    """On the card each call of the place's plain versions is a K1 or K2
    launch. A step places four times (G's object pathway; D on the real,
    the detached fake, and the fake in the G update) and takes the
    gradient of each: the D update through D(real) and D(fake.detach()),
    the G update through D(fake) and G's own pathway."""
    calls = {"place": 0, "grad": 0}
    place, grad = (stn_place_cuda.stn_place_multi_plain,
                   stn_place_cuda.stn_place_multi_grad_plain)

    def count(kind, fn):
        def wrapped(*args):
            calls[kind] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(stn_place_cuda, "stn_place_multi_plain",
                        count("place", place))
    monkeypatch.setattr(stn_place_cuda, "stn_place_multi_grad_plain",
                        count("grad", grad))
    state = create_state(PCFG, seed=3, device="cpu")
    batch = synthetic_multimnist(4, seed=1)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    metrics = make_train_step(PCFG)(state, batch, gen, LR, LR)
    assert calls == {"place": 4, "grad": 4}
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    # G's object pathway received a gradient and moved
    assert state.g.local1[1].weight.grad is not None
    assert float(state.g.local1[1].weight.grad.abs().sum()) > 0


# ------------------------------------- chip_smoke.py's card-vs-CPU step check


def _wrong_place_backward(kind):
    """A place backward gone wrong: the graph cut (F1), the gradient
    mirrored across the box, or x and y swapped."""
    plain = stn_place_cuda.stn_place_multi_grad_plain

    def wrong(grad, bbox, in_hw):
        if kind == "cut":
            return torch.zeros_like(plain(grad, bbox, in_hw))
        if kind == "mirrored":
            return plain(grad, bbox, in_hw).flip(-1)
        return plain(grad, bbox[..., [1, 0, 3, 2]], in_hw)
    return wrong


def _smoke_step(randomized, wrong=None, threads=None):
    data = synthetic_multimnist(B, seed=5)
    z = np.random.RandomState(6).randn(B, PCFG.z_dim).astype(np.float32)
    n = torch.get_num_threads()
    torch.set_num_threads(threads or n)
    try:
        if wrong is None:
            return chip_smoke.step_once("cpu", data, z, PCFG, randomized)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(stn_place_cuda, "stn_place_multi_grad_plain",
                       _wrong_place_backward(wrong))
            return chip_smoke.step_once("cpu", data, z, PCFG, randomized)
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("randomized", [False, True],
                         ids=["reference-init", "step-parity-weights"])
def test_chip_smoke_step_check_passes_a_right_step(randomized):
    """The same step on one thread and on two agrees within every limit
    of chip_smoke.py's phase 8."""
    bad, worst = chip_smoke.step_disagreements(
        _smoke_step(randomized, threads=1), _smoke_step(randomized))
    assert not bad, bad
    assert worst["grad_cosine"] > chip_smoke.MIN_GRAD_COSINE


@pytest.mark.parametrize("wrong", ["cut", "mirrored", "x-and-y-swapped"])
@pytest.mark.parametrize("randomized", [False, True],
                         ids=["reference-init", "step-parity-weights"])
def test_chip_smoke_step_check_catches_a_wrong_place_backward(randomized,
                                                              wrong):
    """Phase 8 of chip_smoke.py fails a step whose place backward (K2) is
    wrong: the object pathways' gradients leave the limits, in G and in
    D, from either set of weights."""
    bad, _ = chip_smoke.step_disagreements(
        _smoke_step(randomized, wrong=wrong), _smoke_step(randomized))
    failed = [m for m in bad if "gradient cosine" in m]
    assert any(m.startswith("G:local") for m in failed), bad
    assert any(m.startswith("D:local") for m in failed), bad


# ----------------------------------------------------------------- data


def test_synthetic_multimnist_equals_what_the_jax_writer_writes(tmp_path):
    write_synthetic_multimnist(str(tmp_path), n=24, split="train", seed=5)
    ds = MultiMnistDataset(str(tmp_path), split="train", cache=False)
    got = synthetic_multimnist(24, seed=5)
    assert got["image"].shape == (24, 64, 64, 1)
    assert got["image"].dtype == np.uint8
    for i in range(24):
        item = ds[i]
        np.testing.assert_array_equal(got["image"][i], item["image"])
        np.testing.assert_array_equal(got["bbox"][i], item["bbox"])
        np.testing.assert_array_equal(got["label_onehot"][i],
                                      item["label_onehot"])


def test_synthetic_batch_equals_jax():
    want = jsynthetic_batch(JCFG, 6, seed=2)
    got = synthetic_batch(PCFG, 6, seed=2)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_as_model_image_matches_jax(dtype):
    rng = np.random.RandomState(0)
    img = (rng.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
           if dtype == "uint8" else rng.randn(2, 8, 8, 3).astype(np.float32))
    want = np.asarray(jas_model_image(jnp.asarray(img)))
    got = as_model_image(torch.from_numpy(img))
    assert got.shape == (2, 3, 8, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-7)


# ------------------------------------------------------------ cfg reader


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    ROOT, "cfg", "*.yml"))), ids=os.path.basename)
def test_parse_yaml_reads_every_cfg_as_pyyaml_does(path):
    with open(path) as f:
        text = f.read()
    assert parse_yaml(text) == yaml.safe_load(text)


def test_parse_yaml_refuses_what_it_does_not_read():
    for bad in ("A: 1\n  B: 2\n", "A:\n  - 1\n", "A: [1, 2]\n", " A: 1\n"):
        with pytest.raises(ValueError):
            parse_yaml(bad)


def test_train_settings_of_mnist_train_yml():
    train = cfg_from_file(os.path.join(ROOT, "cfg", "mnist_train.yml"),
                          "multi-mnist").TRAIN
    assert (train.BATCH_SIZE, train.MAX_EPOCH, train.LR_DECAY_EPOCH) == (
        128, 20, 10)
    assert train.GENERATOR_LR == train.DISCRIMINATOR_LR == 2e-4


# ------------------------------------------------------------- loop, CLI


def test_run_epochs_halves_the_rates_and_shuffles_like_the_jax_loader():
    seen = []

    def step_fn(state, batch, generator, lr_g, lr_d):
        seen.append((lr_g, lr_d, batch["label_onehot"][:, 0, 0].clone()))
        return {"d_loss": torch.tensor(1.0)}

    n = 12
    data = {"image": np.zeros((n, 4, 4, 1), np.uint8),
            "bbox": np.zeros((n, 3, 4), np.float32),
            "label_onehot": np.arange(n, dtype=np.float32).reshape(
                n, 1, 1).repeat(3, 1).repeat(10, 2)}
    state = create_state(PCFG, device="cpu")
    hist = run_epochs(state, data, step_fn, None, batch_size=5, lr_g=4.0,
                      lr_d=2.0, n_epochs=3, lr_decay_epochs=2, seed=9)
    assert [h["steps"] for h in hist] == [2, 2, 2]
    assert [s[:2] for s in seen] == [(4.0, 2.0)] * 4 + [(2.0, 1.0)] * 2
    for epoch in range(3):
        order = np.arange(n)
        np.random.RandomState(9 + epoch).shuffle(order)
        got = torch.cat([s[2] for s in seen[2 * epoch:2 * epoch + 2]])
        np.testing.assert_array_equal(got.numpy(), order[:10])


def _tiny_cfg(tmp_path, batch):
    yml = tmp_path / "mnist_tiny.yml"
    yml.write_text("TRAIN:\n    FLAG: True\n    BATCH_SIZE: %d\n"
                   "    MAX_EPOCH: 5\n    LR_DECAY_EPOCH: 10\n"
                   "GAN:\n    DF_DIM: 8\n    GF_DIM: 8\n" % batch)
    return str(yml)


def test_cli_main_trains_one_synthetic_epoch_on_the_cpu(tmp_path, capsys):
    hist = port_main.main(["--variant", "multi-mnist", "--cfg",
                           _tiny_cfg(tmp_path, 128), "--synthetic",
                           "--max_epochs", "1", "--manualSeed", "3",
                           "--device", "cpu"])
    assert len(hist) == 1 and hist[0]["steps"] == 512 // 128
    for k in ("d_loss", "d_loss_real", "d_loss_wrong", "d_loss_fake",
              "g_loss"):
        assert np.isfinite(hist[0][k]) and hist[0][k] > 0, k
    out = capsys.readouterr().out
    assert "[0/1] d_loss=" in out and "steps=4" in out


def test_cli_main_refuses_without_synthetic_or_card(tmp_path, monkeypatch):
    cfg = _tiny_cfg(tmp_path, 8)
    with pytest.raises(SystemExit, match="--synthetic"):
        port_main.main(["--variant", "multi-mnist", "--cfg", cfg,
                        "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main.main(["--variant", "multi-mnist", "--cfg", cfg,
                        "--synthetic"])
