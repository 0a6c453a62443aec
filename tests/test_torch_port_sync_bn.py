"""The port's BatchNorm under a process group (``nn/blocks.py``: sync-BN
over the global batch, and ``groups`` over the ranks) and ``--bn_groups``
for coco-attngan and damsm, on the CPU. The two-process checks start two
ranks over gloo once for the file (``tools/dist_steps.py:spawn``, the cases
of tests/torch_port_dist_cases.py); the rest run in this process.

* Sync-BN at unequal local counts (5 rows on rank 0, 3 on rank 1), in
  float64, two train-mode steps: a BatchNorm2d equals one
  ``torch.nn.BatchNorm2d`` over the concatenation, and an object-pathway
  BatchNorm2d equals the reference's loop of one BatchNorm2d over each
  object in turn: outputs, input gradients, the weight gradient summed
  over the ranks and the running statistics of both ranks, atol 1e-12.
* ``--bn_groups 2`` at world 2 (one group a rank) equals JAX's
  ``BN_GROUPS = 2`` at world 1 (set with monkeypatch): the mnist step at
  GF 16 / DF 8 on a global batch of 8, at tests/test_step_parity.py's
  criteria (losses atol 1e-3, running statistics atol 5e-4, Adam-delta
  cosine > 0.999, mean |difference| < 0.02 lr, at most 0.5 % flips), the
  running statistics of both ranks rank 0's group's, bit for bit. Both
  Adams start warm (tests/test_torch_port_stage2_step.py:_warm_adam): at 4
  rows a group, JAX's E[x^2] - E[x]^2 variance and the port's two-pass one
  part by more than float32 noise, and a fresh Adam's lr * sign(g) step
  turns that into flips (worst delta cosine 0.99896 read at GF 16, the
  same at world 1 as at world 2).
* coco-attngan at ``bn_groups`` 2 equals the JAX step under
  ``BN_GROUPS = 2`` at tests/test_torch_port_attngan_step.py's
  tolerances (statistics 5e-4, EMA 1e-7); its losses and Adam deltas are
  held at that file's criteria (losses atol 1e-4 + rtol 1e-5) against the
  same step in float64, and JAX's at rtol 1e-4 and delta cosine > 0.99 of
  it (groups of 2 rows, where JAX's float32 variance loses digits: ROADMAP
  "The JAX float32 BatchNorm");
  ``attngan_model_config`` threads the flag into every BatchNorm of G and
  the Ds.
* damsm with ``--bn_groups 2`` equals ``--bn_groups 1`` bit for bit (its
  backbone runs in eval mode, its text encoder has no BatchNorm), and
  ``run_flags.json`` records the 2.
* ``--bn_groups`` exits only where the JAX package fails too (groups or a
  world size that do not divide the global batch), with the numbers.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dist_cases as cases
from multiple_objects_gan_tpu.nn import blocks as jblocks
from multiple_objects_gan_tpu.train.attngan_step import (
    make_attngan_train_step as jmake_attngan_train_step)
from multiple_objects_gan_tpu_torch.cli import damsm_runner
from multiple_objects_gan_tpu_torch.cli import main as port_main
from multiple_objects_gan_tpu_torch.config.config import (
    attngan_model_config, cfg_from_file)
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.io.weights import (
    attngan_g_state_dict_from_jax)
from multiple_objects_gan_tpu_torch.nn import blocks
from multiple_objects_gan_tpu_torch.tools import dist_steps
from multiple_objects_gan_tpu_torch.train.attngan_step import (
    make_attngan_train_step)
from test_torch_port_attngan_step import (
    EMA_ATOL, LOSS_ATOL, LOSS_RTOL, SCALES, STATS_ATOL, JTinyImageEncoder,
    _compare_deltas, _highest_precision, _snapshot,
    _stats_close, _want_sds, jax_side, make_batch, port_batch, port_state,
    replay_noise, warm_adam, warm_jax_adam)
from test_torch_port_attngan_step import JCFG as ATTN_JCFG
from test_torch_port_attngan_step import PCFG as ATTN_PCFG
from test_torch_port_attngan_step import SMOOTH as ATTN_SMOOTH
from test_torch_port_damsm_entry import tiny_cfg as damsm_cfg
from test_torch_port_multihost import PCFG, TESTS, WORKER_ENV
from test_torch_port_step import _compare_deltas as _compare_mnist_deltas
from test_torch_port_step import _compare_stats

__all__ = ["_highest_precision"]     # its autouse fixture applies here

LR = 2e-4
COUNTS = (5, 3)
BN_ATOL = 1e-12
GROUPS_RTOL = 1e-4          # JAX's AttnGAN losses at 2 rows a group
GROUPS_JAX_COSINE = 0.99    # JAX's AttnGAN updates at 2 rows a group


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' sync-BN runs and the mnist step at bn_groups 2 (one
    spawn), and the JAX step under BN_GROUPS = 2."""
    from test_torch_port_multihost import _mnist
    tmp = tmp_path_factory.mktemp("sync_bn")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jblocks, "BN_GROUPS", 2)
        case, want = _mnist(warm=True)
    case.update(name="groups", config=dataclasses.replace(PCFG, bn_groups=2))
    from multiple_objects_gan_tpu_torch.nn.blocks import set_bn_groups
    for m in (case["state"].g, case["state"].d):
        set_bn_groups(m, 2)
    path = str(tmp / "cases.pth")
    torch.save([{"name": "bn", "call": "torch_port_dist_cases:sync_bn_rank",
                 "kwargs": {"counts": COUNTS}}, case], path)
    ranks = dist_steps.spawn(path, str(tmp / "out"), world=2, device="cpu",
                             timeout=300, extra_path=(TESTS,),
                             env={**os.environ, **WORKER_ENV})
    return {"ranks": ranks, "jax": want,
            "pre_g": {k: v.clone()
                      for k, v in case["state"].g.state_dict().items()},
            "pre_d": {k: v.clone()
                      for k, v in case["state"].d.state_dict().items()}}


def _reference_bn(counts):
    """One torch.nn.BatchNorm2d over the concatenation, and the reference's
    loop over objects, in float64, as sync_bn_rank draws them."""
    inp = cases.bn_input(counts)
    torch.manual_seed(0)
    plain = torch.nn.BatchNorm2d(4).double().train()
    obj = torch.nn.BatchNorm2d(4).double().train()
    with torch.no_grad():
        for m in (plain, obj):
            m.weight.uniform_(0.5, 1.5)
            m.bias.normal_()

    class Loop(torch.nn.Module):
        """The reference's object loop: one BatchNorm over each object."""

        def __init__(self, bn):
            super().__init__()
            self.bn = bn
            self.weight = bn.weight
            self.running_mean = bn.running_mean
            self.running_var = bn.running_var

        def forward(self, x):
            xo = x.view(-1, 3, *x.shape[1:])
            return torch.stack([self.bn(xo[:, o]) for o in range(3)],
                               1).view(x.shape)

    return {"plain": cases._bn_run(inp["x"], inp["w"], plain),
            "object": cases._bn_run(inp["xo"], inp["wo"], Loop(obj))}


@pytest.mark.parametrize("kind", ["plain", "object"])
def test_sync_bn_at_unequal_counts_equals_one_batchnorm(run, kind):
    want = _reference_bn(COUNTS)[kind]
    lo = 0
    w_grad = 0
    for r, n in enumerate(COUNTS):
        got = run["ranks"][r]["results"]["bn"]["value"][kind]
        scale = 3 if kind == "object" else 1
        rows = slice(scale * lo, scale * (lo + n))
        for k in ("y", "x_grad"):
            np.testing.assert_allclose(got[k].numpy(), want[k][rows].numpy(),
                                       atol=BN_ATOL, err_msg=f"{r} {k}")
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=BN_ATOL, err_msg=f"{r} {k}")
        w_grad = w_grad + got["w_grad"]
        lo += n
    np.testing.assert_allclose(w_grad.numpy(), want["w_grad"].numpy(),
                               atol=BN_ATOL)


def test_two_groups_over_two_ranks_match_jax_bn_groups_2(run):
    want = run["jax"]
    for r in (0, 1):
        got = run["ranks"][r]["results"]["groups"]
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, atol=1e-3,
                                       err_msg=f"rank {r} loss {k}")
        post = got["state"]
        _compare_stats(post["g"], want["g"], f"rank {r} g_stats")
        _compare_stats(post["d"], want["d"], f"rank {r} d_stats")
        _compare_mnist_deltas(run["pre_g"], post["g"], want["g"],
                              f"rank {r} G")
        _compare_mnist_deltas(run["pre_d"], post["d"], want["d"],
                              f"rank {r} D")
    s0 = run["ranks"][0]["results"]["groups"]["state"]
    s1 = run["ranks"][1]["results"]["groups"]["state"]
    for part in ("g", "d"):
        for k, v in s0[part].items():
            assert torch.equal(v, s1[part][k]), (part, k)


def _attngan_step(batch, z, eps, enc, double=False):
    """The port's AttnGAN step at bn_groups 2 from the weights and warm
    Adams of tests/test_torch_port_attngan_step.py, in float32 or, with
    ``double``, in float64: (state, losses, state dicts before it)."""
    state = port_state(3)
    for m in (state.g, *state.ds.values()):
        blocks.set_bn_groups(m, 2)
    warm_adam(state)
    image = cases.PoolImageEncoder(16)
    batch = port_batch(batch)
    if double:
        for m in (state.g, *state.ds.values(), enc, image):
            m.double()
        for opt in (state.g_opt, *state.d_opts.values()):
            opt.load_state_dict(opt.state_dict())
        state.g_ema = {k: v.double() for k, v in state.g_ema.items()}
        batch = {k: v.double() / 127.5 - 1.0 if k.startswith("image")
                 else v.double() if v.is_floating_point() else v
                 for k, v in batch.items()}
        z, eps = z.double(), eps.double()
    pre = {"g": _snapshot(state.g),
           **{n: _snapshot(d) for n, d in state.ds.items()}}
    got = make_attngan_train_step(
        dataclasses.replace(ATTN_PCFG, bn_groups=2), enc, image,
        smooth=ATTN_SMOOTH)(state, batch, None, LR, LR, z=z, eps=eps)
    return state, {k: float(v) for k, v in got.items()}, pre


def _float_sd(module) -> dict:
    return {k: v.float() if v.is_floating_point() else v
            for k, v in module.state_dict().items()}


def test_attngan_bn_groups_2_matches_jax(monkeypatch):
    """One AttnGAN step at bn_groups 2 (groups of 2 rows) against the JAX
    step under BN_GROUPS = 2 and against the same step in float64. Against
    JAX: running statistics and the EMA at the AttnGAN step test's
    criteria, the losses at GROUPS_RTOL and the Adam deltas at cosine >
    GROUPS_JAX_COSINE; against float64: the losses at LOSS_ATOL +
    LOSS_RTOL and the deltas at the step test's criteria, and JAX farther
    from it than the port. JAX's E[x^2] - E[x]^2 variance over 2 rows
    loses digits: g_loss_total 0.043 off of 751.86 (the port 3.1e-4), and
    the update of d256's img_code_s64.1.weight at cosine 0.9952 with the
    float64 one (the port's 1.0)."""
    monkeypatch.setattr(jblocks, "BN_GROUPS", 2)
    jstate, (jg, jds, jenc), enc_vars, enc = jax_side(port_state(3), 3)
    jstate = warm_jax_adam(jstate)
    batch = make_batch(11)
    rng = jax.random.PRNGKey(42)
    new_jstate, metrics = jax.jit(jmake_attngan_train_step(
        ATTN_JCFG, jg, jds, jenc, JTinyImageEncoder(), smooth=ATTN_SMOOTH))(
        jstate, enc_vars, jax.tree.map(jnp.asarray, batch), rng,
        jnp.float32(LR), jnp.float32(LR))
    z, eps = replay_noise(rng)
    state, got, pre = _attngan_step(batch, z, eps, copy.deepcopy(enc))
    state64, exact, _ = _attngan_step(batch, z, eps, copy.deepcopy(enc),
                                      double=True)
    assert sorted(got) == sorted(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(got[k], exact[k], atol=LOSS_ATOL,
                                   rtol=LOSS_RTOL, err_msg=f"loss {k}")
        np.testing.assert_allclose(float(v), exact[k], atol=LOSS_ATOL,
                                   rtol=GROUPS_RTOL, err_msg=f"jax {k}")
    assert (abs(float(metrics["g_loss_total"]) - exact["g_loss_total"])
            > abs(got["g_loss_total"] - exact["g_loss_total"]))
    want_g, want_ds = _want_sds(new_jstate)
    assert sorted(SCALES) == sorted(state.ds)
    for n, m, m64, want in [("g", state.g, state64.g, want_g)] + [
            (n, state.ds[n], state64.ds[n], want_ds[n]) for n in SCALES]:
        _stats_close(m.state_dict(), want, f"{n}_stats", atol=STATS_ATOL)
        exact_sd = _float_sd(m64)
        _compare_deltas(pre[n], m.state_dict(), exact_sd, n)
        for k, v in want.items():
            if k.endswith(("running_mean", "running_var",
                           "num_batches_tracked")):
                continue
            dj = (v - pre[n][k]).double().flatten()
            de = (exact_sd[k] - pre[n][k]).double().flatten()
            if float(de.norm()) > 0:
                cos = float(dj @ de / (dj.norm() * de.norm()))
                assert cos > GROUPS_JAX_COSINE, f"jax {n}:{k} {cos}"
    want_ema = attngan_g_state_dict_from_jax(new_jstate.g_ema,
                                             new_jstate.g_stats, 3, 1)
    for k, v in state.g_ema.items():
        np.testing.assert_allclose(v.numpy(), want_ema[k].numpy(),
                                   atol=EMA_ATOL, err_msg=f"ema {k}")


def test_attngan_model_config_threads_bn_groups_into_every_batchnorm():
    from multiple_objects_gan_tpu_torch.models.attngan import (
        build_attngan_d, build_attngan_g)
    cfg = attngan_model_config(cfg_from_file(cases.ATTN_TRAIN,
                                             "coco-attngan"), bn_groups=2)
    assert cfg.bn_groups == 2
    small = dataclasses.replace(cfg, gf_dim=4, df_dim=4, r_num=1)
    for m in (build_attngan_g(small, device="cpu"),
              *(build_attngan_d(small, s, device="cpu")
                for s in (64, 128, 256))):
        bns = [b for b in m.modules() if isinstance(b, blocks.BatchNorm2d)
               or isinstance(b, blocks.BatchNorm1d)]
        assert bns and all(b.groups == 2 for b in bns)


@pytest.fixture
def _head_image_encoder(monkeypatch):
    def build(nef=256, state_dict=None, *, seed=0, compute_dtype=None,
              device="cuda"):
        torch.manual_seed(seed)
        return cases.HeadImageEncoder(nef).to(device).eval().requires_grad_(
            False)

    monkeypatch.setattr(damsm_runner, "build_image_encoder", build)
    monkeypatch.delenv(damsm_runner.BACKBONE_ENV, raising=False)


def test_damsm_bn_groups_2_equals_1_bit_for_bit(tmp_path,
                                                _head_image_encoder):
    cfg, data = damsm_cfg(tmp_path), str(tmp_path / "data")
    runs = {}
    for g in (1, 2):
        out = str(tmp_path / f"g{g}")
        port_main.main(["--variant", "damsm", "--cfg", cfg, "--data_dir",
                        data, "--img_dir", data + "_imgs", "--output_dir",
                        out, "--synthetic", "--manualSeed", "3", "--device",
                        "cpu", "--max_epochs", "1", "--bn_groups", str(g)])
        with open(os.path.join(out, "run_flags.json")) as f:
            assert json.load(f)["bn_groups"] == g
        runs[g] = CheckpointManager(os.path.join(out, "models")).load(0)[0]
    for part in ("text", "image"):
        for k, v in runs[1][part].items():
            assert torch.equal(runs[2][part][k], v), (part, k)
    assert runs[1]["step"] == runs[2]["step"] > 0


def test_groups_that_the_world_does_not_divide_exit(monkeypatch):
    """``--bn_groups`` exits only where the JAX package fails too: groups
    or a world size that do not divide the global batch. Groups that the
    world size does not divide run, a group spanning ranks
    (tests/test_torch_port_bn_span.py); an object pathway refuses groups
    that do not divide its global batch before any collective."""
    monkeypatch.setattr(port_main, "world_size", lambda: 2)
    with pytest.raises(SystemExit, match="--bn_groups 3 over 2 processes "
                       "at global batch 128"):
        port_main.check_bn_groups(3, 128)
    with pytest.raises(SystemExit, match="--bn_groups 4 over 2 processes "
                       "at global batch 6"):
        port_main.check_bn_groups(4, 6)
    with pytest.raises(SystemExit, match="--bn_groups 3 over 2 processes "
                       "at global batch 9"):
        port_main.check_bn_groups(3, 9)
    for groups, batch in ((3, 96), (3, 12), (4, 128), (2, 8), (1, 7)):
        port_main.check_bn_groups(groups, batch)
    monkeypatch.setattr(blocks, "world_size", lambda: 2)
    with pytest.raises(ValueError, match=r"3 BatchNorm groups must divide "
                       r"the object-pathway batch \(8\)"):
        blocks.ObjectBatchNorm2d(4, 3, groups=3).train()(
            torch.randn(12, 4, 2, 2))
