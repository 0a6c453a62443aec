"""The port's COCO StackGAN stage-2 train step
(multiple_objects_gan_tpu_torch.train.step.make_stage2_train_step, with
the frozen stage-1 G) against the JAX package's ``make_stage2_train_step``,
on the CPU.

Sizes: gf 8, df 4, text and condition 16, R_NUM 2, 256px, batch 4. The
port's G1, G2 and D2 get He-scale weights (``_he_randomize``, as
tests/test_torch_port_stage1g.py:_randomize draws the model tests' JAX
trees: activations of unit scale, BatchNorm away from its init); the JAX
step gets the same through the JAX package's importers. Its z and both CA
draws are replayed from the step's rng
(``train/step.py:351-359``), as tests/test_step_parity.py:87-93 replays
z. Criteria, as tests/test_torch_port_step.py and
tests/test_torch_port_clevr.py hold the stage-1 steps: losses atol 1e-3,
BatchNorm running statistics 5e-4, per-tensor Adam deltas cosine > 0.999
(mean |difference| < 0.02 lr, at most 0.5% of the elements apart by more
than 0.5 lr). The BatchNorm statistics of D2 follow its call order (real,
fake; the conditional heads real, wrong, fake; the unconditional heads
real, fake), and matching them shows that order.

Both steps start from one warm Adam state (``_warm_adam``), where the
update is linear in the gradient. From a fresh Adam the first update is
lr * sign(g), and a near-zero gradient flips on float32 noise: D2 then
moves by 2 lr there, and the G2 gradient taken through the updated D2
carries that on. With a fresh Adam and He-scale weights the port's own
float32 and float64 steps differ by a G2 delta cosine of 0.875 (a
16-element BatchNorm tensor with one flip). At the N(0, 0.05) weights of
tests/test_step_parity.py, whose activations are small, float32 noise
alone moves the G2 deltas even from the warm state: the port's float32
and float64 steps differ by cosines down to 0.9974, JAX's float32 step
alike. At the weights here the port's float32 deltas sit at cosines of
0.99989 or more from its float64 ones, JAX's at 0.99986 or more.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiple_objects_gan_tpu.io import torch_import as ti
from multiple_objects_gan_tpu.models import common as jcommon
from multiple_objects_gan_tpu.models.stage1 import Stage1G as JStage1G
from multiple_objects_gan_tpu.models.stage2 import (
    COCO_S2 as JCOCO_S2, Stage2D as JStage2D, Stage2G as JStage2G)
from multiple_objects_gan_tpu.train.step import (
    create_state_stage2 as jcreate_state2,
    make_stage2_train_step as jmake_stage2_train_step)
from multiple_objects_gan_tpu_torch.data.synthetic import (
    synthetic_coco_stage2)
from multiple_objects_gan_tpu_torch.io.weights import (
    stage2_d_state_dict_from_jax, stage2_g_state_dict_from_jax)
from multiple_objects_gan_tpu_torch.models import common
from multiple_objects_gan_tpu_torch.models.stage1 import build_stage1_g
from multiple_objects_gan_tpu_torch.train.state import create_state_stage2
from multiple_objects_gan_tpu_torch.train.step import (
    frozen_forward, make_stage2_train_step)
from test_torch_port_clevr import _compare_deltas, _stats_close

LR = 2e-4
B = 4
R_NUM = 2
KL_COEFF = 2.0      # cfg/coco_s2_train.yml TRAIN.COEFF.KL
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


def stage2_batch(seed: int, b: int = B) -> dict:
    """b items of the synthetic stage-2 set at 256px (uint8 images, 1-3
    objects), each with one 16-d caption embedding, and stage-2 boxes
    moved off the stage-1 ones, so that a step that mixes them up fails."""
    data = synthetic_coco_stage2(b, seed=seed, text_dim=16)
    data["text_embedding"] = data["text_embedding"][:, 0].copy()
    real = data["bbox"][:, :, 0] >= 0
    data["bbox_s2"][real] += np.float32([0.05, -0.03, 0.02, 0.04])
    return data


def _noise(rng, b):
    """The z, eps1 and eps2 the JAX step draws (fold_in(rng, 0), split
    in 3)."""
    r = jax.random.fold_in(rng, 0)
    rng_z, rng_ca1, rng_ca2 = jax.random.split(r, 3)
    return [torch.from_numpy(np.array(jax.random.normal(k, (b, d),
                                                        jnp.float32)))
            for k, d in ((rng_z, JS1.z_dim), (rng_ca1, JS1.condition_dim),
                         (rng_ca2, JS2.condition_dim))]


def _he_randomize(module, seed):
    """Every conv and linear weight N(0, 2 / fan_in), biases N(0, 0.1),
    BatchNorm weights U(0.5, 1.5) and running statistics away from their
    init, drawn on the CPU from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
                m.running_mean.copy_(
                    0.2 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(
                    0.5 + torch.rand(m.running_var.shape, generator=g))
            elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * (2.0 / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    return module


def _states(seed_g1, seed_g, seed_d):
    """The port's G1 and stage-2 state with He-scale weights, and the
    JAX stage-1 variables and stage-2 state holding the same weights,
    imported by the JAX package from the port's reference-format keys
    (the STAGE2_G with its ``STAGE1_G.`` part)."""
    g1 = _he_randomize(build_stage1_g(PS1, seed=0, device="cpu"), seed_g1)
    state = create_state_stage2(PS2, seed=0, device="cpu")
    _he_randomize(state.g, seed_g)
    _he_randomize(state.d, seed_d)

    def numpy(m, prefix=""):
        return {prefix + k: v.numpy().copy()
                for k, v in m.state_dict().items()}

    s1, (g_params, g_stats) = ti.import_stage2_g(
        {"netG": {**numpy(g1, "STAGE1_G."), **numpy(state.g)}}, JS1, JS2,
        r_num=R_NUM)
    d_params, d_stats = ti.import_stage2_d(numpy(state.d))
    jg2, jd2 = JStage2G(JS2, r_num=R_NUM), JStage2D(JS2)
    jstate = jcreate_state2(JS2, jg2, jd2, jax.random.PRNGKey(0),
                            batch_size=2).replace(
        g_params=g_params, g_stats=g_stats, d_params=d_params,
        d_stats=d_stats)
    s1_vars = {"params": s1[0], "batch_stats": s1[1]}
    return g1, state, s1_vars, jstate, (jg2, jd2)


ADAM_COUNT = 10     # the warm Adam state both steps start from


def _warm_adam(state, jstate):
    """Both sides' Adams at count ADAM_COUNT with first moments 0 and
    second moments 1 (torch's ``step``/``exp_avg``/``exp_avg_sq``, optax's
    ``count``/``mu``/``nu``): the step's update is then about
    lr * g / 2 (1 - 0.5^11 and 1 - 0.999^11 bias corrections), linear in
    the gradient, where a fresh Adam's first update is lr * sign(g)."""
    for opt in (state.g_opt, state.d_opt):
        for group in opt.param_groups:
            for p in group["params"]:
                opt.state[p] = {"step": torch.tensor(float(ADAM_COUNT)),
                                "exp_avg": torch.zeros_like(p),
                                "exp_avg_sq": torch.ones_like(p)}

    def warm(opt_state):
        return opt_state._replace(
            count=jnp.full_like(opt_state.count, ADAM_COUNT),
            mu=jax.tree.map(jnp.zeros_like, opt_state.mu),
            nu=jax.tree.map(jnp.ones_like, opt_state.nu))

    return jstate.replace(g_opt=warm(jstate.g_opt), d_opt=warm(jstate.d_opt))


def _snapshot(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def test_one_stage2_step_matches_jax_make_stage2_train_step():
    """Losses (kl_loss among them, only in the G loss), G2's and D2's
    running statistics and Adam deltas against one jitted JAX stage-2
    step; the frozen G1 bit-identical after it, without gradients."""
    g1, state, s1_vars, jstate, (jg2, jd2) = _states(5, 3, 11)
    jstate = _warm_adam(state, jstate)
    batch = stage2_batch(21)
    rng = jax.random.PRNGKey(42)
    step = jax.jit(jmake_stage2_train_step(JS2, JS1, JStage1G(JS1), jg2, jd2,
                                           kl_coeff=KL_COEFF))
    new_jstate, metrics = step(jstate, s1_vars,
                               jax.tree.map(jnp.asarray, batch), rng,
                               jnp.float32(LR), jnp.float32(LR))
    z, eps1, eps2 = _noise(rng, B)
    pre_g, pre_d, pre_g1 = (_snapshot(state.g), _snapshot(state.d),
                            _snapshot(g1))
    got = make_stage2_train_step(PS2, PS1, g1, KL_COEFF)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, None, LR,
        LR, z=z, eps1=eps1, eps2=eps2)
    assert sorted(got) == sorted(metrics)
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   atol=1e-3, err_msg=f"loss {k}")
    np.testing.assert_allclose(
        float(got["g_loss_total"]),
        float(got["g_loss"]) + KL_COEFF * float(got["kl_loss"]), rtol=1e-6)
    assert float(got["kl_loss"]) > 0
    want_g = stage2_g_state_dict_from_jax(new_jstate.g_params,
                                          new_jstate.g_stats, R_NUM)
    want_d = stage2_d_state_dict_from_jax(new_jstate.d_params,
                                          new_jstate.d_stats)
    post_g, post_d = state.g.state_dict(), state.d.state_dict()
    _stats_close(post_g, want_g, "g_stats", atol=5e-4)
    _stats_close(post_d, want_d, "d_stats", atol=5e-4)
    _compare_deltas(pre_g, post_g, want_g, "G2")
    _compare_deltas(pre_d, post_d, want_d, "D2")
    assert state.step == 1
    assert all(float(st["step"]) == ADAM_COUNT + 1
               for st in state.g_opt.state.values())
    # the frozen G1: every parameter and buffer bit for bit, no gradient
    after = g1.state_dict()
    for k, v in pre_g1.items():
        assert torch.equal(after[k], v), k
    assert all(p.grad is None for p in g1.parameters())
    assert not g1.training


def test_step_draws_z_eps1_eps2_from_its_generator_in_order():
    """Without injected noise the step draws z, G1's eps and G2's eps from
    the caller's generator, in that order: the same step with those draws
    passed in gives the same losses and weights."""
    batch = {k: torch.from_numpy(v) for k, v in stage2_batch(22).items()}
    results = []
    for inject in (False, True):
        g1, state, *_ = _states(6, 4, 12)
        gen = torch.Generator().manual_seed(7)
        noise = {}
        if inject:
            draw = torch.Generator().manual_seed(7)
            noise = {k: torch.randn((B, d), generator=draw)
                     for k, d in (("z", PS1.z_dim),
                                  ("eps1", PS1.condition_dim),
                                  ("eps2", PS2.condition_dim))}
        metrics = make_stage2_train_step(PS2, PS1, g1, KL_COEFF)(
            state, batch, gen, LR, LR, **noise)
        results.append((metrics, state.g.state_dict()))
    (m0, sd0), (m1, sd1) = results
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k


def test_frozen_forward_is_a_train_forward_that_keeps_the_statistics():
    """frozen_forward gives G1's train-mode image (batch statistics, not
    the running ones) and leaves every buffer, the running statistics and
    their counts, bit-identical, and G1's mode as it was; a plain
    train-mode forward would move the statistics O times in an object
    pathway."""
    g1 = _he_randomize(build_stage1_g(PS1, seed=0, device="cpu"), 8)
    data = stage2_batch(23)
    rs = np.random.RandomState(9)
    args = (torch.from_numpy(rs.randn(B, PS1.z_dim).astype(np.float32)),
            torch.from_numpy(data["bbox"]),
            torch.from_numpy(data["label_onehot"]),
            torch.from_numpy(data["text_embedding"]),
            torch.from_numpy(rs.randn(B, 16).astype(np.float32)))
    before = _snapshot(g1)
    img = frozen_forward(g1, *args)
    assert not g1.training and not img.requires_grad
    for k, v in g1.state_dict().items():
        assert torch.equal(v, before[k]), k
    with torch.no_grad():
        eval_img = g1(*args)
        want = g1.train()(*args)
    assert torch.equal(img, want)
    assert float((img - eval_img).abs().max()) > 1e-3
    moved = g1.state_dict()
    assert int(moved["local1.2.num_batches_tracked"]) == 3
    assert not torch.equal(moved["local1.2.running_mean"],
                           before["local1.2.running_mean"])
