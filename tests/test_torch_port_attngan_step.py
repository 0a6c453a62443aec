"""The port's AttnGAN train step
(multiple_objects_gan_tpu_torch.train.attngan_step.make_attngan_train_step)
against the JAX package's ``make_attngan_train_step``, on the CPU.

Sizes: gf 8, df 8, condition and embedding 16, R_NUM 1, three branches
(64, 128, 256px), batch 4, 6 words, a vocabulary of 20. The port's G and
Ds get He-scale weights (tests/test_torch_port_stage2_step.py:
_he_randomize); the JAX state gets the same through the JAX package's
importers (``import_attngan_g``, ``import_attngan_d``). Both steps use the
same frozen text encoder (JAX weights carried across) and the same tiny
image-encoder stand-in (as tests/test_attngan.py:TinyImageEncoder stands
in for Inception there): a fixed average pool of the image to 17x17 and a
3 -> 16 map, so that no Inception is traced. The JAX step's z and CA eps
are replayed from its rng (``fold_in(rng, 0)``, split in two), as
tests/test_step_parity.py:87-93 replays z. Both start from one warm Adam
state (tests/test_torch_port_stage2_step.py:_warm_adam), where the update
is linear in the gradient.

Held: every loss at LOSS_ATOL 1e-4 plus LOSS_RTOL 1e-5 of it (the DAMSM
terms are LAMBDA 50 times the cross-entropies, 682 and 152 here; read: 4.4e-7
of g_loss_total, up to 2.9e-6 absolute on the D and G terms); the running
statistics of G and the three Ds at STATS_ATOL 5e-4 (relative for
variances); the per-tensor Adam deltas of G and every D at cosine > 0.999,
mean |difference| < 0.02 lr and at most 0.5% of the elements apart by more
than 0.5 lr (tests/test_torch_port_clevr.py:_compare_deltas); the EMA of
G's parameters at EMA_ATOL 1e-7. The Ds' running statistics follow their
call order (real, fake; the conditional head real, fake, wrong; in the G
update fake), and a step that calls the heads in stage 1's order (real,
wrong, fake) strays from JAX's (ORDER_ATOL 1e-5).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multiple_objects_gan_tpu.io.torch_import import (
    import_attngan_d, import_attngan_g)
from multiple_objects_gan_tpu.models.attngan import (
    COCO_ATTN as JCOCO_ATTN, DNet64 as JDNet64, DNetScale as JDNetScale,
    GNet as JGNet)
from multiple_objects_gan_tpu.nn.encoders import RNNEncoder as JRNNEncoder
from multiple_objects_gan_tpu.train.attngan_step import (
    bce_probs as jbce_probs, create_attngan_state as jcreate_attngan_state,
    make_attngan_train_step as jmake_attngan_train_step)
from multiple_objects_gan_tpu_torch.io.weights import (
    attngan_d_state_dict_from_jax, attngan_g_state_dict_from_jax,
    text_encoder_state_dict_from_jax)
from multiple_objects_gan_tpu_torch.models.attngan import COCO_ATTN
from multiple_objects_gan_tpu_torch.nn.encoders import RNNEncoder
from multiple_objects_gan_tpu_torch.train import attngan_step
from multiple_objects_gan_tpu_torch.train.attngan_step import (
    bce_probs, make_attngan_train_step)
from multiple_objects_gan_tpu_torch.train.state import create_attngan_state
from test_torch_port_clevr import _compare_deltas, _stats_close
from test_torch_port_stage2_step import _he_randomize

LR = 2e-4
B = 4
T = 6
N_WORDS = 20
LOSS_ATOL = 1e-4
LOSS_RTOL = 1e-5
STATS_ATOL = 5e-4
EMA_ATOL = 1e-7
ORDER_ATOL = 1e-5
ADAM_COUNT = 10
SMOOTH = {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0, "LAMBDA": 50.0}
_TINY = dict(gf_dim=8, df_dim=8, condition_dim=16, embedding_dim=16,
             branch_num=3, r_num=1)
JCFG = dataclasses.replace(JCOCO_ATTN, **_TINY)
PCFG = dataclasses.replace(COCO_ATTN, **_TINY)
SCALES = {"d64": 64, "d128": 128, "d256": 256}


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


# ------------------------------------------- the image-encoder stand-in


def _pool_matrix(size: int, out: int = 17) -> np.ndarray:
    """(out, size): the mean of each of ``out`` contiguous bins."""
    m = np.zeros((out, size), np.float32)
    for p in range(out):
        lo, hi = (p * size) // out, -((-(p + 1) * size) // out)
        m[p, lo:hi] = 1.0 / (hi - lo)
    return m


_W_IMG = np.random.RandomState(5).randn(3, 16).astype(np.float32) * 0.5


class JTinyImageEncoder:
    """The JAX side of the stand-in: regions (B, 17, 17, 16) NHWC."""

    def apply(self, variables, x, train=False):
        m = jnp.asarray(_pool_matrix(x.shape[1]))
        pooled = jnp.einsum("ph,bhwc,qw->bpqc", m, x.astype(jnp.float32), m)
        region = jnp.einsum("bpqc,cd->bpqd", pooled, variables["w"])
        return region, region.mean(axis=(1, 2))


class TinyImageEncoder(nn.Module):
    """The port side: regions (B, 16, 17, 17) NCHW, the CNNEncoder's
    contract."""

    def __init__(self):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(_W_IMG))

    def forward(self, x):
        m = torch.from_numpy(_pool_matrix(x.shape[-1]))
        pooled = torch.einsum("ph,bchw,qw->bcpq", m, x.float(), m)
        region = torch.einsum("bcpq,cd->bdpq", pooled, self.w)
        return region, region.mean(dim=(2, 3))


# ----------------------------------------------------------- the batch


def make_batch(seed: int) -> dict:
    """B items: uint8 images at 64/128/256 with bright boxes, 1-3 objects
    (padded with -1), ragged captions (lengths 2..T, zero-padded) and class
    ids with a repeat (items 0 and 2), so the DAMSM class mask acts."""
    rs = np.random.RandomState(seed)
    bbox = np.full((B, 3, 4), -1.0, np.float32)
    labels = np.zeros((B, 3, 81), np.float32)
    labels[:, :, 80] = 1.0
    for i in range(B):
        for j in range(rs.randint(1, 4)):
            w, h = rs.uniform(0.2, 0.45, 2)
            bbox[i, j] = [rs.uniform(0, 1 - w), rs.uniform(0, 1 - h), w, h]
            labels[i, j, 80] = 0.0
            labels[i, j, rs.randint(0, 80)] = 1.0
    lens = rs.randint(2, T + 1, B)
    caps = np.zeros((B, T), np.int32)
    for i in range(B):
        caps[i, :lens[i]] = rs.randint(1, N_WORDS, lens[i])
    batch = {"bbox": bbox, "label_onehot": labels, "captions": caps,
             "cap_lens": lens.astype(np.int32),
             "class_ids": np.array([3, 1, 3, 7], np.int32)}
    for s in (64, 128, 256):
        img = rs.randint(0, 60, (B, s, s, 3))
        for i in range(B):
            for x, y, w, h in bbox[i][bbox[i, :, 0] >= 0]:
                img[i, int(y * s):int((y + h) * s),
                    int(x * s):int((x + w) * s)] += 150
        batch[f"image{s}"] = img.clip(0, 255).astype(np.uint8)
    return batch


def port_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


# ----------------------------------------------------------- the states


def _numpy_sd(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def port_state(seed: int):
    """The port's state with He-scale weights: G from ``seed``, the Ds
    from seed + 1..3."""
    state = create_attngan_state(PCFG, seed=0, device="cpu")
    _he_randomize(state.g, seed)
    for i, d in enumerate(state.ds.values()):
        _he_randomize(d, seed + 1 + i)
    state.g_ema.update({k: p.detach().clone()
                        for k, p in state.g.named_parameters()})
    return state


def jax_side(state, seed: int):
    """A JAX state holding ``state``'s weights, the JAX modules, and the
    text encoder's variables (drawn from ``seed``) with the port's
    RNNEncoder holding the same."""
    jg = JGNet(JCFG)
    jds = {"d64": JDNet64(JCFG), "d128": JDNetScale(JCFG, scale=128),
           "d256": JDNetScale(JCFG, scale=256)}
    jstate = jcreate_attngan_state(JCFG, jg, jds, jax.random.PRNGKey(0),
                                   batch_size=2, seq_len=T)
    gp, gs = import_attngan_g(_numpy_sd(state.g), branch_num=3, r_num=1)
    dp, dst = {}, {}
    for n, d in state.ds.items():
        dp[n], dst[n] = import_attngan_d(_numpy_sd(d), scale=SCALES[n])
    jstate = jstate.replace(g_params=gp, g_stats=gs, d_params=dp,
                            d_stats=dst,
                            g_ema=jax.tree.map(np.copy, gp))
    jenc = JRNNEncoder(ntoken=N_WORDS, ninput=8, nhidden=16)
    caps = jnp.ones((2, T), jnp.int32)
    tvars = jenc.init(jax.random.PRNGKey(seed), caps,
                      jnp.full((2,), T, jnp.int32), train=False)
    enc = RNNEncoder(N_WORDS, ninput=8, nhidden=16)
    enc.load_state_dict(text_encoder_state_dict_from_jax(
        jax.tree.map(np.asarray, tvars)), strict=True)
    return jstate, (jg, jds, jenc), {"text": tvars, "image": {
        "w": jnp.asarray(_W_IMG)}}, enc.eval()


def warm_adam(state):
    """The port's Adams (G's and each D's) at count ADAM_COUNT with first
    moments 0 and second moments 1."""
    for opt in (state.g_opt, *state.d_opts.values()):
        for group in opt.param_groups:
            for p in group["params"]:
                opt.state[p] = {"step": torch.tensor(float(ADAM_COUNT)),
                                "exp_avg": torch.zeros_like(p),
                                "exp_avg_sq": torch.ones_like(p)}


def warm_jax_adam(jstate):
    """The JAX state's Adams as :func:`warm_adam` sets the port's."""
    def warm(s):
        return s._replace(count=jnp.full_like(s.count, ADAM_COUNT),
                          mu=jax.tree.map(jnp.zeros_like, s.mu),
                          nu=jax.tree.map(jnp.ones_like, s.nu))

    return jstate.replace(g_opt=warm(jstate.g_opt),
                          d_opt={k: warm(v) for k, v in jstate.d_opt.items()})


def replay_noise(rng):
    """The z and CA eps the JAX step draws at step 0."""
    rng_z, rng_ca = jax.random.split(jax.random.fold_in(rng, 0))
    return [torch.from_numpy(np.array(jax.random.normal(k, (B, d),
                                                        jnp.float32)))
            for k, d in ((rng_z, JCFG.z_dim), (rng_ca, JCFG.condition_dim))]


def _snapshot(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def stepped():
    """One JAX step (jitted once for the module) and the port's inputs."""
    jstate, (jg, jds, jenc), enc_vars, enc = jax_side(port_state(3), 3)
    jstate = warm_jax_adam(jstate)
    batch = make_batch(11)
    rng = jax.random.PRNGKey(42)
    step = jax.jit(jmake_attngan_train_step(JCFG, jg, jds, jenc,
                                            JTinyImageEncoder(),
                                            smooth=SMOOTH))
    new_jstate, metrics = step(jstate, enc_vars,
                               jax.tree.map(jnp.asarray, batch), rng,
                               jnp.float32(LR), jnp.float32(LR))
    return {"jstate": new_jstate,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "batch": batch, "noise": replay_noise(rng), "enc": enc}


def port_step(stepped, order=None):
    """The port's step from the same start; ``order`` swaps in another
    d_loss_one_scale. Returns (state, metrics, G and D state dicts before
    the step)."""
    state = port_state(3)
    warm_adam(state)
    pre = {"g": _snapshot(state.g),
           **{n: _snapshot(d) for n, d in state.ds.items()}}
    step = make_attngan_train_step(PCFG, stepped["enc"], TinyImageEncoder(),
                                   smooth=SMOOTH)
    z, eps = stepped["noise"]
    saved = attngan_step.d_loss_one_scale
    if order is not None:
        attngan_step.d_loss_one_scale = order
    try:
        metrics = step(state, port_batch(stepped["batch"]), None, LR, LR,
                       z=z, eps=eps)
    finally:
        attngan_step.d_loss_one_scale = saved
    return state, {k: float(v) for k, v in metrics.items()}, pre


def _want_sds(jstate):
    g = attngan_g_state_dict_from_jax(jstate.g_params, jstate.g_stats, 3, 1)
    ds = {n: attngan_d_state_dict_from_jax(jstate.d_params[n],
                                           jstate.d_stats[n], SCALES[n])
          for n in SCALES}
    return g, ds


def test_one_attngan_step_matches_jax_make_attngan_train_step(stepped):
    """Losses, G's and each D's running statistics and Adam deltas, and
    the EMA, against one jitted JAX step."""
    state, got, pre = port_step(stepped)
    want = stepped["metrics"]
    assert sorted(got) == sorted(want) == sorted(
        ["g_loss_total", "w_loss", "s_loss", "kl_loss"]
        + [f"{k}_{n}" for k in ("d_loss", "g_loss") for n in SCALES])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=LOSS_ATOL,
                                   rtol=LOSS_RTOL, err_msg=f"loss {k}")
    assert got["w_loss"] > 0 and got["s_loss"] > 0 and got["kl_loss"] > 0
    np.testing.assert_allclose(
        got["g_loss_total"],
        sum(got[f"g_loss_{n}"] for n in SCALES) + got["w_loss"]
        + got["s_loss"] + got["kl_loss"], rtol=1e-6)
    want_g, want_ds = _want_sds(stepped["jstate"])
    _stats_close(state.g.state_dict(), want_g, "g_stats", atol=STATS_ATOL)
    _compare_deltas(pre["g"], state.g.state_dict(), want_g, "G")
    for n, d in state.ds.items():
        _stats_close(d.state_dict(), want_ds[n], f"{n}_stats",
                     atol=STATS_ATOL)
        _compare_deltas(pre[n], d.state_dict(), want_ds[n], n)
    want_ema = attngan_g_state_dict_from_jax(
        stepped["jstate"].g_ema, stepped["jstate"].g_stats, 3, 1)
    assert sorted(state.g_ema) == sorted(
        k for k, _ in state.g.named_parameters())
    for k, v in state.g_ema.items():
        np.testing.assert_allclose(v.numpy(), want_ema[k].numpy(),
                                   atol=EMA_ATOL, err_msg=f"ema {k}")
        want = 0.999 * pre["g"][k] + 0.001 * state.g.state_dict()[k]
        np.testing.assert_allclose(v.numpy(), want.numpy(), atol=1e-8)
    assert state.step == 1
    for opt in (state.g_opt, *state.d_opts.values()):
        assert all(float(st["step"]) == ADAM_COUNT + 1
                   for st in opt.state.values())


def _stage1_order(d, real, fake, cond, labels, bbox):
    """The D loss with the heads called in stage 1's order: real, wrong,
    fake."""
    b = real.shape[0]
    feat_real = d(real, labels, bbox)
    feat_fake = d(fake.detach(), labels, bbox)
    p_real = d.cond_logits(feat_real, cond)
    p_wrong = d.cond_logits(feat_real[:b - 1], cond[1:])
    p_fake = d.cond_logits(feat_fake, cond)
    pu_real, pu_fake = d.uncond_logits(feat_real), d.uncond_logits(feat_fake)
    bce = bce_probs
    return ((bce(p_real, 1.0) + bce(pu_real, 1.0)) / 2.0
            + (bce(p_fake, 0.0) + bce(p_wrong, 0.0) + bce(pu_fake, 0.0))
            / 3.0)


def test_d_call_order_shows_in_the_running_statistics(stepped):
    """The conditional head's BatchNorm (``COND_DNET.jointConv.1``) takes
    one update a call; the JAX order (real, fake, wrong) matches within
    ORDER_ATOL (read: 6.6e-7), stage 1's (real, wrong, fake) leaves the
    same losses and strays by more than 100 x ORDER_ATOL in every D
    (read: 1.6e-3 to 6.3e-3)."""
    _, want_ds = _want_sds(stepped["jstate"])
    state, got, _ = port_step(stepped)
    other, got_other, _ = port_step(stepped, order=_stage1_order)
    for n in SCALES:
        for stat in ("running_mean", "running_var"):
            key = f"COND_DNET.jointConv.1.{stat}"
            want = want_ds[n][key].numpy()
            right = np.abs(state.ds[n].state_dict()[key].numpy()
                           - want).max()
            wrong = np.abs(other.ds[n].state_dict()[key].numpy()
                           - want).max()
            assert right < ORDER_ATOL, (n, stat, right)
            assert wrong > 100 * ORDER_ATOL, (n, stat, wrong)
        assert int(state.ds[n].state_dict()[
            "COND_DNET.jointConv.1.num_batches_tracked"]) == 4
    np.testing.assert_allclose(got_other["d_loss_d64"], got["d_loss_d64"],
                               rtol=1e-5)


@pytest.mark.parametrize("target", [0.0, 1.0])
def test_bce_at_saturated_probabilities_matches_jax(target):
    """bce_probs and its gradient at probabilities 0, a subnormal, 1e-30,
    0.3, 1 - 2^-24 and 1: torch's -100 log clamp and its 1e-12 backward
    clamp, as the JAX step's custom VJP. The gradients are held at rtol
    1e-6 and atol 1e-30: XLA on the CPU flushes the subnormal to 0, where
    torch's gradient at it is 1e-45 / 1e-12 / 2 = 7e-34."""
    ps = np.array([0.0, 1e-45, 1e-30, 0.3, 1.0 - 2.0 ** -24, 1.0],
                  np.float32)
    for p in ps:
        pt = torch.tensor([p, 0.5], requires_grad=True)
        loss = bce_probs(pt, target)
        (grad,) = torch.autograd.grad(loss, pt)
        jp = jnp.asarray([p, 0.5])
        jloss, jgrad = jax.value_and_grad(
            lambda x: jbce_probs(x, target))(jp)
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6,
                                   err_msg=f"p={p}")
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad),
                                   rtol=1e-6, atol=1e-30,
                                   err_msg=f"grad p={p}")
        assert np.isfinite(grad.numpy()).all()


def test_step_draws_z_then_eps_from_its_generator(stepped):
    """Without injected noise the step draws z, then the CA eps, from the
    caller's generator: the same step given those draws ends with the same
    losses, weights and EMA."""
    results = []
    for inject in (False, True):
        state = port_state(4)
        step = make_attngan_train_step(PCFG, stepped["enc"],
                                       TinyImageEncoder(),
                                       smooth=SMOOTH)
        noise = {}
        if inject:
            draw = torch.Generator().manual_seed(9)
            noise = {k: torch.randn((B, d), generator=draw)
                     for k, d in (("z", PCFG.z_dim),
                                  ("eps", PCFG.condition_dim))}
        metrics = step(state, port_batch(stepped["batch"]),
                       torch.Generator().manual_seed(9), LR, LR, **noise)
        results.append((metrics, state.g.state_dict(), dict(state.g_ema)))
    (m0, sd0, e0), (m1, sd1, e1) = results
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    for k in e0:
        assert torch.equal(e0[k], e1[k]), k
