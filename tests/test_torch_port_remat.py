"""``MOG_REMAT`` in the port's train steps (``train/remat.py``) on the CPU,
modelled on tests/test_remat.py.

A remat mode changes when activations are computed, never what: under
``full``, ``convs`` and ``dots`` the mnist, coco-stackgan-1, stage-2 and
AttnGAN steps (gf 8 / df 4 as tests/test_remat.py; AttnGAN and stage 2 at
the sizes of their step tests) equal the port's mode-0 step from the same
state, batch and noise: losses within rtol 1e-5, updated parameters within
atol 1e-6, and the BatchNorm running statistics and ``num_batches_tracked``
identical, which the recompute must leave as the first run left them. The
mnist step is held in bf16 too. Under ``MOG_REMAT=full`` the mnist and
AttnGAN steps equal the JAX steps traced under the same setting, at
tests/test_torch_port_step.py's and tests/test_torch_port_attngan_step.py's
criteria. On the card each call of the place's plain versions here is a K1
or K2 launch: a remat step places 8 times (the recompute runs the forward
of every region again, its place included) and takes 4 place gradients,
against 4 and 4 at mode 0. A value outside 0|full|convs|dots raises a
ValueError naming it, when the step is built.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiple_objects_gan_tpu.train.attngan_step import (
    make_attngan_train_step as jmake_attngan_train_step)
from multiple_objects_gan_tpu.train.step import (
    make_train_step as jmake_train_step)
from multiple_objects_gan_tpu_torch.data.synthetic import (
    synthetic_coco, synthetic_multimnist)
from multiple_objects_gan_tpu_torch.io.weights import (
    attngan_g_state_dict_from_jax, stage1_d_state_dict_from_jax,
    stage1_g_state_dict_from_jax)
from multiple_objects_gan_tpu_torch.models import common
from multiple_objects_gan_tpu_torch.models.stage1 import build_stage1_g
from multiple_objects_gan_tpu_torch.nn.encoders import RNNEncoder
from multiple_objects_gan_tpu_torch.ops import stn_place_cuda
from multiple_objects_gan_tpu_torch.train import remat
from multiple_objects_gan_tpu_torch.train.attngan_step import (
    make_attngan_train_step)
from multiple_objects_gan_tpu_torch.train.state import (
    create_state, create_state_stage2)
from multiple_objects_gan_tpu_torch.train.step import (
    make_stage2_train_step, make_train_step)
from test_step_parity import _replay_step_noise
from test_torch_port_attngan_step import (
    EMA_ATOL, JTinyImageEncoder, LOSS_ATOL, LOSS_RTOL, N_WORDS, SMOOTH,
    STATS_ATOL, TinyImageEncoder, _want_sds, jax_side, make_batch,
    port_batch, port_state, replay_noise, warm_adam, warm_jax_adam)
from test_torch_port_attngan_step import JCFG as ATTN_JCFG
from test_torch_port_attngan_step import PCFG as ATTN_PCFG
from test_torch_port_clevr import _compare_deltas as _attn_deltas
from test_torch_port_clevr import _stats_close
from test_torch_port_stage2_step import PS1, PS2, stage2_batch
from test_torch_port_step import (
    JCFG, PCFG, _batch, _compare_deltas, _compare_stats, _port_step,
    _randomized_states)

MODES = ["full", "convs", "dots"]
FAMILIES = ["mnist", "coco-stackgan-1", "stage2", "attngan"]
METRIC_RTOL = 1e-5
PARAM_ATOL = 1e-6
LR = 2e-4
B = 4
MNIST = dataclasses.replace(common.MNIST, gf_dim=8, df_dim=4)
COCO = dataclasses.replace(common.COCO_S1, gf_dim=8, df_dim=4)
KL_COEFF = 2.0
REMAT_LAUNCHES = (8, 4)     # K1, K2 a stage-1 step under every remat mode
PLAIN_LAUNCHES = (4, 4)     # at mode 0 (tests/test_torch_port_step.py)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _remat_env(mode: str):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MOG_REMAT", mode)
        yield


@contextlib.contextmanager
def _counted_places():
    """The place's plain versions counted: on the card each is a K1 or K2
    launch."""
    calls = {"place": 0, "grad": 0}
    fns = {"place": stn_place_cuda.stn_place_multi_plain,
           "grad": stn_place_cuda.stn_place_multi_grad_plain}

    def counted(kind):
        def call(*args):
            calls[kind] += 1
            return fns[kind](*args)
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stn_place_cuda, "stn_place_multi_plain", counted("place"))
        mp.setattr(stn_place_cuda, "stn_place_multi_grad_plain",
                   counted("grad"))
        yield calls


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _stage1(cfg, data, kl=False):
    state = create_state(cfg, seed=3, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    noise = {"z": torch.randn(B, cfg.z_dim, generator=_gen(5))}
    if cfg.use_ca:
        noise["eps"] = torch.randn(B, cfg.condition_dim, generator=_gen(6))
    step = make_train_step(cfg, KL_COEFF) if kl else make_train_step(cfg)
    return (lambda: step(state, batch, None, LR, LR, **noise)), {
        "g": state.g, "d": state.d}


def _family(name, dtype=None):
    """(a closure running one step, {name: module}) for ``name``, built
    under the MOG_REMAT of the moment."""
    if name == "mnist":
        cfg = dataclasses.replace(MNIST, compute_dtype=dtype)
        return _stage1(cfg, synthetic_multimnist(B, seed=1))
    if name == "coco-stackgan-1":
        data = synthetic_coco(B, seed=21)
        data["text_embedding"] = data["text_embedding"][:, 1].copy()
        return _stage1(COCO, data, kl=True)
    if name == "stage2":
        g1 = build_stage1_g(PS1, seed=4, device="cpu")
        state = create_state_stage2(PS2, seed=3, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in stage2_batch(21).items()}
        noise = {"z": torch.randn(B, PS1.z_dim, generator=_gen(5)),
                 "eps1": torch.randn(B, PS1.condition_dim, generator=_gen(6)),
                 "eps2": torch.randn(B, PS2.condition_dim, generator=_gen(7))}
        step = make_stage2_train_step(PS2, PS1, g1, KL_COEFF)
        return (lambda: step(state, batch, None, LR, LR, **noise)), {
            "g": state.g, "d": state.d, "g1": g1}
    torch.manual_seed(0)
    enc = RNNEncoder(N_WORDS, ninput=8, nhidden=16).eval()
    state = port_state(3)
    warm_adam(state)
    batch = port_batch(make_batch(11))
    z = torch.randn(B, ATTN_PCFG.z_dim, generator=_gen(5))
    eps = torch.randn(B, ATTN_PCFG.condition_dim, generator=_gen(6))
    step = make_attngan_train_step(ATTN_PCFG, enc, TinyImageEncoder(),
                                   smooth=SMOOTH)
    return (lambda: step(state, batch, None, LR, LR, z=z, eps=eps)), {
        "g": state.g, **state.ds}


def run_step(name, mode, dtype=None) -> dict:
    """One step of ``name`` under ``mode``: its losses, every module's
    state dict after it, and the place's calls."""
    with _remat_env(mode):
        step, modules = _family(name, dtype)
    with _counted_places() as calls:
        metrics = step()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {f"{m}.{k}": v.detach().clone()
                      for m, mod in modules.items()
                      for k, v in mod.state_dict().items()},
            "launches": (calls["place"], calls["grad"])}


_BASE: dict = {}


def baseline(name, dtype=None) -> dict:
    """The mode-0 step of ``name``, run once for the file."""
    key = (name, dtype)
    if key not in _BASE:
        _BASE[key] = run_step(name, "0", dtype)
    return _BASE[key]


def _is_buffer(key: str) -> bool:
    return key.endswith(("running_mean", "running_var",
                         "num_batches_tracked"))


def assert_same_step(got, want, what):
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=METRIC_RTOL,
                                   err_msg=f"{what} {k}")
    assert sorted(got["state"]) == sorted(want["state"])
    for k, v in want["state"].items():
        if _is_buffer(k):
            assert torch.equal(got["state"][k], v), f"{what} {k}"
        else:
            np.testing.assert_allclose(got["state"][k].float().numpy(),
                                       v.float().numpy(), atol=PARAM_ATOL,
                                       err_msg=f"{what} {k}")


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mode", MODES)
def test_remat_modes_match_mode_0(mode, family):
    assert_same_step(run_step(family, mode), baseline(family),
                     f"{family} {mode}")


@pytest.mark.parametrize("mode", MODES)
def test_remat_modes_match_mode_0_in_bf16(mode):
    assert_same_step(run_step("mnist", mode, torch.bfloat16),
                     baseline("mnist", torch.bfloat16), f"bf16 {mode}")


@pytest.mark.parametrize("family", ["mnist", "attngan"])
@pytest.mark.parametrize("mode", ["0"] + MODES)
def test_remat_step_places_again_in_its_recompute(mode, family):
    """K1 runs again in every region's recompute: G's forward and D on
    the real, the detached fake and the fake in the G update; K2 as at
    mode 0."""
    got = run_step(family, mode) if mode != "0" else baseline(family)
    want = PLAIN_LAUNCHES if mode == "0" else REMAT_LAUNCHES
    assert got["launches"] == want


def test_stage2_recompute_leaves_g2_forward_alone():
    """Stage 2 wraps the D and G updates, not G2's forward: 3 more places
    (D on the real, the fake, the fake again), none for G1 and G2."""
    base, got = baseline("stage2"), run_step("stage2", "full")
    assert got["launches"] == (base["launches"][0] + 3, base["launches"][1])


@pytest.mark.parametrize("value, mode", [
    ("", "0"), ("0", "0"), ("false", "0"), ("OFF", "0"), ("1", "full"),
    ("true", "full"), ("on", "full"), ("Full", "full"), ("convs", "convs"),
    ("dots", "dots")])
def test_remat_values_and_aliases(value, mode):
    assert remat.remat_mode(value) == remat.Remat(value).mode == mode


@pytest.mark.parametrize("build", ["stage1", "stage2", "attngan"])
def test_remat_bad_value_raises_when_the_step_is_built(monkeypatch, build):
    monkeypatch.setenv("MOG_REMAT", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        if build == "stage1":
            make_train_step(MNIST)
        elif build == "stage2":
            make_stage2_train_step(PS2, PS1, None)
        else:
            make_attngan_train_step(ATTN_PCFG, RNNEncoder(N_WORDS, 8, 16),
                                    TinyImageEncoder())


def test_remat_is_read_when_the_step_is_built(monkeypatch):
    """A step built under ``full`` recomputes when MOG_REMAT changes after
    it is built, as a jitted JAX step keeps its traced setting."""
    with _remat_env("full"):
        step, _ = _family("mnist")
    monkeypatch.setenv("MOG_REMAT", "0")
    with _counted_places() as calls:
        step()
    assert (calls["place"], calls["grad"]) == REMAT_LAUNCHES


def test_selective_modes_leave_activations_in_place_after_the_step():
    """convs and dots run the models with out-of-place activations for the
    step (selective checkpointing refuses a saved output changed in
    place) and give the modules back as they were."""
    with _remat_env("convs"):
        step, modules = _family("mnist")
    inplace = [m for mod in modules.values() for m in mod.modules()
               if getattr(m, "inplace", False)]
    assert inplace
    step()
    assert all(m.inplace for m in inplace)


# ------------------------------------------------ against JAX under full


def test_mnist_full_remat_matches_jax_under_full(monkeypatch):
    """tests/test_torch_port_step.py's one-step check with both steps
    traced or built under MOG_REMAT=full."""
    monkeypatch.setenv("MOG_REMAT", "full")
    state, jstate, jg, jd = _randomized_states()
    batch = _batch()
    rng = jax.random.PRNGKey(42)
    step = jax.jit(jmake_train_step(JCFG, jg, jd))
    new_jstate, metrics = step(jstate, jax.tree.map(jnp.asarray, batch), rng,
                               jnp.float32(LR), jnp.float32(LR))
    z, _ = _replay_step_noise(rng, 0, len(batch["image"]), JCFG.z_dim)
    got, pre_g, pre_d = _port_step(state, batch, np.array(z))
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


def test_attngan_full_remat_matches_jax_under_full(monkeypatch):
    """tests/test_torch_port_attngan_step.py's one-step check with both
    steps traced or built under MOG_REMAT=full."""
    monkeypatch.setenv("MOG_REMAT", "full")
    prev = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        state = port_state(3)
        jstate, (jg, jds, jenc), enc_vars, enc = jax_side(state, 3)
        jstate = warm_jax_adam(jstate)
        batch = make_batch(11)
        rng = jax.random.PRNGKey(42)
        jstep = jax.jit(jmake_attngan_train_step(
            ATTN_JCFG, jg, jds, jenc, JTinyImageEncoder(), smooth=SMOOTH))
        new_jstate, metrics = jstep(jstate, enc_vars,
                                    jax.tree.map(jnp.asarray, batch), rng,
                                    jnp.float32(LR), jnp.float32(LR))
    finally:
        jax.config.update("jax_default_matmul_precision", prev)
    warm_adam(state)
    pre = {"g": {k: v.clone() for k, v in state.g.state_dict().items()},
           **{n: {k: v.clone() for k, v in d.state_dict().items()}
              for n, d in state.ds.items()}}
    z, eps = replay_noise(rng)
    got = make_attngan_train_step(ATTN_PCFG, enc, TinyImageEncoder(),
                                  smooth=SMOOTH)(
        state, port_batch(batch), None, LR, LR, z=z, eps=eps)
    assert sorted(got) == sorted(metrics)
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   atol=LOSS_ATOL, rtol=LOSS_RTOL,
                                   err_msg=f"loss {k}")
    want_g, want_ds = _want_sds(new_jstate)
    _stats_close(state.g.state_dict(), want_g, "g_stats", atol=STATS_ATOL)
    _attn_deltas(pre["g"], state.g.state_dict(), want_g, "G")
    for n, d in state.ds.items():
        _stats_close(d.state_dict(), want_ds[n], f"{n}_stats",
                     atol=STATS_ATOL)
        _attn_deltas(pre[n], d.state_dict(), want_ds[n], n)
    want_ema = attngan_g_state_dict_from_jax(new_jstate.g_ema,
                                             new_jstate.g_stats, 3, 1)
    for k, v in state.g_ema.items():
        np.testing.assert_allclose(v.numpy(), want_ema[k].numpy(),
                                   atol=EMA_ATOL, err_msg=f"ema {k}")
