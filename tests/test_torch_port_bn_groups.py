"""The port's BatchNorm groups (``Stage1Config.bn_groups``, the train CLI's
``--bn_groups``) against ``nn.DataParallel``'s semantics and against the
JAX package under ``BN_GROUPS``, on the CPU, modelled on
tests/test_bn_groups.py (its tests at lines 30, 125, 204 and 238).

DataParallel over G GPUs on a batch B is exactly: split B into contiguous
chunks as ``torch.chunk`` does, run each chunk with its own BatchNorm
statistics, concatenate; the master module keeps only replica 0's
running-statistic update. The JAX side sets ``BN_GROUPS`` with
``monkeypatch``, as tests/test_bn_groups.py does; nothing of the JAX
package is edited.

Tolerances: a layer against its split oracle, atol 1e-5 on outputs and
1e-6 on running statistics (tests/test_bn_groups.py's, the same float32
arithmetic in another order); against JAX, outputs and statistics atol 1e-5
in float32 (the port's variance is two-pass, JAX's E[x^2] - E[x]^2) and one
bf16 ulp of the largest |output| in bf16; the step, as
tests/test_torch_port_step.py holds the float32 step (losses atol 1e-3,
running statistics atol 5e-4, Adam-delta criteria), at batch 8, so that
each group holds 4 samples. (At batch 4 a group's BatchNorm1d takes the
variance of 2 values per channel, where JAX's E[x^2] - E[x]^2 and the
port's two-pass variance part by more than float32 noise, and a first Adam
step turns that into sign flips: the worst delta cosine read 0.993.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiple_objects_gan_tpu.nn import blocks as jblocks
from multiple_objects_gan_tpu.train.step import (
    make_train_step as jmake_train_step)
from multiple_objects_gan_tpu_torch.io.weights import (
    stage1_d_state_dict_from_jax, stage1_g_state_dict_from_jax)
from multiple_objects_gan_tpu_torch.models.stage1 import (
    build_stage1_d, build_stage1_g)
from multiple_objects_gan_tpu_torch.nn.blocks import (
    BatchNorm1d, BatchNorm2d, ObjectBatchNorm2d)
from multiple_objects_gan_tpu_torch.train.state import create_state
from multiple_objects_gan_tpu_torch.train.step import make_train_step
from test_step_parity import _layout_batch, _replay_step_noise
from test_torch_port_step import (
    JCFG, LR, PCFG, _compare_deltas, _compare_stats, _randomized_states)

STEP_BATCH = 8


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bn(cls, c, seed, **kwargs):
    """A train-mode port BatchNorm with weights and running statistics away
    from their init."""
    rs = np.random.RandomState(seed)
    m = cls(c, **kwargs)
    m.load_state_dict({
        "weight": torch.from_numpy(rs.uniform(0.5, 1.5, c).astype(np.float32)),
        "bias": torch.from_numpy(rs.normal(0, 0.2, c).astype(np.float32)),
        "running_mean": torch.from_numpy(
            rs.normal(0, 0.2, c).astype(np.float32)),
        "running_var": torch.from_numpy(
            rs.uniform(0.5, 1.5, c).astype(np.float32)),
        "num_batches_tracked": torch.tensor(0)})
    return m.train()


def _split_oracle(grouped, x, chunks):
    """DataParallel's result: each chunk through a one-group copy of the
    module; the running statistics of replica 0."""
    outs, replicas = [], []
    for chunk in chunks:
        one = type(grouped)(grouped.num_features)
        one.load_state_dict(grouped.state_dict())
        outs.append(one.train()(chunk))
        replicas.append(one)
    return torch.cat(outs), replicas[0]


def _close(a, b, atol, what):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("cls, shape", [(BatchNorm2d, (8, 3, 4, 4)),
                                        (BatchNorm1d, (8, 6))],
                         ids=["2d", "1d"])
def test_grouped_bn_matches_split_forward(cls, shape):
    """Two groups == two independent forwards on the contiguous halves;
    the running statistics are the first half's."""
    x = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(
        np.float32) * 2.0 + 0.5)
    grouped = _bn(cls, shape[1], 1, groups=2)
    want, replica0 = _split_oracle(grouped, x, (x[:4], x[4:]))
    got = grouped(x)
    _close(got.detach(), want.detach(), 1e-5, "output")
    for k in ("running_mean", "running_var"):
        _close(getattr(grouped, k), getattr(replica0, k), 1e-6, k)
    # the second half's statistics are not the module's
    _, second = _split_oracle(_bn(cls, shape[1], 1, groups=2), x, (x[4:],))
    assert not torch.allclose(grouped.running_mean, second.running_mean,
                              atol=1e-6)


def test_grouped_bn_uneven_batch_matches_torch_chunk():
    """5 rows over 2 groups split as torch.chunk splits them, 3 + 2 (the
    wrong-pair branch sends b - 1 rows through D's cond head)."""
    x = torch.from_numpy(np.random.RandomState(2).randn(5, 3, 4, 4).astype(
        np.float32) * 1.5 - 0.2)
    assert [len(c) for c in torch.chunk(x, 2)] == [3, 2]
    grouped = _bn(BatchNorm2d, 3, 2, groups=2)
    want, replica0 = _split_oracle(grouped, x, torch.chunk(x, 2))
    got = grouped(x)
    _close(got.detach(), want.detach(), 1e-5, "output")
    for k in ("running_mean", "running_var"):
        _close(getattr(grouped, k), getattr(replica0, k), 1e-6, k)


def test_object_fold_composes_with_groups():
    """ObjectBatchNorm2d with 2 groups == each replica running its own
    loop over objects on its chunk of the batch (the per-object calls of
    the reference); the running statistics come from replica 0's loop."""
    b, o, c = 4, 2, 3
    x = np.random.RandomState(6).randn(b, o, c, 4, 4).astype(np.float32) - 0.4
    grouped = _bn(ObjectBatchNorm2d, c, 6, n_objects=o, groups=2)
    before = {k: v.clone() for k, v in grouped.state_dict().items()}
    got = grouped(torch.from_numpy(x.reshape(b * o, c, 4, 4))).reshape(
        b, o, c, 4, 4)
    replica_stats = []
    for chunk in (slice(0, 2), slice(2, 4)):
        one = _bn(BatchNorm2d, c, 6)
        one.load_state_dict(before)
        for idx in range(o):
            yo = one(torch.from_numpy(x[chunk, idx]))
            _close(got[chunk, idx].detach(), yo.detach(), 1e-5,
                   f"chunk {chunk} object {idx}")
        replica_stats.append(one)
    for k in ("running_mean", "running_var"):
        _close(getattr(grouped, k), getattr(replica_stats[0], k), 1e-6, k)


def test_object_fold_refuses_groups_that_do_not_divide_the_batch():
    bn = ObjectBatchNorm2d(4, 3, groups=2).train()
    with pytest.raises(ValueError, match="must divide"):
        bn(torch.randn(3 * 3, 4, 2, 2))
    with pytest.raises(ValueError, match="at least 1"):
        BatchNorm2d(4, groups=0)


def test_groups_leave_eval_mode_alone():
    x = torch.randn(6, 3, 4, 4)
    grouped = _bn(BatchNorm2d, 3, 3, groups=3).eval()
    plain = _bn(BatchNorm2d, 3, 3).eval()
    assert torch.equal(grouped(x), plain(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fold", [1, 2], ids=["plain", "object-fold"])
def test_grouped_bn_matches_jax(monkeypatch, dtype, fold):
    """The port's grouped BatchNorm against the JAX ``TorchBatchNorm`` under
    ``BN_GROUPS = 2`` (and ``object_fold``), in float32 and bf16."""
    monkeypatch.setattr(jblocks, "BN_GROUPS", 2)
    c = 5
    rs = np.random.RandomState(7)
    x = (rs.randn(4 * fold, 3, 3, c) * 1.7 + 0.3).astype(np.float32)
    m = (_bn(ObjectBatchNorm2d, c, 7, n_objects=fold, groups=2) if fold > 1
         else _bn(BatchNorm2d, c, 7, groups=2))
    params = {"scale": m.weight.detach().numpy(),
              "bias": m.bias.detach().numpy()}
    stats = {"mean": m.running_mean.numpy().copy(),
             "var": m.running_var.numpy().copy()}
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    with jblocks.object_fold(fold):
        y, new = jblocks.TorchBatchNorm().apply(
            {"params": params, "batch_stats": stats}, jx, train=True,
            mutable=["batch_stats"])
    want = np.asarray(y.astype(jnp.float32)).transpose(0, 3, 1, 2)
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2).to(
        getattr(torch, dtype))).detach().float().numpy()
    atol = 1e-5 if dtype == "float32" else float(
        2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7))
    _close(got, want, atol, "output")
    for k, jk in (("running_mean", "mean"), ("running_var", "var")):
        assert getattr(m, k).dtype == torch.float32
        _close(getattr(m, k), new["batch_stats"][jk], 1e-5, k)


def test_one_step_at_two_groups_matches_jax(monkeypatch):
    """One port step with bn_groups 2 against the JAX step under
    ``BN_GROUPS = 2``, from the weights of tests/test_step_parity.py."""
    monkeypatch.setattr(jblocks, "BN_GROUPS", 2)
    cfg = dataclasses.replace(PCFG, bn_groups=2)
    state, jstate, jg, jd = _randomized_states()
    bbox, onehot, rs = _layout_batch(STEP_BATCH, 3, 10, seed=7)
    batch = {"image": rs.randint(0, 256, (STEP_BATCH, 64, 64, 1)).astype(
        np.uint8), "bbox": bbox, "label_onehot": onehot}
    rng = jax.random.PRNGKey(42)
    step = jax.jit(jmake_train_step(JCFG, jg, jd))
    new_jstate, metrics = step(jstate, jax.tree.map(jnp.asarray, batch), rng,
                               jnp.float32(LR), jnp.float32(LR))
    z, _ = _replay_step_noise(rng, 0, STEP_BATCH, JCFG.z_dim)
    state = create_state(cfg, device="cpu",
                         g_state_dict=state.g.state_dict(),
                         d_state_dict=state.d.state_dict())
    assert state.g.upsample1[2].groups == 2 and state.d.bn2.groups == 2
    pre_g = {k: v.clone() for k, v in state.g.state_dict().items()}
    pre_d = {k: v.clone() for k, v in state.d.state_dict().items()}
    got = make_train_step(cfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, None, LR,
        LR, z=torch.from_numpy(np.array(z)))
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


@pytest.fixture(scope="module")
def converted():
    """G and D state dicts converted from a JAX state."""
    _, jstate, _, _ = _randomized_states()
    return (stage1_g_state_dict_from_jax(jstate.g_params, jstate.g_stats,
                                         PCFG),
            stage1_d_state_dict_from_jax(jstate.d_params, jstate.d_stats))


@pytest.mark.parametrize("compute_dtype, groups", [
    (None, 1), (torch.bfloat16, 1), (None, 2), (torch.bfloat16, 2)],
    ids=["float32", "bf16", "groups-2", "bf16-groups-2"])
def test_weights_load_strict_under_every_setting(converted, compute_dtype,
                                                 groups):
    """bf16 and BatchNorm groups change no parameter tree: the converter's
    state dicts load with strict=True, and the models' keys, shapes and
    float32 dtypes are those of the default model."""
    sd_g, sd_d = converted
    cfg = dataclasses.replace(PCFG, compute_dtype=compute_dtype,
                              bn_groups=groups)
    for build, sd in ((build_stage1_g, sd_g), (build_stage1_d, sd_d)):
        model = build(cfg, sd, device="cpu")
        default = build(PCFG, device="cpu").state_dict()
        got = model.state_dict()
        assert list(got) == list(default)
        for k, v in got.items():
            assert v.shape == default[k].shape and v.dtype == default[k].dtype
            assert torch.equal(v, sd[k]), k
