"""The port's Stage-1 discriminator and the train-mode generator
(multiple_objects_gan_tpu_torch) against the JAX package, at gf_dim and
df_dim 8, with weights carried across by ``stage1_*_state_dict_from_jax``
and loaded with strict=True.

JAX runs at "highest" matmul/conv precision and both sides compute in
float32 on the CPU. Tolerance 2e-5, as tests/test_torch_port_stage1g.py
uses at this width, on outputs and on the running statistics (rtol 2e-5
besides for a running variance, which grows with the activations' scale).

One exception, the train-mode generator image: there the JAX package's
float32 result strays from the same network evaluated in float64 by more
than 2e-5 (its train-mode BatchNorm takes the variance as
E[x^2] - E[x]^2, which loses digits when a channel's mean is large
against its spread; five BatchNorms in a row over batches of 4), while
the port stays well inside it. So the image is held at 2e-5 against the
port run in float64, against JAX at 1e-4 (TRAIN_IMAGE_ATOL), and the test
checks that the port is the nearer of the two to float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiple_objects_gan_tpu.io import torch_export as tx
from multiple_objects_gan_tpu.models import common as jcommon
from multiple_objects_gan_tpu.models.stage1 import (
    Stage1D as JStage1D, Stage1G as JStage1G)
from multiple_objects_gan_tpu.nn.blocks import TorchBatchNorm, object_fold
from multiple_objects_gan_tpu.nn.pathways import (
    DGetLogits as JDGetLogits, ObjectPathwayD as JObjectPathwayD)
from multiple_objects_gan_tpu.train.step import create_state as jcreate_state
from multiple_objects_gan_tpu_torch.io.weights import (
    stage1_d_state_dict_from_jax, stage1_g_state_dict_from_jax)
from multiple_objects_gan_tpu_torch.models import common
from multiple_objects_gan_tpu_torch.models.stage1 import (
    Stage1D, build_stage1_d, build_stage1_g)
from multiple_objects_gan_tpu_torch.nn.blocks import ObjectBatchNorm2d
from test_torch_port_stage1g import _layout, _randomize

ATOL = 2e-5
TRAIN_IMAGE_ATOL = 1e-4
JCFG = dataclasses.replace(jcommon.MNIST, gf_dim=8, df_dim=8,
                           use_uncond_head=True)
PCFG = dataclasses.replace(common.MNIST, gf_dim=8, df_dim=8,
                           use_uncond_head=True)
B = 4


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


def _close(got: torch.Tensor, want, what: str, rtol: float = 0.0) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=rtol, err_msg=what)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(x), (0, 3, 1, 2))))


def _stats_close(port_sd: dict, want_sd: dict, what: str) -> None:
    keys = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        _close(port_sd[k], want_sd[k], f"{what}:{k}", rtol=ATOL)


@pytest.fixture(scope="module")
def nets():
    """JAX Stage1G/Stage1D at width 8 (D with the unconditional head too),
    every weight and statistic randomized, and the inputs of one batch."""
    jg, jd = JStage1G(JCFG), JStage1D(JCFG)
    st = jcreate_state(JCFG, jg, jd, jax.random.PRNGKey(0), batch_size=2)
    rng = np.random.RandomState(4)
    g = (_randomize(jax.tree.map(np.asarray, st.g_params), rng, "params"),
         _randomize(jax.tree.map(np.asarray, st.g_stats), rng, "stats"))
    d = (_randomize(jax.tree.map(np.asarray, st.d_params), rng, "params"),
         _randomize(jax.tree.map(np.asarray, st.d_stats), rng, "stats"))
    z, bbox, labels = _layout(5, B, JCFG)
    image = rng.uniform(-1, 1, (B, 64, 64, 1)).astype(np.float32)
    return jg, jd, g, d, (z, bbox, labels, image)


def _port_d(d):
    return build_stage1_d(PCFG, stage1_d_state_dict_from_jax(*d),
                          device="cpu")


# ------------------------------------------------------- object-fold BN


def test_object_batchnorm_matches_jax_object_fold():
    """Outputs and running statistics after one and two train forwards on
    a folded (B * 3) batch, against TorchBatchNorm under object_fold(3)."""
    rng = np.random.RandomState(0)
    c = 6
    x1, x2 = (rng.randn(5 * 3, 4, 4, c).astype(np.float32) * 2 + 0.5
              for _ in range(2))
    bn = TorchBatchNorm()
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x1), train=False)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.normal(0, 0.2, c).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.2, c).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    assert set(variables["params"]) == set(params)
    port = ObjectBatchNorm2d(c, 3)
    port.load_state_dict({
        "weight": torch.from_numpy(params["scale"]),
        "bias": torch.from_numpy(params["bias"]),
        "running_mean": torch.from_numpy(stats["mean"]),
        "running_var": torch.from_numpy(stats["var"]),
        "num_batches_tracked": torch.tensor(0)})
    port.train()
    for x in (x1, x2):
        with object_fold(3):
            y, new = bn.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        stats = jax.tree.map(np.asarray, new["batch_stats"])
        got = port(_nchw(x))
        _close(got, np.transpose(np.asarray(y), (0, 3, 1, 2)), "output")
        _close(port.running_mean, stats["mean"], "running_mean")
        _close(port.running_var, stats["var"], "running_var", rtol=ATOL)
    assert int(port.num_batches_tracked) == 6    # 3 objects x 2 forwards
    port.eval()
    y = bn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x1),
                 train=False)
    _close(port(_nchw(x1)), np.transpose(np.asarray(y), (0, 3, 1, 2)),
           "eval output")


def test_object_batchnorm_refuses_a_batch_the_objects_do_not_divide():
    bn = ObjectBatchNorm2d(4, 3).train()
    with pytest.raises(ValueError, match="do not divide"):
        bn(torch.randn(7, 4, 2, 2))


# ---------------------------------------------------------- discriminator


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_object_pathway_d_matches_jax(nets, train):
    _, _, _, (p, s), (_, bbox, labels, image) = nets
    port = _port_d((p, s)).train(train)
    out = JObjectPathwayD(PCFG.df_dim).apply(
        {"params": p["local"], "batch_stats": s["local"]},
        jnp.asarray(image), jnp.asarray(labels), jnp.asarray(bbox), train,
        mutable=["batch_stats"])
    want, new = out
    got = port.local(_nchw(image), torch.from_numpy(labels),
                     torch.from_numpy(bbox))
    assert got.shape == (B, 2 * PCFG.df_dim, 16, 16)
    _close(got, np.transpose(np.asarray(want), (0, 3, 1, 2)), "local")
    ns = new["batch_stats"]["TorchBatchNorm_0"]
    _close(port.local[1].running_mean, ns["mean"], "local.1 mean")
    _close(port.local[1].running_var, ns["var"], "local.1 var", rtol=ATOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("head", ["cond", "uncond"])
def test_d_get_logits_matches_jax(nets, train, head):
    _, _, _, (p, s), (_, _, labels, _) = nets
    port = _port_d((p, s)).train(train)
    rng = np.random.RandomState(6)
    h = rng.randn(B, 4, 4, 8 * PCFG.df_dim).astype(np.float32)
    cond = labels.sum(1)
    name = f"get_{head}_logits"
    jhead = JDGetLogits(PCFG.df_dim, bcondition=head == "cond")
    args = (jnp.asarray(h), jnp.asarray(cond) if head == "cond" else None)
    want, _ = jhead.apply({"params": p[name], "batch_stats": s.get(name, {})},
                          *args, train=train, mutable=["batch_stats"])
    module = getattr(port, name)
    got = module(_nchw(h), torch.from_numpy(cond) if head == "cond" else None)
    assert got.shape == (B,)
    _close(got, want, name)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_stage1d_matches_jax(nets, train):
    """Features, both heads on them, and (train) every running statistic
    after the forward."""
    _, jd, _, (p, s), (_, bbox, labels, image) = nets
    port = _port_d((p, s)).train(train)
    jargs = (jnp.asarray(image), jnp.asarray(labels), jnp.asarray(bbox))
    feat, new = jd.apply({"params": p, "batch_stats": s}, *jargs,
                         train=train, mutable=["batch_stats"])
    cond = labels.sum(1)
    logits, _ = jd.apply({"params": p, **new}, feat, jnp.asarray(cond),
                         train=train, method="cond_logits",
                         mutable=["batch_stats"])
    ulogits, _ = jd.apply({"params": p, **new}, feat, train=train,
                          method="uncond_logits", mutable=["batch_stats"])
    got = port(_nchw(image), torch.from_numpy(labels), torch.from_numpy(bbox))
    assert got.shape == (B, 8 * PCFG.df_dim, 4, 4)
    _close(got, np.transpose(np.asarray(feat), (0, 3, 1, 2)), "features")
    _close(port.cond_logits(got, torch.from_numpy(cond)), logits, "cond")
    _close(port.uncond_logits(got), ulogits, "uncond")
    if train:
        want_sd = stage1_d_state_dict_from_jax(
            p, {**s, **jax.tree.map(np.asarray, new["batch_stats"])})
        sd = port.state_dict()
        for k in ("local.1", "bn2", "bn3", "bn4"):
            _close(sd[f"{k}.running_mean"], want_sd[f"{k}.running_mean"], k)
            _close(sd[f"{k}.running_var"], want_sd[f"{k}.running_var"], k,
                   rtol=ATOL)


@pytest.mark.parametrize("uncond", [False, True], ids=["mnist", "uncond"])
def test_d_state_dict_routes_agree_and_load_strict(nets, uncond):
    """The JAX package's export_stage1_d and the port's own mapping give
    the same keys and values, and both load into Stage1D strict=True."""
    _, _, _, (p, s), _ = nets
    if not uncond:
        p = {k: v for k, v in p.items() if k != "get_uncond_logits"}
    cfg = dataclasses.replace(PCFG, use_uncond_head=uncond)
    direct = stage1_d_state_dict_from_jax(p, s)
    exported = {k: torch.as_tensor(np.array(v))
                for k, v in tx.export_stage1_d(p, s).items()}
    assert sorted(direct) == sorted(exported)
    for k in direct:
        np.testing.assert_array_equal(
            direct[k].numpy(), exported[k].numpy().reshape(direct[k].shape),
            err_msg=k)
    Stage1D(cfg).load_state_dict(direct, strict=True)
    Stage1D(cfg).load_state_dict(exported, strict=True)


# ------------------------------------------------------ generator, train


def test_stage1g_train_forward_matches_jax(nets):
    """A train-mode forward: the image, and the running statistics of every
    BatchNorm after it, the object pathway's per-object ones included."""
    jg, _, (p, s), _, (z, bbox, labels, _) = nets
    out, new = jg.apply({"params": p, "batch_stats": s}, jnp.asarray(z),
                        jnp.asarray(bbox), jnp.asarray(labels), None,
                        train=True, mutable=["batch_stats"])
    port = build_stage1_g(PCFG, stage1_g_state_dict_from_jax(p, s, PCFG),
                          device="cpu").train()
    assert isinstance(port.local1[2], ObjectBatchNorm2d)
    assert not isinstance(port.upsample1[2], ObjectBatchNorm2d)
    args = (torch.from_numpy(z), torch.from_numpy(bbox),
            torch.from_numpy(labels))
    got = port(*args).detach()
    exact = build_stage1_g(PCFG, stage1_g_state_dict_from_jax(p, s, PCFG),
                           device="cpu").train().double()(
        args[0].double(), args[1], args[2].double()).detach()
    want = np.transpose(np.asarray(out["img"]), (0, 3, 1, 2))
    _close(got, exact.float(), "image against float64")
    np.testing.assert_allclose(got.numpy(), want, atol=TRAIN_IMAGE_ATOL,
                               err_msg="image vs JAX")
    # the port is the nearer of the two to the float64 evaluation
    err_port = float((got.double() - exact).abs().max())
    err_jax = float(np.abs(want - exact.numpy()).max())
    assert err_port < err_jax, (err_port, err_jax)
    want_sd = stage1_g_state_dict_from_jax(
        p, jax.tree.map(np.asarray, new["batch_stats"]), PCFG)
    _stats_close(port.state_dict(), want_sd, "G")
