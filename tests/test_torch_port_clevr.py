"""The port's CLEVR Stage 1 (multiple_objects_gan_tpu_torch: the label
embedding, the 4-object G and D, the clamped D condition, the step, the
synthetic set, the train entry and the service) against the JAX package,
on the CPU.

Every input is drawn from a numpy seed. Weights go across as the other
port tests carry them: ``stage1_*_state_dict_from_jax`` loaded with
strict=True, or the JAX package's importers for the step's weights. JAX
runs at "highest" matmul/conv precision and both sides compute in float32.
Tolerances are those of the Multi-MNIST port tests:

* forwards at gf/df 8 and batch 4: 2e-5 (SMALL_ATOL,
  tests/test_torch_port_stage1g.py); the train-mode image is held at 2e-5
  against the port run in float64 and at 1e-4 against JAX, with the port
  the nearer of the two to float64, as tests/test_torch_port_stage1d.py
  holds it (the JAX BatchNorm's E[x^2] - E[x]^2 variance loses digits);
* the label embedding's running statistics: 1e-6;
* one train step: losses atol 1e-3, BatchNorm statistics 5e-4, per
  tensor Adam-delta cosine > 0.999 (tests/test_torch_port_step.py);
* the trained full-width ``runs_r5/clevr_repin/netG_final.pth``: 2e-4
  (FULL_ATOL) at batch 2.

The helpers here take a family (JAX config, port config, batch maker) and
serve tests/test_torch_port_stackgan1.py as well.
"""

from __future__ import annotations

import argparse
import dataclasses
import http.client
import json
import os
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiple_objects_gan_tpu.data.datasets import (
    ClevrDataset, write_synthetic_clevr)
from multiple_objects_gan_tpu.io import torch_export as tx
from multiple_objects_gan_tpu.io import torch_import as ti
from multiple_objects_gan_tpu.io.pycompat import torch_load as jax_torch_load
from multiple_objects_gan_tpu.models import common as jcommon
from multiple_objects_gan_tpu.models.stage1 import (
    Stage1D as JStage1D, Stage1G as JStage1G)
from multiple_objects_gan_tpu.nn.pathways import LabelEmbed as JLabelEmbed
from multiple_objects_gan_tpu.train.step import (
    create_state as jcreate_state, make_sample_fn as jmake_sample_fn,
    make_train_step as jmake_train_step)
from multiple_objects_gan_tpu_torch.cli import main as port_main
from multiple_objects_gan_tpu_torch.cli import serve as port_serve
from multiple_objects_gan_tpu_torch.cli.serve import Stage1Service
from multiple_objects_gan_tpu_torch.config.config import (
    cfg_from_file, stage1_model_config, train_settings)
from multiple_objects_gan_tpu_torch.data.synthetic import synthetic_clevr
from multiple_objects_gan_tpu_torch.io.weights import (
    load_reference_g, stage1_d_state_dict_from_jax,
    stage1_g_state_dict_from_jax)
from multiple_objects_gan_tpu_torch.models import common
from multiple_objects_gan_tpu_torch.models.stage1 import (
    Stage1G, build_stage1_d, build_stage1_g)
from multiple_objects_gan_tpu_torch.nn.blocks import ObjectBatchNorm1d
from multiple_objects_gan_tpu_torch.nn.pathways import LabelEmbed
from multiple_objects_gan_tpu_torch.train.state import create_state
from multiple_objects_gan_tpu_torch.train.step import (
    make_sample_fn, make_train_step)
from test_step_parity import _replay_step_noise
from test_torch_parity import _randomize as _randomize_module
from test_torch_port_stage1g import _randomize

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
SMALL_ATOL = 2e-5
TRAIN_IMAGE_ATOL = 1e-4
FULL_ATOL = 2e-4
STATS_ATOL = 1e-6
LR = 2e-4
B = 4
JCFG = dataclasses.replace(jcommon.CLEVR, gf_dim=8, df_dim=8)
PCFG = dataclasses.replace(common.CLEVR, gf_dim=8, df_dim=8)
CKPT = os.path.join(ROOT, "runs_r5", "clevr_repin", "netG_final.pth")


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


def clevr_batch(seed: int, b: int = B) -> dict:
    """b items of the synthetic CLEVR set (2-4 objects, padded ones -1 with
    the pad one-hots), with the first box moved partly off the canvas, and
    z."""
    data = synthetic_clevr(b, seed=seed)
    data["bbox"][0, 0, 0] = -0.1
    data["z"] = np.random.RandomState(seed + 1).randn(
        b, PCFG.z_dim).astype(np.float32)
    return data


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


def jax_nets(jcfg, seed):
    """JAX Stage1G/Stage1D of ``jcfg`` (D with the unconditional head as
    well, so both heads are held), every weight and statistic drawn anew
    from ``seed``."""
    jcfg = dataclasses.replace(jcfg, use_uncond_head=True)
    jg, jd = JStage1G(jcfg), JStage1D(jcfg)
    st = jcreate_state(jcfg, jg, jd, jax.random.PRNGKey(0), batch_size=2)
    rng = np.random.RandomState(seed)
    g = (_randomize(jax.tree.map(np.asarray, st.g_params), rng, "params"),
         _randomize(jax.tree.map(np.asarray, st.g_stats), rng, "stats"))
    d = (_randomize(jax.tree.map(np.asarray, st.d_params), rng, "params"),
         _randomize(jax.tree.map(np.asarray, st.d_stats), rng, "stats"))
    return jg, jd, g, d


def _g_args(data, jcfg, eps=None, torch_dtype=None):
    """The generator's inputs as JAX arrays and as port tensors."""
    names = ["z", "bbox", "label_onehot"] + (
        ["text_embedding"] if jcfg.use_ca else [])
    jargs = [jnp.asarray(data[k]) for k in names]
    if not jcfg.use_ca:
        jargs.append(None)
    targs = [torch.from_numpy(np.asarray(data[k])) for k in names]
    if torch_dtype is not None:
        targs = [t if k == "bbox" else t.to(torch_dtype)
                 for k, t in zip(names, targs)]
    if eps is not None:
        targs.append(torch.from_numpy(np.array(eps)).to(
            torch_dtype or torch.float32))
    return jargs, targs


def check_eval_forward(jcfg, pcfg, nets, data):
    """The eval-mode image against the JAX package's make_sample_fn (CA:
    c = mu), at SMALL_ATOL."""
    jg, _, (p, s), _ = nets
    jargs, targs = _g_args(data, jcfg)
    want = np.asarray(jmake_sample_fn(jcfg, jg)(p, s, *jargs))
    port = build_stage1_g(pcfg, stage1_g_state_dict_from_jax(p, s, pcfg),
                          device="cpu")
    got = make_sample_fn(pcfg)(port, *targs)
    assert got.shape == (len(data["z"]), 3, 64, 64)
    _close(got.permute(0, 2, 3, 1), want, "eval image")


def check_train_forward(jcfg, pcfg, nets, data):
    """A train-mode G forward: the image (against float64 and JAX, as
    tests/test_torch_port_stage1d.py holds mnist's), mu and logvar under
    the CA net, and every running statistic after it, the label
    embedding's per-object ones included."""
    jg, _, (p, s), _ = nets
    ca_rng = eps = None
    if jcfg.use_ca:
        ca_rng = jax.random.PRNGKey(17)
        eps = np.asarray(jax.random.normal(
            ca_rng, (len(data["z"]), jcfg.condition_dim), jnp.float32))
    jargs, targs = _g_args(data, jcfg, eps)
    out, new = jg.apply({"params": p, "batch_stats": s}, *jargs, train=True,
                        ca_rng=ca_rng, mutable=["batch_stats"])
    sd = stage1_g_state_dict_from_jax(p, s, pcfg)
    port = build_stage1_g(pcfg, sd, device="cpu").train()
    assert isinstance(port.label[1], ObjectBatchNorm1d)
    got = port.outputs(*targs)
    _, targs64 = _g_args(data, jcfg, eps, torch.float64)
    exact = build_stage1_g(pcfg, sd, device="cpu").train().double().outputs(
        *targs64).img.detach()
    want = np.transpose(np.asarray(out["img"]), (0, 3, 1, 2))
    img = got.img.detach()
    _close(img, exact.float().numpy(), "image against float64")
    _close(img, want, "image against JAX", atol=TRAIN_IMAGE_ATOL)
    assert float((img.double() - exact).abs().max()) < float(
        np.abs(want - exact.numpy()).max())
    if jcfg.use_ca:
        _close(got.mu, out["mu"], "mu")
        _close(got.logvar, out["logvar"], "logvar")
    else:
        assert got.mu is None and out["mu"] is None
    want_sd = stage1_g_state_dict_from_jax(
        p, jax.tree.map(np.asarray, new["batch_stats"]), pcfg)
    _stats_close(port.state_dict(), want_sd, "G")


def check_d_forward(jcfg, pcfg, nets, data, cond, train):
    """D's features and both heads on them (the conditional one with the
    family's condition), and after a train forward every running
    statistic. In train mode the features and logits are held at
    SMALL_ATOL against the port run in float64 and at TRAIN_IMAGE_ATOL
    against JAX, with the port the nearer to float64, as the train-mode
    image (the JAX BatchNorm's variance loses digits on these images,
    whose channel means are large against their spread)."""
    _, jd, _, (p, s) = nets
    pcfg = dataclasses.replace(pcfg, use_uncond_head=True)
    sd = stage1_d_state_dict_from_jax(p, s)
    image = (data["image"].astype(np.float32) / 127.5 - 1.0)
    jargs = (jnp.asarray(image), jnp.asarray(data["label_onehot"]),
             jnp.asarray(data["bbox"]))
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

    def run(dtype):
        port = build_stage1_d(pcfg, sd, device="cpu").train(train).to(dtype)
        h = port(_nchw(image).to(dtype),
                 torch.from_numpy(data["label_onehot"]).to(dtype),
                 torch.from_numpy(data["bbox"]))
        c = torch.from_numpy(np.asarray(cond)).to(dtype)
        return port, {"features": h.detach(),
                      "cond logits": port.cond_logits(h, c).detach(),
                      "uncond logits": port.uncond_logits(h).detach()}

    port, got = run(torch.float32)
    assert got["features"].shape == (len(image), 8 * pcfg.df_dim, 4, 4)
    assert port.local[0].in_channels == 3 + pcfg.label_dim
    if not train:
        for k in want:
            _close(got[k], want[k], k)
        return
    _, exact = run(torch.float64)
    for k in want:
        _close(got[k], exact[k].float().numpy(), f"{k} against float64")
        _close(got[k], want[k], f"{k} against JAX", atol=TRAIN_IMAGE_ATOL)
    err_port = float((got["features"].double() - exact["features"]).abs()
                     .max())
    err_jax = float(np.abs(want["features"] - exact["features"].numpy())
                    .max())
    assert err_port < err_jax, (err_port, err_jax)
    stats = {**s, **jax.tree.map(np.asarray, new2["batch_stats"])}
    want_sd = stage1_d_state_dict_from_jax(p, stats)
    sd_now = port.state_dict()
    for k in ("local.1", "bn2", "bn3", "bn4", "get_cond_logits.outlogits.1"):
        _close(sd_now[f"{k}.running_mean"], want_sd[f"{k}.running_mean"], k)
        _close(sd_now[f"{k}.running_var"], want_sd[f"{k}.running_var"], k,
               rtol=SMALL_ATOL)


def check_label_embed_statistics(in_dim, features, o):
    """One train forward of the label embedding: outputs and running
    statistics against JAX ``LabelEmbed`` at STATS_ATOL. The objects are
    drawn with different means, so statistics pooled over B * O (what the
    JAX docstring says) move the running mean elsewhere: the test would
    fail a pooled BatchNorm."""
    rng = np.random.RandomState(in_dim)
    b = 6
    x = (rng.randn(b, o, in_dim) + np.arange(o)[None, :, None]).astype(
        np.float32)
    jmod = JLabelEmbed(features)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    params = _randomize(jax.tree.map(np.asarray, variables["params"]), rng,
                        "params")
    stats = _randomize(jax.tree.map(np.asarray, variables["batch_stats"]),
                       rng, "stats")
    want, new = jmod.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(x), True, mutable=["batch_stats"])
    new = jax.tree.map(np.asarray, new["batch_stats"]["TorchBatchNorm_0"])
    port = LabelEmbed(in_dim, features, o)
    bn = params["TorchBatchNorm_0"]
    st = stats["TorchBatchNorm_0"]
    port.load_state_dict({
        "0.weight": torch.from_numpy(params["Dense_0"]["Dense_0"]["kernel"].T
                                     .copy()),
        "1.weight": torch.from_numpy(bn["scale"]),
        "1.bias": torch.from_numpy(bn["bias"]),
        "1.running_mean": torch.from_numpy(st["mean"]),
        "1.running_var": torch.from_numpy(st["var"]),
        "1.num_batches_tracked": torch.tensor(0)}, strict=True)
    pooled = torch.nn.BatchNorm1d(features)
    pooled.load_state_dict(port[1].state_dict())
    port.train()
    got = port(torch.from_numpy(x))
    # the JAX BatchNorm's E[x^2] - E[x]^2 variance costs digits on these
    # offset objects: held relative as well, as a running variance is
    _close(got, want, "embedded labels", rtol=SMALL_ATOL)
    _close(port[1].running_mean, new["mean"], "running_mean",
           atol=STATS_ATOL)
    _close(port[1].running_var, new["var"], "running_var", atol=STATS_ATOL,
           rtol=STATS_ATOL)
    assert int(port[1].num_batches_tracked) == o
    # pooled statistics over B * O would be another result
    pooled.train()(port[0](torch.from_numpy(x).reshape(b * o, in_dim)))
    gap = float((pooled.running_mean - port[1].running_mean).abs().max())
    assert gap > 100 * STATS_ATOL, gap


def port_and_jax_states(jcfg, pcfg, seed_g, seed_d):
    """The port's state with the weights tests/test_step_parity.py draws
    (every parameter N(0, 0.05), BatchNorm away from its init), and a JAX
    state holding the same weights through the JAX package's importers."""
    state = create_state(pcfg, device="cpu")
    _randomize_module(state.g, seed=seed_g)
    _randomize_module(state.d, seed=seed_d)
    sd_g = {k: v.numpy().copy() for k, v in state.g.state_dict().items()}
    sd_d = {k: v.numpy().copy() for k, v in state.d.state_dict().items()}
    g_params, g_stats = ti.import_stage1_g({"netG": sd_g}, jcfg)
    d_params, d_stats = ti.import_stage1_d(sd_d, jcfg)
    jg, jd = JStage1G(jcfg), JStage1D(jcfg)
    jstate = jcreate_state(jcfg, jg, jd, jax.random.PRNGKey(0), batch_size=2)
    jstate = jstate.replace(g_params=g_params, g_stats=g_stats,
                            d_params=d_params, d_stats=d_stats)
    return state, jstate, jg, jd


def _compare_deltas(pre, post_port, post_jax, what):
    """tests/test_torch_port_step.py:_compare_deltas."""
    for k in pre:
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        dp = (post_port[k] - pre[k]).numpy().ravel()
        dj = (post_jax[k] - pre[k]).numpy().ravel()
        norm = float(np.linalg.norm(dp) * np.linalg.norm(dj))
        if norm == 0.0:
            np.testing.assert_allclose(dj, dp, atol=1e-7,
                                       err_msg=f"{what}:{k}")
            continue
        cos = float(np.dot(dp, dj) / norm)
        diff = np.abs(dp - dj) / LR
        assert cos > 0.999, f"{what}:{k} delta cosine {cos}"
        assert float(diff.mean()) < 0.02, f"{what}:{k} mean delta diff"
        assert float((diff > 0.5).mean()) <= 0.005, f"{what}:{k} flips"


def check_one_step(jcfg, pcfg, batch, seeds, kl_coeff=2.0):
    """One port step against one jitted JAX ``make_train_step`` from the
    same weights, batch, z and (CA) eps: losses, statistics, deltas."""
    state, jstate, jg, jd = port_and_jax_states(jcfg, pcfg, *seeds)
    rng = jax.random.PRNGKey(42)
    step = jax.jit(jmake_train_step(jcfg, jg, jd, kl_coeff=kl_coeff))
    new_jstate, metrics = step(jstate, jax.tree.map(jnp.asarray, batch), rng,
                               jnp.float32(LR), jnp.float32(LR))
    z, rng_ca = _replay_step_noise(rng, 0, len(batch["image"]), jcfg.z_dim)
    eps = None
    if jcfg.use_ca:
        eps = torch.from_numpy(np.array(jax.random.normal(
            rng_ca, (len(z), jcfg.condition_dim), jnp.float32)))
    pre_g = {k: v.clone() for k, v in state.g.state_dict().items()}
    pre_d = {k: v.clone() for k, v in state.d.state_dict().items()}
    got = make_train_step(pcfg, kl_coeff)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, None, LR,
        LR, z=torch.from_numpy(np.array(z)), eps=eps)
    assert sorted(got) == sorted(metrics)
    assert ("kl_loss" in got) == jcfg.use_ca
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   atol=1e-3, err_msg=f"loss {k}")
    want_g = stage1_g_state_dict_from_jax(new_jstate.g_params,
                                          new_jstate.g_stats, pcfg)
    want_d = stage1_d_state_dict_from_jax(new_jstate.d_params,
                                          new_jstate.d_stats)
    post_g, post_d = state.g.state_dict(), state.d.state_dict()
    _stats_close(post_g, want_g, "g_stats", atol=5e-4)
    _stats_close(post_d, want_d, "d_stats", atol=5e-4)
    _compare_deltas(pre_g, post_g, want_g, "G")
    _compare_deltas(pre_d, post_d, want_d, "D")
    return got


def check_trained_checkpoint(path, variant, cfg_file, n_params, data):
    """A trained full-width reference .pth through the JAX importer and
    make_sample_fn, and through the port loaded strict=True, batch 2."""
    mcfg = stage1_model_config(cfg_from_file(os.path.join(ROOT, cfg_file),
                                             variant), variant)
    jcfg = dataclasses.replace(
        {"clevr": jcommon.CLEVR, "coco-stackgan-1": jcommon.COCO_S1}[variant],
        gf_dim=mcfg.gf_dim, df_dim=mcfg.df_dim,
        condition_dim=mcfg.condition_dim, d_cond_dim=mcfg.d_cond_dim)
    params, stats = ti.import_stage1_g(jax_torch_load(path), jcfg)
    jargs, targs = _g_args(data, jcfg)
    want = np.asarray(jmake_sample_fn(jcfg, JStage1G(jcfg))(
        params, stats, *jargs))
    port = build_stage1_g(mcfg, load_reference_g(path), device="cpu")
    assert sum(p.numel() for p in port.parameters()) == n_params
    got = make_sample_fn(mcfg)(port, *targs)
    _close(got.permute(0, 2, 3, 1), want, "trained image", atol=FULL_ATOL)


def tiny_cfg(tmp_path, variant, batch=8):
    """The variant's published train cfg with GF/DF 8 and the batch cut."""
    src = {"clevr": "clevr_train.yml",
           "coco-stackgan-1": "coco_s1_train.yml"}[variant]
    with open(os.path.join(ROOT, "cfg", src)) as f:
        text = f.read()
    text = (text.replace("BATCH_SIZE: 128", f"BATCH_SIZE: {batch}")
            .replace("DF_DIM: 48", "DF_DIM: 8").replace("GF_DIM: 96",
                                                        "GF_DIM: 8")
            .replace("DF_DIM: 96", "DF_DIM: 8").replace("GF_DIM: 192",
                                                        "GF_DIM: 8"))
    path = tmp_path / src
    path.write_text(text)
    return str(path)


def check_cli_epoch(tmp_path, variant, steps, flags=()):
    """cli/main.py, one synthetic epoch on the CPU at GF/DF 8, batch 8."""
    cfg = tiny_cfg(tmp_path, variant)
    mcfg = stage1_model_config(cfg_from_file(cfg, variant), variant)
    assert (mcfg.gf_dim, mcfg.df_dim) == (8, 8)
    hist = port_main.main(["--variant", variant, "--cfg", cfg, "--synthetic",
                           "--max_epochs", "1", "--manualSeed", "3",
                           "--device", "cpu", "--data_dir",
                           str(tmp_path / "data"), "--img_dir",
                           str(tmp_path / "imgs"), "--output_dir",
                           str(tmp_path / "out"), *flags])
    assert len(hist) == 1 and hist[0]["steps"] == steps
    for k in ("d_loss", "d_loss_real", "d_loss_wrong", "d_loss_fake",
              "g_loss", "g_loss_total"):
        assert np.isfinite(hist[0][k]) and hist[0][k] > 0, k
    return hist[0]


# ------------------------------------------------------------ the service


class Server:
    """A family's service over HTTP on the CPU, at GF/DF 8."""

    def __init__(self, variant, mcfg):
        self.svc = Stage1Service(mcfg, seed=3, device="cpu")
        args = argparse.Namespace(variant=variant, host="127.0.0.1", port=0,
                                  max_wait_ms=5.0)
        self.httpd = port_serve.serve(args, self.svc)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def post(self, items):
        conn = http.client.HTTPConnection(
            "127.0.0.1", self.httpd.server_address[1], timeout=60)
        try:
            conn.request("POST", "/generate", body=json.dumps(
                {"items": items}))
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.httpd.batcher.close()
        self.thread.join(timeout=10)


# ================================================================== tests


@pytest.fixture(scope="module")
def nets():
    return jax_nets(JCFG, 4)


def test_eval_forward_matches_jax_sample_fn(nets):
    check_eval_forward(JCFG, PCFG, nets, clevr_batch(5))


def test_train_forward_matches_jax(nets):
    check_train_forward(JCFG, PCFG, nets, clevr_batch(6))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_discriminator_and_both_heads_match_jax(nets, train):
    """D on 4 objects with the raw one-hots (3 + 13 input channels), its
    conditional head on the clamped label sum (pad one-hots included)."""
    data = clevr_batch(7)
    cond = np.maximum(data["label_onehot"].sum(1), 0.0)
    assert (cond[:, 3] > 0).any()         # a padded object's one-hot counts
    check_d_forward(JCFG, PCFG, nets, data, cond, train)


def test_label_embed_running_statistics_are_per_object():
    check_label_embed_statistics(13, 16, 4)


def test_g_state_dict_routes_agree_and_load_strict(nets):
    """The JAX package's export_stage1_g and the port's mapping give the
    same keys and values (``label.*`` the live embedding), and the port
    loads them strict=True."""
    _, _, (p, s), _ = nets
    direct = stage1_g_state_dict_from_jax(p, s, PCFG)
    exported = {k: torch.as_tensor(np.array(v))
                for k, v in tx.export_stage1_g(p, s, JCFG).items()}
    assert sorted(direct) == sorted(exported)
    assert direct["label.0.weight"].shape == (16, 13)
    for k in direct:
        np.testing.assert_array_equal(
            direct[k].numpy(), exported[k].numpy().reshape(direct[k].shape),
            err_msg=k)
    Stage1G(PCFG).load_state_dict(exported, strict=True)


def test_one_step_matches_jax_make_train_step():
    data = synthetic_clevr(B, seed=8)
    check_one_step(JCFG, PCFG, data, (3, 11))


def test_trained_fullwidth_checkpoint_matches_jax():
    """runs_r5/clevr_repin/netG_final.pth (ngf 768, 5.77 M parameters)."""
    data = clevr_batch(9, b=2)
    check_trained_checkpoint(CKPT, "clevr", "cfg/clevr_train.yml", 5_767_188,
                             data)


def test_synthetic_clevr_equals_what_the_jax_writer_writes(tmp_path):
    """The images, boxes and one-hots ClevrDataset reads back from the JAX
    writer's files (without its h-flip), padded objects included."""
    write_synthetic_clevr(str(tmp_path), n=24, split="train", seed=5)
    ds = ClevrDataset(str(tmp_path), split="train", hflip=False)
    got = synthetic_clevr(24, seed=5)
    assert got["image"].shape == (24, 64, 64, 3)
    assert got["label_onehot"].shape == (24, 4, 13)
    for i in range(24):
        item = ds[i]
        np.testing.assert_array_equal(got["image"][i], item["image"])
        np.testing.assert_array_equal(got["bbox"][i], item["bbox"])
        np.testing.assert_array_equal(got["label_onehot"][i],
                                      item["label_onehot"])
    n_obj = (got["bbox"][:, :, 0] >= 0).sum(1)
    assert n_obj.min() == 2 and n_obj.max() == 4


def test_config_reads_the_published_clevr_widths():
    cfg = cfg_from_file(os.path.join(ROOT, "cfg", "clevr_train.yml"), "clevr")
    mcfg = stage1_model_config(cfg, "clevr", compute_dtype=torch.bfloat16,
                               bn_groups=2)
    assert (mcfg.ngf, mcfg.df_dim, mcfg.condition_dim, mcfg.num_objects,
            mcfg.label_dim, mcfg.d_cond_dim) == (768, 48, 16, 4, 13, 13)
    assert mcfg.use_label_embed and not mcfg.use_ca
    assert (mcfg.compute_dtype, mcfg.bn_groups) == (torch.bfloat16, 2)
    train = train_settings(cfg)
    assert (train.batch_size, train.max_epoch, train.lr_decay_epoch,
            train.kl_coeff) == (128, 40, 10, 0.0)


@pytest.mark.parametrize("flags", [(), ("--bf16",)], ids=["f32", "bf16"])
def test_cli_main_trains_one_synthetic_clevr_epoch(tmp_path, capsys, flags):
    hist = check_cli_epoch(tmp_path, "clevr", 256 // 8, flags)
    assert "kl_loss" not in hist
    out = capsys.readouterr().out
    assert "clevr stage 1 on cpu: ngf 64, ndf 8, 4 objects" in out


def test_cli_entries_refuse_clevr_without_a_card(tmp_path, monkeypatch):
    cfg = tiny_cfg(tmp_path, "clevr")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main.main(["--variant", "clevr", "--cfg", cfg, "--synthetic"])
    args = port_serve.parse_args(["--variant", "clevr", "--cfg", cfg])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.build_service(args)


@pytest.fixture(scope="module")
def server():
    srv = Server("clevr", PCFG)
    yield srv
    srv.close()


def _two_hot(shape, color):
    row = [0.0] * 13
    row[shape], row[4 + color] = 1.0, 1.0
    return row


def test_service_takes_clevr_two_hot_rows_on_four_objects(server):
    boxes = [[0.05, 0.05, 0.3, 0.3], [0.6, 0.05, 0.3, 0.3],
             [0.05, 0.6, 0.3, 0.3], [0.6, 0.6, 0.3, 0.3]]
    item = {"labels": [_two_hot(k % 3, k) for k in range(4)],
            "bboxes": boxes}
    status, body = server.post([item, {}])
    assert status == 200 and len(body["images"]) == 2, body
    labels, bbox = port_serve._item_layout(item, 4, 13,
                                           np.random.RandomState(0))
    np.testing.assert_array_equal(labels, np.array(item["labels"]))
    np.testing.assert_array_equal(bbox, np.array(boxes, np.float32))


@pytest.mark.parametrize("item, message", [
    ({"labels": [[1.0] * 12], "bboxes": [[0.1, 0.1, 0.3, 0.3]]}, "13-d"),
    ({"labels": [1] * 5, "bboxes": [[0.1, 0.1, 0.3, 0.3]] * 5}, "at most 4"),
    ({"labels": [1], "bboxes": [[0.1, 0.1, 0.0, 0.3]]}, "w, h > 0"),
    ({"labels": [13], "bboxes": [[0.1, 0.1, 0.3, 0.3]]}, "outside"),
    ({"labels": [-1], "bboxes": [[0.1, 0.1, 0.3, 0.3]]}, "outside"),
], ids=["short-row", "five-objects", "F2-zero-width", "F3-id-13",
        "F3-id-minus-1"])
def test_service_rejects_bad_clevr_items(server, item, message):
    status, body = server.post([item])
    assert status == 400 and message in body["error"], body
