"""The port's export tool (multiple_objects_gan_tpu_torch/tools/
export_model.py) and the operators it exports, against the JAX package's
tools/export_model.py.

* ``mog::stn_place_multi`` and ``mog::stn_place_multi_grad`` pass
  ``torch.library.opcheck`` (schema, fake implementation, autograd
  registration, a traced forward and backward) in float32 and bf16, at
  16x16 and 15x15 inputs, with a padded (-1) box.
* For mnist, clevr and coco-stackgan at gf 8 / df 4: JAX's ``jax.export``
  StableHLO blob, deserialized and called, against the port's ``.pt2``,
  saved, loaded and called, from the same weights
  (``io/weights.py:stage1_g_state_dict_from_jax``) and the same numpy
  inputs. atol 2e-5 on images in [-1, 1], as
  tests/test_torch_port_stage1g.py holds the eager G at this width (JAX at
  "highest" precision, both sides float32 on the CPU). The program equals
  the eager port G bit for bit and its graph holds one
  ``mog.stn_place_multi`` and none of the plain K1's einsums.
* The tool's ``main``: a missing ``--net_g`` exits non-zero; the trained
  runs_r5/mnist_repin/netG_final.pth exports at batch 1 on the CPU and
  completes the round trip.
* A gradient through the operator equals ``stn_place_multi_grad_plain``,
  and FlopCounterMode counts each operator as its plain version's einsums.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import export as jexport
from torch.utils.flop_counter import FlopCounterMode

from multiple_objects_gan_tpu.models import common as jcommon
from multiple_objects_gan_tpu.models.stage1 import Stage1G as JStage1G
from multiple_objects_gan_tpu_torch.io.weights import (
    stage1_g_state_dict_from_jax)
from multiple_objects_gan_tpu_torch.ops import stn_place_cuda
from multiple_objects_gan_tpu_torch.tools import export_model as em
from test_torch_port_stage1g import _randomize

SMALL_ATOL = 2e-5
CKPT = os.path.join(os.path.dirname(__file__), os.pardir, "runs_r5",
                    "mnist_repin", "netG_final.pth")
BATCH = 3
JAX_CFGS = {"mnist": jcommon.MNIST, "clevr": jcommon.CLEVR,
            "coco-stackgan": jcommon.COCO_S1}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _small(cfg):
    return dataclasses.replace(cfg, gf_dim=8, df_dim=4)


def _boxes(rs, b, o):
    wh = rs.uniform(0.2, 0.4, (b, o, 2))
    bbox = np.concatenate([rs.uniform(0, 1, (b, o, 2)) * (1 - wh), wh], -1)
    bbox = bbox.astype(np.float32)
    bbox[-1, -1] = -1.0
    return torch.from_numpy(bbox)


# ------------------------------------------------------------- the operators


@pytest.mark.parametrize("op", ["place", "grad"])
@pytest.mark.parametrize("in_hw", [(16, 16), (15, 15)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_opcheck(op, in_hw, dtype):
    rs = np.random.RandomState(in_hw[0])
    bbox = _boxes(rs, 2, 3)
    if op == "place":
        x = torch.from_numpy(rs.randn(2, 3, 4, *in_hw).astype(np.float32))
        args = (x.to(dtype).requires_grad_(True), bbox, [16, 16])
        target = stn_place_cuda.PLACE_OP
    else:
        g = torch.from_numpy(rs.uniform(-1, 1, (2, 4, 16, 16)).astype(
            np.float32))
        args = (g.to(dtype).requires_grad_(True), bbox, list(in_hw))
        target = stn_place_cuda.GRAD_OP
    torch.library.opcheck(target, args)


@pytest.mark.parametrize("in_hw", [(16, 16), (15, 15)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gradient_through_the_operator_is_the_plain_k2(in_hw, dtype):
    rs = np.random.RandomState(4)
    bbox = _boxes(rs, 2, 3).requires_grad_(True)
    x = torch.from_numpy(rs.randn(2, 3, 5, *in_hw).astype(np.float32))
    x = x.to(dtype).requires_grad_(True)
    g = torch.from_numpy(rs.uniform(-1, 1, (2, 5, 16, 16)).astype(
        np.float32)).to(dtype)
    out = stn_place_cuda.PLACE_OP(x, bbox, [16, 16])
    assert out.dtype == dtype and out.grad_fn is not None
    out.backward(g)
    assert bbox.grad is None
    want = stn_place_cuda.stn_place_multi_grad_plain(g, bbox.detach(), in_hw)
    assert x.grad.dtype == dtype
    torch.testing.assert_close(x.grad, want, atol=0, rtol=0)


@pytest.mark.parametrize("op", ["place", "grad"])
def test_flop_counter_counts_the_operators_as_their_plain_versions(op):
    rs = np.random.RandomState(5)
    bbox = _boxes(rs, 2, 3)
    if op == "place":
        x, hw = torch.randn(2, 3, 4, 15, 15), (16, 16)
        plain, wrapper = (stn_place_cuda.stn_place_multi_plain,
                          stn_place_cuda.stn_place_multi_nchw)
    else:
        x, hw = torch.randn(2, 4, 16, 16), (15, 15)
        plain, wrapper = (stn_place_cuda.stn_place_multi_grad_plain,
                          stn_place_cuda.stn_place_multi_grad_nchw)
    counts = []
    for fn in (plain, wrapper):
        with FlopCounterMode(display=False) as fc:
            fn(x, bbox, hw)
        counts.append(fc.get_total_flops())
    assert counts[0] == counts[1] > 0


# ------------------------------------------------- the export against JAX's


def _jax_export(jcfg, inputs):
    """The JAX tool's export (tools/export_model.py:77-98) at ``jcfg``:
    weights drawn for the G's shapes (tests/test_torch_port_stage1g.py's
    ``_randomize``: BatchNorm away from its init, kernels at He scale, so
    the images are O(1)), the blob serialized, deserialized and called.
    Returns the weights and the call's images (NHWC)."""
    g = JStage1G(jcfg)
    args = [jnp.asarray(a) for a in inputs]
    text = args[3] if jcfg.use_ca else None
    shapes = jax.eval_shape(lambda r: g.init(r, *args[:3], text,
                                             train=False),
                            jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    params = _randomize(shapes["params"], rs, "params")
    stats = _randomize(shapes["batch_stats"], rs, "stats")

    def forward(g_params, g_stats, z, bbox, labels, *text_args):
        t = text_args[0] if text_args else None
        out = g.apply({"params": g_params, "batch_stats": g_stats},
                      z, bbox, labels, t, train=False, ca_rng=None)
        return out["img"]

    fn_args = (params, stats, *args)
    blob = jexport.export(jax.jit(forward))(*fn_args).serialize()
    img = jexport.deserialize(blob).call(*fn_args)
    return params, stats, np.asarray(img)


@pytest.fixture(scope="module", params=sorted(JAX_CFGS))
def exported(request, tmp_path_factory):
    """One variant at gf 8 / df 4: JAX's deserialized blob's images, and
    the port's program exported from the same weights, saved, loaded and
    called on the same inputs, beside the eager G's images."""
    variant = request.param
    prev = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        pcfg = _small(em.model_config(variant))
        inputs = em.example_inputs(pcfg, BATCH, "cpu", seed=7)
        params, stats, want = _jax_export(_small(JAX_CFGS[variant]),
                                          [t.numpy() for t in inputs])
    finally:
        jax.config.update("jax_default_matmul_precision", prev)
    g = em.build_g(pcfg, stage1_g_state_dict_from_jax(params, stats, pcfg),
                   "cpu")
    stn_place_cuda.reset_launch_count()
    program = torch.export.export(g, inputs, strict=False)
    path = str(tmp_path_factory.mktemp("pt2") / f"{variant}_g.pt2")
    torch.export.save(program, path)
    got = em.call_program(torch.export.load(path).module(), inputs)
    return {"want": want, "got": got, "eager": em.call_program(g, inputs),
            "places": em.place_nodes(program), "cfg": pcfg,
            "launches": (stn_place_cuda.launch_count(),
                         stn_place_cuda.grad_launch_count())}


def test_pt2_matches_jax_stablehlo(exported):
    cfg = exported["cfg"]
    assert exported["got"].shape == (BATCH, cfg.img_channels, 64, 64)
    assert exported["got"].dtype == torch.float32
    np.testing.assert_allclose(exported["got"].permute(0, 2, 3, 1).numpy(),
                               exported["want"], atol=SMALL_ATOL)
    assert np.abs(exported["want"]).max() > 0.1   # the case moves real values


def test_pt2_is_the_eager_g_and_holds_the_place_operator(exported):
    torch.testing.assert_close(exported["got"], exported["eager"], atol=0,
                               rtol=0)
    assert exported["places"] == (1, 0)
    assert exported["launches"] == (0, 0)     # the CPU launches no kernel


# ------------------------------------------------------------- the tool


def test_main_refuses_a_missing_net_g(tmp_path):
    with pytest.raises(SystemExit) as e:
        em.main(["--net_g", str(tmp_path / "missing.pth"), "--device", "cpu",
                 "--out", str(tmp_path / "g.pt2")])
    assert e.value.code not in (0, None)
    assert not (tmp_path / "g.pt2").exists()


def test_main_exports_the_trained_mnist_g(tmp_path, capsys):
    out = tmp_path / "mnist_g.pt2"
    em.main(["--net_g", CKPT, "--batch", "1", "--device", "cpu", "--out",
             str(out)])
    text = capsys.readouterr().out
    assert out.stat().st_size > 40e6              # 10.5 M float32 weights
    assert "exported mnist G (10.5M params, batch 1, float32)" in text
    assert "round-trip call OK: (1, 1, 64, 64) torch.float32; max " \
           "|program - eager G| 0\n" in text


def test_load_weights_reads_a_run_directory(tmp_path):
    sd = {"fc.0.weight": torch.arange(6.0).reshape(2, 3)}
    os.makedirs(tmp_path / "models" / "3")
    os.makedirs(tmp_path / "models" / "12")
    torch.save({"g": {k: v + 1 for k, v in sd.items()}},
               tmp_path / "models" / "3" / "state.pth")
    torch.save({"g": sd}, tmp_path / "models" / "12" / "state.pth")
    for path in (tmp_path, tmp_path / "models"):
        got = em.load_weights(str(path))
        assert list(got) == ["fc.0.weight"]
        assert torch.equal(got["fc.0.weight"], sd["fc.0.weight"])
    assert em.load_weights("") is None


def test_smoke_host_turns_times_each_call_in_turns(monkeypatch):
    """chip_smoke.py phase 54's host-clock timer: one warm-up call and
    ``calls`` calls a reading, in the order a, b, b, a."""
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    seen = []
    out = chip_smoke.host_turns([("a", lambda: seen.append("a")),
                                 ("b", lambda: seen.append("b"))], 2)
    assert seen == ["a"] * 3 + ["b"] * 6 + ["a"] * 3
    assert sorted(out) == ["a", "b"]
    assert all(len(v) == 2 and min(v) >= 0 for v in out.values())
