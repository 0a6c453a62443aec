"""The port's learning-validation tool (``multiple_objects_gan_tpu_torch/
tools/validate_learning.py``) against the JAX package's
``tools/validate_learning.py`` on the CPU.

* The measurement helpers (``_separation``, ``_random_layouts`` with
  clevr's two-hot draw, ``fid_decreasing`` on JAX's seven trend cases) equal
  the JAX tool's exactly, and the three cfg patches parse to the same
  values in the port's loader as in JAX's.
* The trend encoder: with JAX's ``PRNGKey(0)`` parameters carried across
  (HWIO -> OIHW), its features equal JAX's within 1e-5 at 64 and 256 px
  and at an odd size (XLA's 'SAME' puts the odd pixel of padding at the
  high end). The port draws its own orthogonal init from
  ``torch.Generator().manual_seed(0)``, pinned here as JAX pins its own
  (test_validate_tool.py:test_trend_encoder_contract_pinned), and its FID
  discriminates as JAX's test asks.
* ``_export_frozen_s1`` writes bit for bit the frozen stage-1 G that
  ``cli/stage2_runner.py:frozen_stage1_g`` builds from the seed.
* One end-to-end Multi-MNIST run at GF 8 / DF 8 (a reduced yml in the
  tool's cfg table), n 256, 2 epochs in 2 segments, ``--device cpu``,
  with ``--export_pth``: the JSON line has the JAX tool's keys and finite
  values, and the exported ``.pth`` loads as a strict reference NET_G.
"""

from __future__ import annotations

import functools
import json
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiple_objects_gan_tpu.config.config import (
    cfg_from_file as jcfg_from_file)
from multiple_objects_gan_tpu_torch.cli.sample import load_generator
from multiple_objects_gan_tpu_torch.cli.stage2_runner import frozen_stage1_g
from multiple_objects_gan_tpu_torch.config.config import (
    cfg_from_file, stage1_model_config, stage2_model_config)
from multiple_objects_gan_tpu_torch.io.weights import load_reference_g
from multiple_objects_gan_tpu_torch.tools import validate_learning as port

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import validate_learning as jax_tool  # noqa: E402

# the keys of the JAX tool's JSON line for mnist (tools/validate_learning.py:
# 728-751)
JAX_MNIST_KEYS = {"workdir", "exported_pth", "variant", "epochs", "in_box",
                  "out_box", "separation", "separation_trend", "fid_trend",
                  "fid_decreasing", "layout_fidelity",
                  "layout_fidelity_trend"}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_separation_equals_jax():
    rs = np.random.RandomState(0)
    imgs = rs.uniform(-1, 1, (6, 32, 32, 3)).astype(np.float32)
    imgs[:, 4:12, 4:12] = 0.9
    bbox, _, _ = jax_tool._random_layouts(6, 4, 13, seed=1)
    bbox[0, 0] = [0.05, 0.1, 0.9, 0.95]          # reaches past the edge
    assert port._separation(imgs, bbox) == jax_tool._separation(imgs, bbox)


@pytest.mark.parametrize("b,o,label_dim,n_classes,clevr", [
    (32, 3, 10, 10, False), (32, 4, 13, 0, True), (16, 3, 81, 0, False)])
def test_random_layouts_equal_jax(b, o, label_dim, n_classes, clevr):
    got = port._random_layouts(b, o, label_dim, 8, n_classes=n_classes,
                               clevr=clevr)
    want = jax_tool._random_layouts(b, o, label_dim, 8, n_classes=n_classes,
                                    clevr=clevr)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # the stream goes on alike (the text embeddings and captions after it)
    np.testing.assert_array_equal(got[2].randn(4), want[2].randn(4))


def test_fid_decreasing_equals_jax_on_its_seven_trends():
    trends = [([39.86, 0.37, 0.37], True), ([37.00, 0.37, 0.38], True),
              ([24.99, 0.08, 0.09], True), ([26.73, 0.12, 0.18], True),
              ([5.0, 5.0, 5.0], False), ([5.0, 6.0, 7.0], False),
              ([30.0, 0.5, 12.0], False)]
    for fids, verdict in trends:
        assert port.fid_decreasing(fids) is verdict
        assert jax_tool.fid_decreasing(fids) is verdict


def _flat(cfg, prefix=""):
    out = {}
    for k, v in cfg.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("patch", ["validate", "full", "eval"])
def test_cfg_patches_parse_alike(tmp_path, monkeypatch, patch):
    monkeypatch.chdir(ROOT)     # the JAX tool reads cfg/ from the cwd
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    net_e = str(tmp_path / "damsm" / "text_encoder0.pth")
    run = str(tmp_path / "out_e2")

    def write(mod, d):
        if patch == "validate":
            return mod._write_attngan_validate_cfg(str(d))
        if patch == "full":
            return mod._write_attngan_full_cfg(str(d), net_e)
        train = mod._write_attngan_full_cfg(str(d), net_e)
        return mod._write_attngan_eval_cfg(str(d), train, run)

    want = _flat(jcfg_from_file(write(jax_tool, jdir), "coco-attngan"))
    got = _flat(cfg_from_file(write(port, pdir), "coco-attngan"))
    assert {k: got[k] for k in want} == want
    if patch == "validate":
        assert got["TRAIN.SMOOTH.LAMBDA"] == 0.0 and got["TRAIN.NET_E"] == ""
    if patch == "eval":
        assert got["B_VALIDATION"] is True and got["TRAIN.FLAG"] is False
        assert got["TRAIN.NET_G"] == run


def _carried(size):
    """The JAX trend encoder at ``size`` and the port's with its weights."""
    enc_vars, feat = jax_tool.make_trend_encoder(size)
    enc = port.TrendEncoder()
    with torch.no_grad():
        for i, conv in enumerate(enc.convs):
            p = enc_vars["params"][f"Conv_{i}"]
            conv.weight.copy_(torch.from_numpy(np.transpose(
                np.array(p["kernel"]), (3, 2, 0, 1)).copy()))
            conv.bias.copy_(torch.from_numpy(np.array(p["bias"])))
    return enc_vars, feat, enc.eval()


@pytest.mark.parametrize("size", [64, 256, 37])
def test_trend_encoder_equals_jax_on_carried_weights(size):
    enc_vars, feat, enc = _carried(size)
    x = (np.random.RandomState(size).rand(3, size, size, 3).astype(
        np.float32) * 2 - 1)
    want = np.asarray(feat(enc_vars, jnp.asarray(x)))
    got = port.trend_features(enc, x)
    assert got.shape == want.shape == (3, 448)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_trend_encoder_pinned():
    """The port's own init (orthogonal from torch.Generator seed 0):
    parameter count, abs-sum and a feature vector on a fixed input. A
    change here changes every trend number the port has recorded."""
    enc = port.make_trend_encoder()
    params = list(enc.parameters())
    assert sum(p.numel() for p in params) == 165600
    abs_sum = float(sum(float(p.detach().abs().sum()) for p in params))
    np.testing.assert_allclose(abs_sum, 4604.3193359375, rtol=1e-5)
    rs = np.random.RandomState(42)
    f = port.trend_features(enc, rs.rand(2, 64, 64, 3).astype(np.float32)
                            * 2 - 1)
    assert f.shape == (2, 448)
    np.testing.assert_allclose(float(np.abs(f).sum()), 133.2747802734375,
                               rtol=1e-4)
    np.testing.assert_allclose(
        f[0, :4], [0.17099593579769135, 0.17434869706630707,
                   0.190751314163208, 0.20068888366222382], rtol=1e-4)


def test_trend_fid_discriminates():
    """JAX's test_trend_fid_discriminates criteria on the port's encoder:
    a distant distribution far above a near-copy, itself at ~0, and gray
    inputs through the three-channel repeat."""
    rs = np.random.RandomState(0)
    real = rs.rand(48, 64, 64, 3).astype(np.float32) * 2 - 1
    far = (rs.rand(48, 64, 64, 3).astype(np.float32) * 2 - 1) * 0.1 - 0.5
    near = real + rs.randn(48, 64, 64, 3).astype(np.float32) * 0.05
    f_far, f_near = port._fid(real, far), port._fid(real, near)
    assert f_far > 100 * max(f_near, 1e-6)
    assert abs(port._fid(real, real.copy())) < 1e-3
    g = real[..., :1]
    assert port._fid(g, g.copy() * 0.2 - 0.5) > 1.0


def _s2_small(tmp_path):
    with open(os.path.join(ROOT, "cfg", "coco_s2_train.yml")) as f:
        yml = f.read()
    yml = (yml.replace("GF_DIM: 192", "GF_DIM: 16")
              .replace("DF_DIM: 96", "DF_DIM: 8")
              .replace("CONDITION_DIM: 128", "CONDITION_DIM: 16")
              .replace("DIMENSION: 1024", "DIMENSION: 32"))
    path = tmp_path / "s2_small.yml"
    path.write_text(yml)
    return str(path)


def test_export_frozen_s1_roundtrip(tmp_path):
    cfg_file = _s2_small(tmp_path)
    pth = port._export_frozen_s1(cfg_file, 7, str(tmp_path / "s1.pth"))
    cfg = cfg_from_file(cfg_file, "coco-stackgan-2")
    s1_cfg, _ = stage2_model_config(cfg)
    want = frozen_stage1_g(s1_cfg, cfg.get("STAGE1_G", ""), seed=7,
                           device="cpu").state_dict()
    got = load_reference_g(pth)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.load(pth, weights_only=True)["epoch"] == 0


def test_mnist_end_to_end_small(tmp_path, monkeypatch, capsys):
    with open(os.path.join(ROOT, "cfg", "mnist_train.yml")) as f:
        yml = f.read()
    yml = yml.replace("GF_DIM: 128", "GF_DIM: 8").replace("DF_DIM: 64",
                                                          "DF_DIM: 8")
    small = tmp_path / "mnist_small.yml"
    small.write_text(yml)
    monkeypatch.setitem(port.CFG_FILES, "multi-mnist", str(small))
    # the layout classifier's fit is the layout tests' business: 20 steps
    monkeypatch.setattr(port.lf, "train_digit_classifier", functools.partial(
        port.lf.train_digit_classifier, steps=20))
    pth = str(tmp_path / "netG.pth")
    out = port.main(["mnist", "--n", "256", "--epochs", "2", "--segments",
                     "2", "--workdir", str(tmp_path / "work"),
                     "--export_pth", pth, "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert set(out) == JAX_MNIST_KEYS
    assert [e for e, _ in out["fid_trend"]] == [0, 1, 2]
    assert [e for e, _ in out["separation_trend"]] == [1, 2]
    assert [r[0] for r in out["layout_fidelity_trend"]] == [1, 2]
    numbers = [out["in_box"], out["out_box"], out["separation"],
               *[v for row in out["fid_trend"] for v in row],
               out["layout_fidelity"]["recall"],
               out["layout_fidelity"]["loc_iou"]]
    assert all(math.isfinite(v) for v in numbers)
    assert isinstance(out["fid_decreasing"], bool)
    assert out["exported_pth"] == pth
    # the export loads strictly as a reference NET_G and is the run's G
    mcfg = stage1_model_config(cfg_from_file(str(small), "multi-mnist"),
                               "multi-mnist")
    g_pth = load_generator(mcfg, pth, 0, "cpu")
    g_run = load_generator(mcfg, os.path.join(out["workdir"], "out_e2"), 0,
                           "cpu")
    for (k, a), (_, b) in zip(g_pth.state_dict().items(),
                              g_run.state_dict().items()):
        assert torch.equal(a, b), k
