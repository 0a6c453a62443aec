"""The port's FID and IS (``utils/metrics.py``) against the JAX package's
``utils/metrics.py`` on the CPU, on the same numpy inputs.

* ``frechet_distance``, ``fid_from_activations`` and ``inception_score``
  equal JAX's on float64 and float32 activations, the rank-deficient eps
  fallback included, and hit tests/test_metrics_golden.py's constants at
  its tolerances (the same numpy and scipy calls: equal to float
  rounding, held at rtol 1e-12);
* ``resolve_inception_fc``'s placeholder head equals JAX's bit for bit;
  ``.npz`` and ``.pth`` heads load as JAX loads them;
* ``resolve_fid_encoder``'s three provenances and its WARNING;
* ``inception_activations`` with a remainder batch (n = 3, batch 2):
  the port's CNNEncoder pool against JAX's ``CNNEncoder(return_pool=True)``
  from one DAMSM-keyed state dict, at atol 1e-5 and rtol 1e-4 (values
  about 0.1-1).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multiple_objects_gan_tpu.io.damsm_import import import_image_encoder
from multiple_objects_gan_tpu.nn.encoders import CNNEncoder as JCNNEncoder
from multiple_objects_gan_tpu.utils import metrics as jm
from multiple_objects_gan_tpu_torch.nn.encoders import (
    CNNEncoder, build_image_encoder)
from multiple_objects_gan_tpu_torch.nn.fid_inception import FIDInceptionV3
from multiple_objects_gan_tpu_torch.utils import metrics as pm
from test_cnn_encoder_parity import _randomize
from test_metrics_golden import (
    _FID_GOLDEN, _IS_MEAN_GOLDEN, _IS_STD_GOLDEN, _fid_sets)
from test_torch_port_fid_inception import jax_template

RTOL = 1e-12                # the same float64 numpy/scipy calls
POOL_ATOL, POOL_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fid_matches_jax_and_golden(dtype):
    a, b = (x.astype(dtype) for x in _fid_sets())
    got = pm.fid_from_activations(a, b)
    assert got == pytest.approx(jm.fid_from_activations(a, b), rel=RTOL)
    tol = {np.float64: 1e-6, np.float32: 1e-4}[dtype]
    np.testing.assert_allclose(got, _FID_GOLDEN, rtol=1e-6, atol=tol)


def test_frechet_distance_matches_jax_and_eps_fallback():
    rs = np.random.RandomState(5)
    a, b = rs.randn(20, 64), rs.randn(20, 64) + 1.0     # singular covariances
    got = pm.fid_from_activations(a, b)
    assert np.isfinite(got) and got > 0
    assert got == pytest.approx(jm.fid_from_activations(a, b), rel=RTOL)
    mu1, mu2 = np.zeros(16), np.full(16, 0.25)
    sigma = np.eye(16) * 1.7
    assert pm.frechet_distance(mu1, sigma, mu2, sigma.copy()) == \
        jm.frechet_distance(mu1, sigma, mu2, sigma.copy())
    full = _fid_sets()[0]
    assert abs(pm.fid_from_activations(full, full.copy())) < 1e-8


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_inception_score_matches_jax_and_golden(dtype):
    rng = np.random.RandomState(99)
    acts = rng.randn(200, 32).astype(dtype)
    fc = ((rng.randn(32, 10) * 0.3).astype(dtype),
          (rng.randn(10) * 0.1).astype(dtype))
    got = pm.inception_score(acts=acts, fc=fc)
    assert got == jm.inception_score(None, None, acts=acts, fc=fc)
    tol = {np.float64: 1e-6, np.float32: 1e-5}[dtype]
    np.testing.assert_allclose(got, (_IS_MEAN_GOLDEN, _IS_STD_GOLDEN),
                               atol=tol)


def test_random_head_is_jaxs_bit_for_bit(monkeypatch, capsys):
    monkeypatch.delenv("INCEPTION_V3_WEIGHTS", raising=False)
    (w, b), prov = pm.resolve_inception_fc()
    port_out = capsys.readouterr().out
    (jw, jb), jprov = jm.resolve_inception_fc()
    assert prov == jprov == "random"
    assert port_out == capsys.readouterr().out
    assert "WARNING: no Inception classifier head" in port_out
    assert w.dtype == jw.dtype == np.float32 and w.shape == (2048, 1000)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(b, jb)
    acts = np.random.RandomState(1).randn(30, 2048).astype(np.float32)
    assert pm.inception_score(acts=acts) == jm.inception_score(
        None, None, acts=acts)


@pytest.mark.parametrize("kind", ["npz", "pth"])
def test_imported_head_loads_as_jax(tmp_path, monkeypatch, kind):
    rs = np.random.RandomState(4)
    weight = rs.randn(1000, 2048).astype(np.float32)
    bias = rs.randn(1000).astype(np.float32)
    path = str(tmp_path / f"head.{kind}")
    if kind == "npz":
        np.savez(path, weight=weight, bias=bias)
    else:
        torch.save({"fc.weight": torch.from_numpy(weight),
                    "fc.bias": torch.from_numpy(bias),
                    "Conv2d_1a_3x3.conv.weight": torch.zeros(1)}, path)
    w, b = pm.load_inception_fc(path)
    jw, jb = jm.load_inception_fc(path)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(b, jb)
    monkeypatch.setenv("INCEPTION_V3_WEIGHTS", path)
    (w2, _), prov = pm.resolve_inception_fc()
    assert prov == jm.resolve_inception_fc()[1] == "imported"
    np.testing.assert_array_equal(w2, weight.T)


def test_resolve_fid_encoder_provenances(tmp_path, monkeypatch, capsys):
    """$FID_INCEPTION_WEIGHTS at a file: the canonical encoder on the
    device asked for; at a missing path: JAX's WARNING and the caller's
    encoder and provenance; unset: the caller's, silently."""
    pth = str(tmp_path / "pt_inception.pth")
    torch.save(FIDInceptionV3().state_dict(), pth)
    sentinel = object()
    monkeypatch.setenv("FID_INCEPTION_WEIGHTS", pth)
    enc, prov = pm.resolve_fid_encoder(sentinel, "damsm", device="cpu")
    assert prov == "fid_canonical" and isinstance(enc, FIDInceptionV3)
    assert not enc.training
    missing = str(tmp_path / "none.pth")
    monkeypatch.setenv("FID_INCEPTION_WEIGHTS", missing)
    capsys.readouterr()
    assert pm.resolve_fid_encoder(sentinel, "damsm") == (sentinel, "damsm")
    port_out = capsys.readouterr().out
    jm.resolve_fid_encoder(None, None, provenance="damsm")
    assert port_out == capsys.readouterr().out
    assert "WARNING: $FID_INCEPTION_WEIGHTS=" in port_out
    monkeypatch.delenv("FID_INCEPTION_WEIGHTS")
    assert pm.resolve_fid_encoder(sentinel) == (sentinel, "random")
    assert capsys.readouterr().out == ""


def test_inception_activations_remainder_matches_jax_pool(tmp_path):
    """n = 3 at batch 2: one full batch and a zero-padded one, sliced;
    the port's CNNEncoder pool against JAX's from one DAMSM state dict."""
    pth = str(tmp_path / "image_encoder0.pth")
    torch.save(_randomize(CNNEncoder(16), seed=3).state_dict(), pth)
    port = build_image_encoder(16, torch.load(pth, weights_only=True),
                               device="cpu")
    jenc = JCNNEncoder(nef=16)
    jvars = import_image_encoder(pth, jax_template(jenc, 64))
    x = (np.random.RandomState(2).randn(3, 64, 64, 3) * 0.5).astype(
        np.float32)
    got = pm.inception_activations(port, x, batch_size=2)
    want = jm.inception_activations(jenc, jvars, x, batch_size=2)
    assert got.shape == (3, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=POOL_ATOL, rtol=POOL_RTOL)
    assert np.abs(want).max() > 0.1
    # the pool is the encoder's third output on the same images
    with torch.no_grad():
        _, code, pool = port(torch.from_numpy(x).permute(0, 3, 1, 2),
                             return_pool=True)
    np.testing.assert_allclose(got, pool.numpy(), atol=1e-6, rtol=1e-5)
    assert code.shape == (3, 16)


def test_frechet_distance_takes_a_sqrtm_without_disp(monkeypatch):
    """scipy 1.18 (the card's machine) removed ``sqrtm``'s ``disp`` and
    returns the root alone: the same FID, and the eps fallback still
    reached on a non-finite root."""
    from scipy import linalg

    rs = np.random.RandomState(6)
    a, b = rs.randn(40, 16), rs.randn(40, 16) + 0.5
    want = pm.fid_from_activations(a, b)
    real = linalg.sqrtm
    calls = []

    def sqrtm_118(m):
        calls.append(m)
        root = real(m)
        return root if len(calls) > 1 or not nan_first else root * np.nan

    monkeypatch.setattr(linalg, "sqrtm", sqrtm_118)
    nan_first = False
    assert pm.fid_from_activations(a, b) == pytest.approx(want, rel=1e-12)
    assert len(calls) == 1
    nan_first, calls[:] = True, []
    assert np.isfinite(pm.fid_from_activations(a, b))
    assert len(calls) == 2              # the eps-offset retry
