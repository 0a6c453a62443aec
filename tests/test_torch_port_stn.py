"""The port's STN ops (multiple_objects_gan_tpu_torch/ops) against the JAX
package's ops/stn.py and against the Pallas kernel K1 in interpret mode.

Tolerance: atol 1e-5 throughout, for feature values in [-1, 1]. Both sides
compute in float32. The source coordinate of a tap reaches |src| ~ 30,
where one float32 ulp is ~2e-6, and each way of computing it (XLA, the
Pallas kernel, the port) rounds it differently; the resulting weight error
multiplies the feature values, so the tolerance holds for features of unit
scale (the JAX package's own XLA and Pallas paths differ by up to ~1.2e-5
on unit-normal features). Padded objects must place exact zeros."""

from __future__ import annotations

import importlib
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import multiple_objects_gan_tpu.ops as jstn
import multiple_objects_gan_tpu.ops.stn_pallas as sp
from multiple_objects_gan_tpu_torch.ops import _build, stn_place_cuda
stn = importlib.import_module("multiple_objects_gan_tpu_torch.ops.stn")

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run K1 in Pallas interpret mode, as tests/test_stn_pallas.py does."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(sp.pl, "pallas_call", patched)


def _boxes(rng, b, o):
    """Random boxes, one of them partly off the canvas, the last object of
    the first item padded (bbox = -1)."""
    w = rng.uniform(0.2, 0.5, (b, o))
    h = rng.uniform(0.2, 0.5, (b, o))
    bbox = np.stack([rng.uniform(0.0, 1.0 - w), rng.uniform(0.0, 1.0 - h),
                     w, h], -1).astype(np.float32)
    bbox[0, 0, :2] = [-0.15, 0.8]      # sticks out left and bottom
    bbox[0, -1] = -1.0
    return bbox


def _inputs(seed, b, o, hw, c):
    rng = np.random.RandomState(seed)
    feats = rng.uniform(-1.0, 1.0, (b, o, hw[0], hw[1], c)).astype(np.float32)
    return feats, _boxes(rng, b, o)


@pytest.mark.parametrize("inverse", [False, True])
def test_transformation_matrices_match_jax(inverse):
    rng = np.random.RandomState(0)
    bbox = np.concatenate([rng.uniform(0.0, 0.7, (5, 2)),
                           rng.uniform(0.1, 0.5, (5, 2))], -1).astype(np.float32)
    jfn = (jstn.transformation_matrix_inverse if inverse
           else jstn.transformation_matrix)
    tfn = (stn.transformation_matrix_inverse if inverse
           else stn.transformation_matrix)
    want = np.asarray(jfn(jnp.asarray(bbox)))
    got = tfn(torch.from_numpy(bbox)).numpy()
    assert got.shape == (5, 2, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("out_hw", [(16, 16), (8, 12)])
def test_stn_separable_matches_jax(out_hw):
    rng = np.random.RandomState(1)
    img = rng.uniform(-1.0, 1.0, (3, 15, 15, 4)).astype(np.float32)
    bbox = _boxes(rng, 3, 1)[:, 0]
    theta = np.asarray(jstn.transformation_matrix_inverse(jnp.asarray(bbox)))
    want = np.asarray(jstn.stn_separable(jnp.asarray(img), jnp.asarray(theta),
                                         out_hw))
    got = stn.stn_separable(torch.from_numpy(img), torch.from_numpy(np.array(theta)),
                            out_hw).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("in_hw", [(16, 16), (15, 15)])
def test_place_multi_matches_jax(in_hw):
    feats, bbox = _inputs(2, 2, 3, in_hw, 8)
    want = np.asarray(jstn.stn_place_multi(jnp.asarray(feats),
                                           jnp.asarray(bbox), (16, 16)))
    got = stn.stn_place_multi(torch.from_numpy(feats), torch.from_numpy(bbox),
                              (16, 16)).numpy()
    assert got.shape == (2, 16, 16, 8)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("in_hw", [(16, 16), (15, 15)])
def test_place_multi_matches_pallas_k1_interpret(interpret_mode, in_hw):
    feats, bbox = _inputs(3, 2, 3, in_hw, 8)
    want = np.asarray(sp.stn_place_multi_pallas(jnp.asarray(feats),
                                                jnp.asarray(bbox), (16, 16)))
    got = stn.stn_place_multi(torch.from_numpy(feats), torch.from_numpy(bbox),
                              (16, 16)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_plain_nchw_is_the_jax_layout_op_transposed():
    feats, bbox = _inputs(4, 2, 3, (16, 16), 8)
    nchw = torch.from_numpy(feats).permute(0, 1, 4, 2, 3).contiguous()
    got = stn_place_cuda.stn_place_multi_plain(nchw, torch.from_numpy(bbox),
                                               (16, 16))
    want = np.asarray(jstn.stn_place_multi(jnp.asarray(feats),
                                           jnp.asarray(bbox), (16, 16)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=ATOL)


def test_padded_boxes_place_exact_zeros():
    feats = torch.from_numpy(
        np.random.RandomState(5).randn(2, 3, 8, 16, 16).astype(np.float32))
    bbox = torch.full((2, 3, 4), -1.0)
    out = stn_place_cuda.stn_place_multi_nchw(feats, bbox, (16, 16))
    assert out.shape == (2, 8, 16, 16)
    assert torch.count_nonzero(out) == 0


def test_place_const_multi_matches_jax():
    rng = np.random.RandomState(6)
    labels = rng.rand(2, 3, 10).astype(np.float32)
    bbox = _boxes(rng, 2, 3)
    want = np.asarray(jstn.stn_place_const_multi(jnp.asarray(labels),
                                                 jnp.asarray(bbox), (16, 16)))
    got = stn.stn_place_const_multi(torch.from_numpy(labels),
                                    torch.from_numpy(bbox), (16, 16)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_cpu_tensor_does_not_launch_the_kernel():
    stn_place_cuda.reset_launch_count()
    feats, bbox = _inputs(7, 1, 3, (16, 16), 4)
    stn.stn_place_multi(torch.from_numpy(feats), torch.from_numpy(bbox),
                        (16, 16))
    assert stn_place_cuda.launch_count() == 0


def test_wrapper_refuses_devices_other_than_cuda_and_cpu():
    feats = torch.empty((1, 3, 4, 16, 16), device="meta")
    bbox = torch.empty((1, 3, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        stn_place_cuda.stn_place_multi_nchw(feats, bbox, (16, 16))


def _thetas(rng, b):
    """Random general affine matrices (rotation, shear, scale, shift; some
    sampling far outside the image), the place matrix of a padded box
    (bbox = -1) and the extract matrix of an off-canvas box."""
    theta = rng.uniform(-1.5, 1.5, (b, 2, 3)).astype(np.float32)
    theta[0, :, 2] = [2.5, -3.0]            # the whole grid off the image
    pad = np.asarray(jstn.transformation_matrix_inverse(
        jnp.full((4,), -1.0, jnp.float32)))
    off = np.asarray(jstn.transformation_matrix(
        jnp.asarray([-0.3, 0.8, 0.5, 0.4], jnp.float32)))
    return np.concatenate([theta, pad[None], off[None]])


@pytest.mark.parametrize("out_hw", [(16, 16), (7, 12)])
def test_affine_grid_matches_jax(out_hw):
    theta = _thetas(np.random.RandomState(11), 4)
    want = np.asarray(jstn.affine_grid(jnp.asarray(theta), out_hw))
    got = stn.affine_grid(torch.from_numpy(theta), out_hw).numpy()
    assert got.shape == (6,) + out_hw + (2,)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("in_hw,out_hw", [((16, 16), (16, 16)),
                                          ((15, 13), (9, 20))])
def test_grid_sample_and_stn_match_jax(in_hw, out_hw):
    rng = np.random.RandomState(12)
    theta = _thetas(rng, 4)
    img = rng.uniform(-1.0, 1.0, (len(theta),) + in_hw + (5,)).astype(
        np.float32)
    grid = np.array(jstn.affine_grid(jnp.asarray(theta), out_hw))
    want = np.asarray(jstn.grid_sample(jnp.asarray(img), jnp.asarray(grid)))
    got = stn.grid_sample(torch.from_numpy(img),
                          torch.from_numpy(grid)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert not got[0].any() and not got[-2].any()   # off the image: zeros
    want = np.asarray(jstn.stn(jnp.asarray(img), jnp.asarray(theta), out_hw))
    got = stn.stn(torch.from_numpy(img), torch.from_numpy(theta),
                  out_hw).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_general_stn_equals_separable_at_axis_aligned_thetas():
    rng = np.random.RandomState(13)
    img = torch.from_numpy(rng.uniform(-1.0, 1.0, (3, 15, 15, 4)).astype(
        np.float32))
    theta = stn.transformation_matrix_inverse(torch.from_numpy(
        _boxes(rng, 3, 1)[:, 0]))
    np.testing.assert_allclose(stn.stn(img, theta, (16, 16)).numpy(),
                               stn.stn_separable(img, theta, (16, 16)).numpy(),
                               atol=ATOL)


def test_grid_sample_keeps_the_image_dtype():
    img = torch.ones((1, 4, 4, 2), dtype=torch.bfloat16)
    theta = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])
    out = stn.stn(img, theta, (4, 4))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, img)


def test_ops_namespace_exports_the_jax_names():
    import multiple_objects_gan_tpu_torch.ops as tops

    assert sorted(tops.__all__) == sorted(jstn.__all__)
    for name in jstn.__all__:
        assert callable(getattr(tops, name)), name
    assert tops.stn is stn.stn


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_built", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "cuda" / "bin"))
    return tmp_path / "cuda" / "bin"


def test_build_without_nvcc_raises(fresh_build):
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("stn_place")


def test_failed_build_raises_with_nvcc_output(fresh_build):
    fresh_build.mkdir(parents=True)
    nvcc = fresh_build / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'stn_place.cu(1): error: refused' >&2\n"
                    "exit 2\n")
    nvcc.chmod(0o755)
    with pytest.raises(RuntimeError, match=r"(?s)exit 2.*error: refused"):
        _build.build("stn_place")
    assert not (fresh_build.parent.parent / "build").exists() or not any(
        (fresh_build.parent.parent / "build").iterdir())
