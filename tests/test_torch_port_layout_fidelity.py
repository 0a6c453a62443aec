"""The port's layout fidelity (``utils/layout_fidelity.py``) against the
JAX package's ``utils/layout_fidelity.py`` on the CPU.

* both renderers give JAX's canvases, boxes and labels bit for bit from
  the same ``RandomState``;
* ``_loc_iou`` equals JAX's on edge cases (no mass in the window, a box
  at the canvas border, content spilling out of its box);
* ``layout_fidelity`` and ``clevr_layout_fidelity`` return JAX's dicts
  exactly on the same images, boxes (with padded rows) and classifier
  parameters;
* 20 SGD steps at batch 32 of ``train_digit_classifier`` (and 5 at 16 of
  ``train_clevr_classifier``) from JAX's initial draw end within atol
  1e-5 of JAX's parameters (float32 sums in another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiple_objects_gan_tpu.utils import layout_fidelity as jlf
from multiple_objects_gan_tpu_torch.utils import layout_fidelity as plf

PARAM_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_init(seed: int, d_in: int, d_out: int) -> dict:
    """JAX train_*_classifier's initial draw."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {"w1": np.asarray(jax.random.normal(k1, (d_in, 64))
                             * np.sqrt(2.0 / d_in)),
            "b1": np.zeros(64, np.float32),
            "w2": np.asarray(jax.random.normal(k2, (64, d_out))
                             * np.sqrt(2.0 / 64)),
            "b2": np.zeros(d_out, np.float32)}


def _torch(params: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in params.items()}


@pytest.fixture(scope="module")
def trained():
    """JAX's and the port's classifiers after the same SGD from JAX's
    initial draw."""
    out = {}
    for name, (train_j, train_p, d_in, d_out, steps, batch) in {
            "digit": (jlf.train_digit_classifier, plf.train_digit_classifier,
                      16 * 16, 10, 20, 32),
            "clevr": (jlf.train_clevr_classifier, plf.train_clevr_classifier,
                      16 * 16 * 3, 11, 5, 16)}.items():
        j = train_j(seed=4, steps=steps, batch=batch)
        p = train_p(seed=4, steps=steps, batch=batch, device="cpu",
                    init=jax_init(4, d_in, d_out))
        out[name] = (j, p)
    return out


@pytest.mark.parametrize("name", ["digit", "clevr"])
def test_renderers_match_jax_bit_for_bit(name):
    render_j, render_p = {"digit": (jlf._render_batch, plf._render_batch),
                          "clevr": (jlf._render_clevr_batch,
                                    plf._render_clevr_batch)}[name]
    rs_j, rs_p = np.random.RandomState(9), np.random.RandomState(9)
    for n in (7, 33):
        for got, want in zip(render_p(rs_p, n), render_j(rs_j, n)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert rs_p.randint(1 << 30) == rs_j.randint(1 << 30)


@pytest.mark.parametrize("case", ["empty_window", "at_border", "spill",
                                  "inside"])
def test_loc_iou_edge_cases_match_jax(case):
    lum = np.zeros((64, 64), np.float32)
    bb = np.array([0.25, 0.25, 0.25, 0.25], np.float32)
    if case == "at_border":
        bb = np.array([0.85, 0.0, 0.3, 0.2], np.float32)
        lum[:10, 56:] = 1.0
    elif case == "spill":
        lum[10:40, 10:40] = 0.9
    elif case == "inside":
        lum[16:32, 16:32] = 0.5
    got = plf._loc_iou(lum, bb)
    assert got == jlf._loc_iou(lum, bb)
    assert got == pytest.approx({"empty_window": 0.0, "inside": 1.0}.get(
        case, got))
    assert 0.0 <= got <= 1.0
    if case != "empty_window":
        assert got > 0.0


def test_digit_classifier_sgd_matches_jax(trained):
    j, p = trained["digit"]
    for k, v in j.params.items():
        np.testing.assert_allclose(p.params[k].numpy(), np.asarray(v),
                                   atol=PARAM_ATOL, err_msg=k)
    # the training moved the draw
    assert np.abs(p.params["b2"].numpy()).max() > 1e-3


def test_clevr_classifier_sgd_matches_jax(trained):
    j, p = trained["clevr"]
    for k, v in j.params.items():
        np.testing.assert_allclose(p.params[k].numpy(), np.asarray(v),
                                   atol=PARAM_ATOL, err_msg=k)


def _padded(imgs, bbox, pad_label):
    """The renderer's boxes with a padded second object (w = -1)."""
    pad = np.tile(np.array([[[0.1, 0.1, -1.0, -1.0]]], np.float32),
                  (bbox.shape[0], 1, 1))
    return imgs, np.concatenate([bbox, pad], 1), pad_label


@pytest.mark.parametrize("onehot", [False, True], ids=["ids", "onehots"])
def test_layout_fidelity_dict_matches_jax(trained, onehot):
    j, p = trained["digit"]
    imgs, bbox, labels = jlf._render_batch(np.random.RandomState(5), 24)
    # a third of the canvases blanked: misses, and windows without mass
    imgs[::3] = -1.0
    labels = np.stack([labels, np.zeros_like(labels)], 1)
    if onehot:
        labels = np.eye(10, dtype=np.float32)[labels]
    imgs, bbox, labels = _padded(imgs, bbox, labels)
    got = plf.layout_fidelity(imgs, bbox, labels, p)
    want = jlf.layout_fidelity(imgs, bbox, labels, clf=jlf.DigitClassifier(
        {k: jnp.asarray(v.numpy()) for k, v in p.params.items()}))
    assert got == want
    assert got["n_objects"] == 24
    assert 0.0 < got["recall"] < 1.0


def test_clevr_layout_fidelity_dict_matches_jax(trained):
    j, p = trained["clevr"]
    imgs, bbox, ys, yc = jlf._render_clevr_batch(np.random.RandomState(6),
                                                 24)
    labels = np.zeros((24, 2, 13), np.float32)
    labels[np.arange(24), 0, ys] = 1.0
    labels[np.arange(24), 0, 4 + yc] = 1.0
    imgs, bbox, labels = _padded(imgs, bbox, labels)
    got = plf.clevr_layout_fidelity(imgs, bbox, labels, p)
    want = jlf.clevr_layout_fidelity(imgs, bbox, labels,
                                     clf=jlf.ClevrClassifier(
        {k: jnp.asarray(v.numpy()) for k, v in p.params.items()}))
    assert got == want
    assert got["n_objects"] == 24 and got["loc_iou"] > 0.5
