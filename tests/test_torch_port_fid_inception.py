"""The port's canonical FID Inception (``nn/fid_inception.py``) against the
JAX package's ``create_fid_encoder`` on the CPU.

One seeded state dict with pytorch-fid's pt_inception keys (and dummy
``fc``/``AuxLogits`` entries the importers skip) is written once; the
JAX encoder imports it once for the module (its variables' template
from ``jax.eval_shape``, so no init is compiled). Held:

* pool3 of batch 2 at 299x299 (the resize an identity) and of one 64x64
  image (the bilinear resize to 299), port against JAX at atol 1e-3 and
  rtol 1e-5 (tests/test_fid_inception.py holds JAX to its torch oracle at
  2e-3; the port meets the tighter bound: 2.1e-4 measured at values up
  to 476);
* a file missing a module raises KeyError "uninitialized", one with an
  unknown key KeyError, a wrong shape ValueError, in both packages;
* the forward is float32 with TF32 off inside even when the caller turned
  TF32 on, and the caller's settings are back afterwards.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiple_objects_gan_tpu.nn import fid_inception as jfid
from multiple_objects_gan_tpu_torch.nn import fid_inception as pfid
from test_cnn_encoder_parity import _randomize
from test_fid_inception import _save_sd_with_head_keys

ATOL, RTOL = 1e-3, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_template(module, side: int = 75) -> dict:
    """Zero variables of ``module``'s structure, from its abstract init."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, side, side, 3)), train=False))
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fid")
    pth = str(tmp / "pt_inception_test.pth")
    _save_sd_with_head_keys(
        _randomize(pfid.FIDInceptionV3(), seed=11).eval(), pth)
    module = jfid.FIDInceptionV3()
    template = jax_template(module)
    variables = jfid.import_fid_inception(pth, dict(template))
    fwd = jax.jit(lambda v, x: module.apply(v, x, train=False,
                                            return_pool=True)[2])
    return {"tmp": tmp, "pth": pth, "template": template,
            "jax": lambda x: np.asarray(fwd(variables, jnp.asarray(x))),
            "port": pfid.create_fid_encoder(pth, "cpu")}


def _port_pool(model, x):
    with torch.no_grad():
        _, _, pool = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    return pool.numpy()


@pytest.mark.parametrize("shape", [(2, 299, 299, 3), (1, 64, 64, 3)],
                         ids=["299_identity_resize", "64_resized"])
def test_pool3_matches_jax(world, shape):
    x = (np.random.RandomState(7).randn(*shape) * 0.5).astype(np.float32)
    got = _port_pool(world["port"], x)
    want = world["jax"](x)
    assert got.shape == (shape[0], 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.abs(want).max() > 1.0       # not a vacuous comparison


def _edited(world, name, edit):
    sd = torch.load(world["pth"], weights_only=True)
    edit(sd)
    path = str(world["tmp"] / name)
    torch.save(sd, path)
    return path


@pytest.mark.parametrize("case", ["missing_module", "unknown_key",
                                  "wrong_shape"])
def test_import_errors_match_jax(world, case):
    def drop(sd):
        for k in [k for k in sd if k.startswith("Mixed_7c.")]:
            del sd[k]

    def add(sd):
        sd["Mixed_9z.branch1x1.conv.weight"] = torch.zeros(8, 8, 1, 1)

    def reshape(sd):
        sd["Mixed_5b.branch1x1.bn.weight"] = torch.zeros(65)

    edit, error, match = {
        "missing_module": (drop, KeyError, "uninitialized"),
        "unknown_key": (add, KeyError, "Mixed_9z"),
        "wrong_shape": (reshape, ValueError, "shape"),
    }[case]
    path = _edited(world, f"{case}.pth", edit)
    with pytest.raises(error, match=match):
        pfid.create_fid_encoder(path, "cpu")
    with pytest.raises(error, match=match):
        jfid.import_fid_inception(path, dict(world["template"]))


def test_forward_pins_float32_and_restores_the_callers_tf32(world):
    """A caller with TF32 on (a --bf16 process's settings): inside the
    forward both flags are off, the output is float32 and equal to the
    forward's under the float32 settings; afterwards both are on again."""
    model = world["port"]
    x = (np.random.RandomState(3).randn(1, 64, 64, 3) * 0.5).astype(
        np.float32)
    want = _port_pool(model, x)
    seen = []
    hook = model.Mixed_7c.register_forward_pre_hook(
        lambda *_: seen.append((torch.backends.cuda.matmul.allow_tf32,
                                torch.backends.cudnn.allow_tf32)))
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        got = _port_pool(model, x)
        after = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    finally:
        hook.remove()
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    assert seen == [(False, False)]
    assert after == (True, True)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
