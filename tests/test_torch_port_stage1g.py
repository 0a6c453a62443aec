"""The port's Stage-1 generator (multiple_objects_gan_tpu_torch) against the
JAX package's Stage1G, with weights carried across by
``stage1_g_state_dict_from_jax`` and loaded with strict=True.

JAX runs at "highest" matmul/conv precision here (CPU's default is
bf16-like; see CLAUDE.md) and both sides compute in float32 on the CPU.
Tolerances on images in [-1, 1] (and on the pathway outputs): 2e-5 at
small width (gf_dim 8, so ngf 64: convolution sums of up to 9 * 64 terms;
about 3e-6 is seen), and 2e-4 at full width (ngf 1024: sums of up to
9 * 1024 terms through five layers; about 6e-5 is seen).
"""

from __future__ import annotations

import dataclasses
import os
import zipfile

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiple_objects_gan_tpu.io import torch_export as tx
from multiple_objects_gan_tpu.io import torch_import as ti
from multiple_objects_gan_tpu.io.pycompat import torch_load as jax_torch_load
from multiple_objects_gan_tpu.models import common as jcommon
from multiple_objects_gan_tpu.models.stage1 import Stage1G as JStage1G
from multiple_objects_gan_tpu.nn.pathways import (
    LayoutEncoder as JLayoutEncoder, ObjectPathwayG as JObjectPathwayG)
from multiple_objects_gan_tpu.train.step import make_sample_fn
from multiple_objects_gan_tpu_torch.io import pycompat
from multiple_objects_gan_tpu_torch.io.weights import (
    load_reference_g, stage1_g_state_dict_from_jax)
from multiple_objects_gan_tpu_torch.models import common
from multiple_objects_gan_tpu_torch.models.stage1 import (
    Stage1G, build_stage1_g)
from multiple_objects_gan_tpu_torch.nn.pathways import object_pathway_g

JCFG = dataclasses.replace(jcommon.MNIST, gf_dim=8)
PCFG = dataclasses.replace(common.MNIST, gf_dim=8)
SMALL_ATOL = 2e-5
FULL_ATOL = 2e-4
CKPT = os.path.join(os.path.dirname(__file__), os.pardir, "runs_r5",
                    "mnist_repin", "netG_final.pth")


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


def _layout(seed, b, mcfg):
    """z, boxes (one partly off the canvas, one padded) and one-hots."""
    rng = np.random.RandomState(seed)
    o, n = mcfg.num_objects, mcfg.label_dim
    z = rng.randn(b, mcfg.z_dim).astype(np.float32)
    w = rng.uniform(0.2, 0.4, (b, o))
    h = rng.uniform(0.2, 0.4, (b, o))
    bbox = np.stack([rng.uniform(0, 1 - w), rng.uniform(0, 1 - h), w, h],
                    -1).astype(np.float32)
    bbox[0, 0, 0] = -0.1
    bbox[-1, -1] = -1.0
    labels = np.zeros((b, o, n), np.float32)
    labels[np.arange(b)[:, None], np.arange(o)[None, :],
           rng.randint(0, n, (b, o))] = 1.0
    labels[-1, -1] = 0.0
    return z, bbox, labels


def _randomize(tree, rng, kind):
    """Every leaf drawn anew: BatchNorm away from its init (scale 1, bias
    0, mean 0, var 1), which would hide a mapping bug, and kernels at
    He scale, so activations and images are O(1) rather than ~1e-3."""
    out = {}
    for k, v in tree.items():
        shape = np.shape(v)
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, kind)
        elif kind == "stats":
            out[k] = (rng.uniform(0.5, 1.5, shape) if k == "var"
                      else rng.normal(0.0, 0.2, shape)).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif k == "bias":
            out[k] = rng.normal(0.0, 0.1, shape).astype(np.float32)
        else:
            fan_in = int(np.prod(shape[:-1]))
            out[k] = rng.normal(0.0, np.sqrt(2.0 / fan_in),
                                shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def small():
    """JAX Stage1G at gf_dim 8 with randomized BatchNorm, its inputs, and
    the port's model built from the same weights."""
    g = JStage1G(JCFG)
    z, bbox, labels = _layout(0, 3, JCFG)
    variables = jax.jit(lambda r: g.init(
        r, jnp.asarray(z), jnp.asarray(bbox), jnp.asarray(labels), None,
        train=False))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    params = _randomize(jax.tree.map(np.asarray, variables["params"]), rng,
                        "params")
    stats = _randomize(jax.tree.map(np.asarray, variables["batch_stats"]),
                       rng, "stats")
    port = build_stage1_g(PCFG, stage1_g_state_dict_from_jax(params, stats,
                                                             PCFG),
                          device="cpu")
    return g, params, stats, (z, bbox, labels), port


def test_stage1g_matches_jax_sample_fn(small):
    g, params, stats, (z, bbox, labels), port = small
    want = np.asarray(make_sample_fn(JCFG, g)(
        params, stats, jnp.asarray(z), jnp.asarray(bbox),
        jnp.asarray(labels)))
    with torch.inference_mode():
        got = port(torch.from_numpy(z), torch.from_numpy(bbox),
                   torch.from_numpy(labels))
    assert got.shape == (3, 1, 64, 64)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=SMALL_ATOL)


def test_object_pathway_matches_jax(small):
    _, params, stats, (_, bbox, labels), port = small
    want = np.asarray(jax.jit(lambda p, s: JObjectPathwayG(JCFG.ngf).apply(
        {"params": p, "batch_stats": s}, jnp.asarray(labels),
        jnp.asarray(bbox), False))(params["local"], stats["local"]))
    with torch.inference_mode():
        got = object_pathway_g(torch.from_numpy(labels),
                               torch.from_numpy(bbox), port.local1,
                               port.local2)
    assert got.shape == (3, JCFG.ngf // 4, 16, 16)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=SMALL_ATOL)


def test_layout_encoder_matches_jax(small):
    _, params, stats, (_, bbox, labels), port = small
    want = np.asarray(jax.jit(lambda p, s: JLayoutEncoder(
        JCFG.condition_dim).apply({"params": p, "batch_stats": s},
                                  jnp.asarray(labels), jnp.asarray(bbox),
                                  False))(params["bbox_net"],
                                          stats["bbox_net"]))
    with torch.inference_mode():
        got = port.bbox_net(torch.from_numpy(labels), torch.from_numpy(bbox))
    assert got.shape == (3, JCFG.layout_code_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=SMALL_ATOL)


def test_jax_export_route_agrees_with_direct_route(small):
    """The JAX package's export_stage1_g state dict and the port's direct
    mapping hold the same keys and values, and both load strict=True."""
    _, params, stats, (z, bbox, labels), port = small
    direct = stage1_g_state_dict_from_jax(params, stats, PCFG)
    exported = {k: torch.as_tensor(np.array(v))
                for k, v in tx.export_stage1_g(params, stats, JCFG).items()}
    assert sorted(direct) == sorted(exported)
    for k in direct:
        np.testing.assert_array_equal(direct[k].numpy(),
                                      exported[k].numpy().reshape(
                                          direct[k].shape), err_msg=k)
    via_export = Stage1G(PCFG)
    via_export.load_state_dict(exported, strict=True)
    via_export.eval()
    args = (torch.from_numpy(z), torch.from_numpy(bbox),
            torch.from_numpy(labels))
    with torch.inference_mode():
        torch.testing.assert_close(via_export(*args), port(*args),
                                   atol=0.0, rtol=0.0)


def test_trained_fullwidth_checkpoint_matches_jax():
    """runs_r5/mnist_repin/netG_final.pth (ngf 1024, 10.54 M parameters)
    through the JAX importer and through the port, batch 2, same z."""
    mcfg = jcommon.MNIST
    params, stats = ti.import_stage1_g(jax_torch_load(CKPT), mcfg)
    z, bbox, labels = _layout(2, 2, mcfg)
    want = np.asarray(make_sample_fn(mcfg, JStage1G(mcfg))(
        params, stats, jnp.asarray(z), jnp.asarray(bbox),
        jnp.asarray(labels)))
    port = build_stage1_g(common.MNIST, load_reference_g(CKPT), device="cpu")
    assert sum(p.numel() for p in port.parameters()) == 10_540_312
    with torch.inference_mode():
        got = port(torch.from_numpy(z), torch.from_numpy(bbox),
                   torch.from_numpy(labels))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=FULL_ATOL)


def test_build_stage1_g_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_stage1_g(PCFG)


def test_torch_load_py2_str_fallback(tmp_path):
    """A .pth holding a py2 str with a non-ASCII byte (as py2 torch-0.4
    containers can) loads through the latin1 fallback, weights_only."""
    sd = {"epoch": 7, "path": "markerXYZ",
          "w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    raw = tmp_path / "ck.pth"
    torch.save(sd, str(raw))
    with zipfile.ZipFile(str(raw)) as z:
        entries = {n: z.read(n) for n in z.namelist()}
    pkl = [n for n in entries if n.endswith("data.pkl")][0]
    needle = b"X\t\x00\x00\x00markerXYZ"
    assert needle in entries[pkl]
    entries[pkl] = entries[pkl].replace(needle, b"U\tmarker\xe9YZ")
    patched = tmp_path / "ck_py2.pth"
    with zipfile.ZipFile(str(patched), "w", zipfile.ZIP_STORED) as z:
        for n, data in entries.items():
            z.writestr(n, data)
    got = pycompat.torch_load(str(patched))
    assert got["epoch"] == 7 and got["path"] == "marker\xe9YZ"
    assert float(got["w"].sum()) == 15.0
