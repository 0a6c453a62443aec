"""The port's stage-1 sampler (multiple_objects_gan_tpu_torch/cli/sample.py)
against the JAX package's ``cli/sample.py:sample_stage1``, on the CPU, at
GF/DF 8.

For the same G weights (the JAX G, exported to a reference ``.pth`` by
``io/torch_export.py``), the same test split and the same z (the JAX
sampler's ``fold_in`` draws, handed to the port), the first row of every
grid (the real image and 9 fakes with white box edges) equals the JAX
grid's within 1 level of 255. The caption row is drawn with the port's
own font, so it is held by layout: white outside the text box, dark
pixels inside. Layout surgery and captions equal the JAX ones for the
same ``RandomState``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from multiple_objects_gan_tpu.cli import sample as jsample
from multiple_objects_gan_tpu.config.config import (
    default_config as jdefault_config)
from multiple_objects_gan_tpu.io import torch_export as tx
from multiple_objects_gan_tpu.models import common as jcommon
from multiple_objects_gan_tpu.models.stage1 import (
    Stage1D as JStage1D, Stage1G as JStage1G)
from multiple_objects_gan_tpu.train.step import create_state as jcreate_state
from multiple_objects_gan_tpu_torch.cli import sample as psample
from multiple_objects_gan_tpu_torch.config.config import default_config
from multiple_objects_gan_tpu_torch.data.datasets import (
    write_synthetic_clevr, write_synthetic_multimnist)
from multiple_objects_gan_tpu_torch.models import common
from multiple_objects_gan_tpu_torch.utils.images import GLYPH_ADVANCE
from test_torch_port_stage1g import _randomize

LEVELS = 1            # a grid's first row against JAX's, levels of 255
N_GRIDS = 3
TILE, PAD = 64, 2
FAMILIES = {"multi-mnist": (jcommon.MNIST, common.MNIST),
            "clevr": (jcommon.CLEVR, common.CLEVR)}


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


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request, tmp_path_factory):
    """A family's JAX state with a randomized G, that G as a reference
    ``.pth``, and a test split on disk."""
    variant = request.param
    jpreset, ppreset = FAMILIES[variant]
    jcfg = dataclasses.replace(jpreset, gf_dim=8, df_dim=8)
    pcfg = dataclasses.replace(ppreset, gf_dim=8, df_dim=8)
    st = jcreate_state(jcfg, JStage1G(jcfg), JStage1D(jcfg),
                       jax.random.PRNGKey(0), batch_size=2)
    rng = np.random.RandomState(3)
    st = st.replace(
        g_params=_randomize(jax.tree.map(np.asarray, st.g_params), rng,
                            "params"),
        g_stats=_randomize(jax.tree.map(np.asarray, st.g_stats), rng,
                           "stats"))
    root = tmp_path_factory.mktemp(variant)
    net_g = str(root / "netG.pth")
    tx.save_reference_checkpoint(
        net_g, 0, net_g=tx.export_stage1_g(st.g_params, st.g_stats, jcfg))
    data = str(root / "data")
    if variant == "clevr":
        write_synthetic_clevr(data, n=12, split="test", seed=5)
    else:
        write_synthetic_multimnist(data, n=12, split="test", seed=5)
    return variant, jcfg, pcfg, st, net_g, data


def _grids(out):
    return [np.asarray(Image.open(os.path.join(out, "samples",
                                               f"sample_{s:03d}.png")))
            for s in range(N_GRIDS)]


@pytest.mark.parametrize("surgery", [(None, None), (4, 1.3)],
                         ids=["layouts", "surgery"])
def test_first_row_of_each_grid_equals_the_jax_grids(family, surgery,
                                                     tmp_path, monkeypatch):
    variant, jcfg, pcfg, st, net_g, data = family
    args = argparse.Namespace(num_objects=surgery[0], bbox_scale=surgery[1])
    jc = jdefault_config(variant)
    jc.DATA_DIR = data
    jsample.sample_stage1(args, jc, jcfg, JStage1G(jcfg), str(tmp_path / "j"),
                          variant, seed=7, num_samples=N_GRIDS, state=st)

    def jax_noise(seed, s, n, z_dim):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), s)
        return np.asarray(jax.random.normal(key, (n, z_dim)))

    monkeypatch.setattr(psample, "sample_noise", jax_noise)
    pc = default_config(variant)
    pc.DATA_DIR = data
    pc.NET_G = net_g
    psample.sample_stage1(args, pc, pcfg, str(tmp_path / "p"), variant,
                          seed=7, num_samples=N_GRIDS, device="cpu")
    for got, want in zip(_grids(tmp_path / "p"), _grids(tmp_path / "j")):
        assert got.shape == want.shape == (2 * (TILE + PAD) + PAD,
                                           10 * (TILE + PAD) + PAD, 3)
        row = slice(0, TILE + PAD)
        levels = np.abs(got[row].astype(int) - want[row]).max()
        assert levels <= LEVELS, levels
        assert got[PAD:TILE + PAD, TILE + 2 * PAD:].std() > 1.0


def test_text_row_is_white_outside_its_text_and_dark_inside(family,
                                                            tmp_path):
    variant, _, pcfg, _, net_g, data = family
    pc = default_config(variant)
    pc.DATA_DIR = data
    pc.NET_G = net_g
    psample.sample_stage1(argparse.Namespace(), pc, pcfg, str(tmp_path),
                          variant, seed=7, num_samples=1, device="cpu")
    grid = np.asarray(Image.open(tmp_path / "samples" / "sample_000.png"))
    y0 = TILE + 2 * PAD
    strip = np.concatenate([grid[y0:y0 + TILE, PAD + i * (TILE + PAD):
                                 PAD + i * (TILE + PAD) + TILE]
                            for i in range(10)], axis=1)
    ds = psample.MultiMnistDataset(data, split="test") if \
        variant == "multi-mnist" else psample.ClevrDataset(
            data, split="test", hflip=False)
    item = ds[np.random.RandomState(7).randint(len(ds))]
    text = ", ".join(psample._caption_lines(item["label_onehot"], variant))
    assert text
    x, y = psample.TEXT_XY
    box = np.zeros(strip.shape[:2], bool)
    box[y:y + 7, x:x + GLYPH_ADVANCE * len(text)] = True
    dark = (strip < 128).all(-1)
    assert dark[box].any()
    assert (strip[~box] == 255).all()


@pytest.mark.parametrize("n_objects", [1, 2, 3, 5])
@pytest.mark.parametrize("variant", ["multi-mnist", "clevr"])
def test_layout_surgery_and_captions_equal_the_jax_ones(variant, n_objects):
    rs = np.random.RandomState(n_objects)
    if variant == "clevr":
        lab = np.zeros((4, 13), np.float32)
        lab[:, 3] = lab[:, 12] = 1.0
        bb = np.full((4, 4), -1.0, np.float32)
        for i in range(3):
            lab[i] = 0.0
            lab[i, rs.randint(3)] = lab[i, 4 + rs.randint(8)] = 1.0
            bb[i] = rs.uniform(0.1, 0.4, 4)
        label_dim = 13
    else:
        lab = np.eye(10, dtype=np.float32)[rs.randint(10, size=3)]
        bb = rs.uniform(0.1, 0.4, (3, 4)).astype(np.float32)
        label_dim = 10
    got = psample._layout_surgery(lab, bb, n_objects,
                                  np.random.RandomState(9), label_dim)
    want = jsample._layout_surgery(lab, bb, n_objects,
                                   np.random.RandomState(9), label_dim)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert psample._caption_lines(got[0], variant) == \
        jsample._caption_lines(want[0], variant)
    assert psample._caption_lines(lab, variant) == \
        jsample._caption_lines(lab, variant)


def test_validation_layouts_equal_the_jax_ones(tmp_path):
    write_synthetic_multimnist(str(tmp_path), n=6, split="test", seed=2)
    split = str(tmp_path / "test")
    for g, w in zip(psample.load_validation_layouts(split),
                    jsample.load_validation_layouts(split)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_net_g_neither_pth_nor_checkpoint_dir_warns(tmp_path, capsys):
    pcfg = dataclasses.replace(common.MNIST, gf_dim=8, df_dim=8)
    psample.load_generator(pcfg, str(tmp_path / "missing.pth"), 0, "cpu")
    assert "WARNING: NET_G=" in capsys.readouterr().out
    psample.load_generator(pcfg, str(tmp_path), 0, "cpu")
    assert "holds no checkpoint" in capsys.readouterr().out
