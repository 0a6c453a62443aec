"""The port's COCO StackGAN stage-2 sampler (``cli/stage2_runner.py:
sample_stage2``) against the JAX package's on the CPU, and its entry.

Both samplers run at gf 8, df 4 from one reference-format STAGE2_G
``.pth`` (He-scale weights, so that the images are not near constant, its
frozen G1 under ``STAGE1_G.``) on the JAX writer's test split: the
``val_captions.t7`` branch (the real image resized with PIL's LANCZOS,
grids named after the captions) and the test-split branch (the reader's
crop and flip). The port is given the JAX sampler's z, and for
``--stochastic_ca`` its CA eps, and every grid is held within 1 level.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from multiple_objects_gan_tpu.cli import stage2_runner as jax_s2
from multiple_objects_gan_tpu.config import config as jax_config
from multiple_objects_gan_tpu.data import coco as jax_coco
from multiple_objects_gan_tpu.models.stage1 import Stage1D, Stage1G
from multiple_objects_gan_tpu.models.stage2 import COCO_S2, Stage2D, Stage2G
from multiple_objects_gan_tpu.train.step import create_state
from multiple_objects_gan_tpu_torch.cli import main as port_main
from multiple_objects_gan_tpu_torch.cli.stage2_runner import (
    SAMPLE_FAKES, sample_inputs, sample_stage2)
from multiple_objects_gan_tpu_torch.config.config import (
    cfg_from_file, stage2_model_config)
from multiple_objects_gan_tpu_torch.data.png import read_png
from multiple_objects_gan_tpu_torch.models.stage1 import build_stage1_g
from multiple_objects_gan_tpu_torch.models.stage2 import build_stage2_g
from test_torch_port_stage2_step import _he_randomize

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
S2_EVAL = os.path.join(ROOT, "cfg", "coco_s2_eval.yml")
SEED = 4
GRIDS = 3


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _eval_cfg(path, net_g, data, imgs, stage1_g=""):
    """cfg/coco_s2_eval.yml at GF 8, DF 4 with NET_G, DATA_DIR, IMG_DIR
    (and STAGE1_G) set."""
    with open(S2_EVAL) as f:
        text = f.read()
    text = (text.replace("GF_DIM: 192", "GF_DIM: 8")
            .replace("DF_DIM: 96", "DF_DIM: 4")
            .replace("NET_G: 'models/model-coco-stackgan-stage-ii-0110.pth'",
                     f"NET_G: '{net_g}'\nSTAGE1_G: '{stage1_g}'")
            .replace("IMG_DIR: 'data/MS-COCO/test/val2014'",
                     f"IMG_DIR: '{imgs}'")
            .replace("DATA_DIR: 'data/MS-COCO'", f"DATA_DIR: '{data}'"))
    with open(path, "w") as f:
        f.write(text)
    return str(path)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The STAGE2_G .pth, the JAX writer's test split (with its t7) and a
    copy without the t7, and the eval cfg of each."""
    root = tmp_path_factory.mktemp("s2sample")
    cfg = cfg_from_file(S2_EVAL, "coco-stackgan-2")
    cfg.GAN.GF_DIM, cfg.GAN.DF_DIM = 8, 4
    s1, s2 = stage2_model_config(cfg)
    g1 = _he_randomize(build_stage1_g(s1, seed=1, device="cpu"), 3)
    g2 = _he_randomize(build_stage2_g(s2, seed=2, device="cpu"), 4)
    net_g = str(root / "netG_stage2.pth")
    torch.save({"netG": {**{f"STAGE1_G.{k}": v
                            for k, v in g1.state_dict().items()},
                         **g2.state_dict()}}, net_g)
    data, imgs = str(root / "data"), str(root / "imgs")
    jax_coco.write_synthetic_coco(data, imgs, n=8, split="test", seed=SEED)
    split = str(root / "data_split")
    shutil.copytree(data, split)
    os.remove(os.path.join(split, "test", "val_captions.t7"))
    return {"root": root, "net_g": net_g, "imgs": imgs,
            "t7": _eval_cfg(root / "t7.yml", net_g, data, imgs),
            "split": _eval_cfg(root / "split.yml", net_g, split, imgs)}


def _jax_sample(cfg_path, out, stochastic):
    """JAX sample_stage2 as its run_stage2 calls it (TRAIN.FLAG False),
    GRIDS grids."""
    cfg = jax_config.cfg_from_file(cfg_path, "coco-stackgan")
    s1_cfg = jax_config.stage1_model_config(cfg, "coco-stackgan")
    s2_cfg = dataclasses.replace(
        COCO_S2, gf_dim=int(cfg.GAN.GF_DIM), df_dim=int(cfg.GAN.DF_DIM),
        condition_dim=int(cfg.GAN.CONDITION_DIM),
        d_cond_dim=int(cfg.GAN.CONDITION_DIM),
        text_dim=int(cfg.TEXT.DIMENSION))
    r_num = int(cfg.GAN.R_NUM)
    g1, g2, d2 = Stage1G(s1_cfg), Stage2G(s2_cfg, r_num=r_num), \
        Stage2D(s2_cfg)
    s1_state = create_state(s1_cfg, g1, Stage1D(s1_cfg),
                            jax.random.PRNGKey(SEED), batch_size=2)
    s1_vars = {"params": s1_state.g_params,
               "batch_stats": s1_state.g_stats}
    args = argparse.Namespace(stochastic_ca=stochastic)
    jax_s2.sample_stage2(args, cfg, s1_cfg, s2_cfg, r_num, g1, g2, d2,
                         s1_vars, str(out), SEED, num_samples=GRIDS)
    return s1_cfg


def _jax_inputs(z_dim, c_dim, stochastic):
    """The JAX sampler's draws for grid s: z from fold_in(key, s), the CA
    eps from fold_in(key, 10000 + s) (both CA nets take that key)."""
    key = jax.random.PRNGKey(SEED)

    def inputs(s):
        z = np.asarray(jax.random.normal(jax.random.fold_in(key, s),
                                         (SAMPLE_FAKES, z_dim)))
        eps = (np.asarray(jax.random.normal(jax.random.fold_in(
            key, 10_000 + s), (SAMPLE_FAKES, c_dim))) if stochastic
            else None)
        return z, eps
    return inputs


@pytest.mark.parametrize("branch, stochastic", [
    ("t7", False), ("split", False), ("t7", True)],
    ids=["t7", "test-split", "t7-stochastic-ca"])
def test_sampler_grids_match_jax_within_one_level(world, branch,
                                                  stochastic):
    out_j, out_p = world["root"] / f"j_{branch}_{stochastic}", \
        world["root"] / f"p_{branch}_{stochastic}"
    js1 = _jax_sample(world[branch], out_j, stochastic)
    cfg = cfg_from_file(world[branch], "coco-stackgan-2")
    s1, s2 = stage2_model_config(cfg)
    assert (s1.z_dim, s1.condition_dim) == (js1.z_dim, js1.condition_dim)
    sample_stage2(cfg, s1, s2, str(out_p), seed=SEED, device="cpu",
                  stochastic_ca=stochastic, num_samples=GRIDS,
                  inputs=_jax_inputs(s1.z_dim, s1.condition_dim, stochastic))
    names = sorted(os.listdir(out_j / "samples"))
    assert names == sorted(os.listdir(out_p / "samples")) and names
    if branch == "t7":
        assert all(n.startswith("synthetic caption") for n in names)
    else:
        assert names == [f"sample_{s:03d}.png" for s in range(GRIDS)]
    for name in names:
        want = read_png(str(out_j / "samples" / name), "RGB")
        got = read_png(str(out_p / "samples" / name), "RGB")
        assert got.shape == want.shape == (256 + 4, 10 * 258 + 2, 3)
        assert np.abs(got.astype(np.int16) - want).max() <= 1, name
        # the real tile (LANCZOS or the reader's crop) is exact
        np.testing.assert_array_equal(got[2:258, 2:258], want[2:258, 2:258])
        assert want[2:258, 260:].std() > 5.0, "near-constant fakes"


def test_default_draws_are_seeded_and_stochastic_ca_only_adds_eps():
    z, eps = sample_inputs(7, 3, 100, 128, False)
    z2, eps2 = sample_inputs(7, 3, 100, 128, True)
    assert eps is None and eps2.shape == (SAMPLE_FAKES, 128)
    np.testing.assert_array_equal(z, z2)
    assert not np.array_equal(z, sample_inputs(7, 4, 100, 128, False)[0])


def test_entry_samples_25_grids_from_a_pth(world, capsys):
    """cli/main.py --variant coco-stackgan-2 with TRAIN.FLAG False and
    --synthetic: the test split written when missing (32 items with their
    t7), 25 grids of 10 tiles from the .pth ("Load from"); again with
    --stochastic_ca, which changes the fakes, not the real tiles; a NET_G
    naming nothing warns and samples seeded weights."""
    root = world["root"] / "entry"
    data, imgs = str(root / "data"), str(root / "imgs")
    root.mkdir()
    cfg = _eval_cfg(root / "eval.yml", world["net_g"], data, imgs)
    base = ["--variant", "coco-stackgan-2", "--cfg", cfg, "--synthetic",
            "--device", "cpu", "--manualSeed", "3"]
    assert port_main.main([*base, "--output_dir", str(root / "a")]) == []
    text = capsys.readouterr().out
    assert f"Load from: {world['net_g']}" in text
    assert "Total number of sentences: 32" in text
    assert "wrote 25 stage-2 sample grids" in text
    grids = sorted(os.listdir(root / "a" / "samples"))
    assert 0 < len(grids) <= 25
    assert all(g.startswith("synthetic caption") for g in grids)
    port_main.main([*base, "--output_dir", str(root / "b"),
                    "--stochastic_ca"])
    assert "stochastic CA" in capsys.readouterr().out
    for g in grids:
        a = read_png(str(root / "a" / "samples" / g), "RGB")
        b = read_png(str(root / "b" / "samples" / g), "RGB")
        np.testing.assert_array_equal(a[2:258, 2:258], b[2:258, 2:258])
        assert not np.array_equal(a[:, 260:], b[:, 260:])
    missing = _eval_cfg(root / "missing.yml", str(root / "nothing.pth"),
                        data, imgs)
    port_main.main(["--variant", "coco-stackgan-2", "--cfg", missing,
                    "--device", "cpu", "--manualSeed", "3", "--output_dir",
                    str(root / "c")])
    assert "WARNING: NET_G=" in capsys.readouterr().out
    assert len(os.listdir(root / "c" / "samples")) == len(grids)
