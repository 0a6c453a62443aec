"""AttnGAN's eval modes in the port on the CPU against the JAX package:
``cli/attngan_runner.py``'s ``sample`` and ``gen_example``.

The set is the JAX writer's synthetic set (n = 32: a test split of 8
items; its JPEGs for the JAX reader, the writer's own pixels for the
port), the cfg a copy of runs_r5/attngan_flagship/coco_attn_sampling.yml
at GF 4, R_NUM 1 and embedding 16 with NET_G and NET_E ``.pth`` files the
test writes from seeded port modules, which both packages load.

* ``load_example_captions`` equals the JAX one in its three cases;
* ``gen_example`` at the JAX z gives the JAX images of every scale and its
  attention maps at GNET_ATOL (tests/test_torch_port_attngan_model.py's
  tolerance for GNet at small widths), and the same files;
* ``cli/main.py`` with TRAIN.FLAG False and B_VALIDATION True runs
  ``sample``: rows of 10 tiles with white box edges, named as the JAX
  ``sample`` names them on the same test split; ``--eval_mode
  gen_example`` the per-scale images and montages; ``--eval_mode
  sampling`` the single-image dump and ``eval_metrics.json``
  (tests/test_torch_port_attngan_sampling.py holds its metrics);
* ``restore_g`` takes a port run directory's EMA weights.
"""

from __future__ import annotations

import argparse
import json
import os

import jax
import numpy as np
import pytest
import torch

from multiple_objects_gan_tpu.cli import attngan_runner as jrunner
from multiple_objects_gan_tpu.config.config import (
    cfg_from_file as jcfg_from_file)
from multiple_objects_gan_tpu.data import attngan as jdata
from multiple_objects_gan_tpu.io.damsm_import import import_text_encoder
from multiple_objects_gan_tpu.io.torch_import import (
    import_attngan_g, load_torch_checkpoint)
from multiple_objects_gan_tpu_torch.cli import attngan_runner
from multiple_objects_gan_tpu_torch.cli import main as port_main
from multiple_objects_gan_tpu_torch.config.config import (
    attngan_model_config, cfg_from_file)
from multiple_objects_gan_tpu_torch.data.attngan import AttnGanDataset
from multiple_objects_gan_tpu_torch.data.png import read_png
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.models.attngan import build_attngan_g
from multiple_objects_gan_tpu_torch.nn.encoders import build_text_encoder
from multiple_objects_gan_tpu_torch.train.state import create_attngan_state

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
SAMPLING_CFG = os.path.join(ROOT, "runs_r5", "attngan_flagship",
                            "coco_attn_sampling.yml")
GNET_ATOL = 5e-5
SEED = 3
N_ITEMS = 32
TEST_ITEMS = 8              # max(4, N_ITEMS // 4)
CAPTIONS = ["obj3 loc11 word2", "obj40 loc02 obj7 loc20 word9 word11",
            "word1 nothing known here obj5"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _highest_precision():
    prev = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", prev)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The set, a tiny sampling cfg naming a seeded G and text encoder
    (both .pth), and the port's config of it."""
    tmp = tmp_path_factory.mktemp("attngan_eval")
    data, imgs = str(tmp / "data"), str(tmp / "imgs")
    jdata.write_synthetic_attngan(data, imgs, n=N_ITEMS, seed=SEED)
    n_words = AttnGanDataset(data, "test").n_words
    with open(SAMPLING_CFG) as f:
        text = f.read()
    cfg_text = (text.replace("GF_DIM: 48", "GF_DIM: 4")
                .replace("DF_DIM: 96", "DF_DIM: 4")
                .replace("R_NUM: 3", "R_NUM: 1")
                .replace("EMBEDDING_DIM: 256", "EMBEDDING_DIM: 16")
                .replace("DATA_DIR: 'data/coco/coco'", f"DATA_DIR: '{data}'")
                .replace("IMG_DIR: 'data/MS-COCO/train/train2014'",
                         f"IMG_DIR: '{imgs}'"))
    cfg_file = tmp / "coco_attn_sampling.yml"
    cfg_file.write_text(cfg_text)
    mcfg = attngan_model_config(cfg_from_file(str(cfg_file),
                                              "coco-attngan"))
    net_g, net_e = str(tmp / "netG.pth"), str(tmp / "text_encoder5.pth")
    torch.save({"netG": build_attngan_g(mcfg, seed=4,
                                        device="cpu").state_dict()}, net_g)
    torch.save(build_text_encoder(n_words, 16, seed=5,
                                  device="cpu").state_dict(), net_e)
    lines = []
    for line in cfg_text.splitlines():
        key = line.strip().split(":")[0]
        if key in ("NET_G", "NET_E"):
            line = f"    {key}: '{net_g if key == 'NET_G' else net_e}'"
        lines.append(line)
    cfg_file.write_text("\n".join(lines) + "\n")
    return {"tmp": tmp, "data": data, "imgs": imgs, "cfg": str(cfg_file),
            "mcfg": mcfg, "net_g": net_g, "net_e": net_e}


def jax_side(world):
    """The JAX runner's modules, G variables and text variables of the
    world's files (the JAX restore_g / init_encoders imports)."""
    cfg = jcfg_from_file(world["cfg"], "coco-attngan")
    ds = jdata.AttnGanDataset(world["data"], world["imgs"], split="test",
                              base_size=64, branch_num=3,
                              captions_per_image=5, words_num=12, seed=SEED)
    mcfg, g, d_modules, text_enc, _ = jrunner.build_all(cfg, ds.n_words)
    params, stats = import_attngan_g(load_torch_checkpoint(world["net_g"]),
                                     branch_num=3, r_num=1)
    tvars = import_text_encoder(world["net_e"], {"params": {}})
    return cfg, ds, mcfg, g, d_modules, text_enc, {"text": tvars}, params, \
        stats


# --------------------------------------------------------- the captions


def _write(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("case", ["filenames", "captions", "built_in"])
def test_load_example_captions_matches_jax(tmp_path, case, capsys):
    if case == "filenames":
        os.makedirs(tmp_path / "sub")
        _write(tmp_path / "example_filenames.txt",
               ["sub/first", "", "missing", "second"])
        _write(tmp_path / "sub" / "first.txt", ["a red cube", "", "two"])
        _write(tmp_path / "second.txt", ["one more"])
        _write(tmp_path / "example_captions.txt", ["not read"])
    elif case == "captions":
        _write(tmp_path / "example_captions.txt", ["x y", "", "z"])
    got = attngan_runner.load_example_captions(str(tmp_path))
    port_out = capsys.readouterr().out
    assert got == jrunner.load_example_captions(str(tmp_path))
    assert port_out == capsys.readouterr().out
    assert list(got) == {"filenames": ["first", "second"],
                         "captions": ["example_captions"],
                         "built_in": ["gen_example"]}[case]


# ---------------------------------------------------------- gen_example


def test_gen_example_matches_jax(world):
    """Three captions (one with out-of-vocabulary words) at the JAX z:
    every scale's image and both attention stages at GNET_ATOL; the same
    file names, and PNGs of the same size."""
    cfg, ds, mcfg, g, _, text_enc, enc_vars, params, stats = \
        jax_side(world)
    out_j, out_p = str(world["tmp"] / "gen_jax"), str(world["tmp"] /
                                                     "gen_port")
    want = jrunner.gen_example(cfg, CAPTIONS, ds, mcfg, g, text_enc,
                               enc_vars, params, stats, out_j, seed=SEED,
                               key="k")
    z = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(SEED), (len(CAPTIONS), mcfg.z_dim))))
    pg = attngan_runner.restore_g(world["net_g"], world["mcfg"], seed=0,
                                  device="cpu")
    pds = AttnGanDataset(world["data"], "test")
    text, _, _ = attngan_runner.init_encoders(
        world["net_e"], pds.n_words, world["mcfg"], seed=0, device="cpu",
        with_image=False)
    imgs, atts = attngan_runner.gen_example(
        CAPTIONS, pds, world["mcfg"], pg, text, out_p, words_num=12,
        seed=SEED, device="cpu", key="k", z=z)
    assert len(imgs) == 3 and len(atts) == 2
    for i, (got, w) in enumerate(zip(imgs, want["imgs"])):
        np.testing.assert_allclose(got, np.asarray(w), atol=GNET_ATOL,
                                   err_msg=f"image {i}")
    for i, (got, w) in enumerate(zip(atts, want["att_maps"])):
        np.testing.assert_allclose(got, np.asarray(w), atol=GNET_ATOL,
                                   err_msg=f"attention {i}")
    names = sorted(os.listdir(os.path.join(out_p, "k")))
    assert names == sorted(os.listdir(os.path.join(out_j, "k")))
    assert len(names) == len(CAPTIONS) * 5
    for name in names:
        got = read_png(os.path.join(out_p, "k", name), "RGB")
        if "_g" in name:
            side = 64 * 2 ** int(name[-5])
            assert got.shape == (side, side, 3), name
    grid = read_png(os.path.join(out_p, "k.png"), "RGB")
    assert grid.shape == (258 + 2, 4 * 258 + 2, 3)     # 4 a row


# ------------------------------------------------------ the entry, sample


def _main(world, out, *extra):
    return port_main.main(["--variant", "coco-attngan", "--cfg",
                           world["cfg"], "--output_dir", out,
                           "--manualSeed", str(SEED), "--device", "cpu",
                           *extra])


def test_sample_through_the_entry_matches_jax_names(world, capsys,
                                                    monkeypatch):
    """B_VALIDATION True: one 10-tile row a test item (256px tiles), the
    boxes' edges white, named as the JAX sample names them; G and NET_E
    loaded, no WARNING. The JAX sampler takes NET_G's import directly (its
    restore_g would first init three Ds it does not use)."""
    out = str(world["tmp"] / "sample_port")
    assert _main(world, out) == []
    printed = capsys.readouterr().out
    assert "coco-attngan sample on cpu" in printed
    assert "WARNING" not in printed
    assert f"Saved {TEST_ITEMS} files to" in printed
    cfg, ds, mcfg, g, d_modules, text_enc, enc_vars, params, stats = \
        jax_side(world)
    monkeypatch.setattr(jrunner, "restore_g",
                        lambda *args, **kwargs: (params, stats))
    jdir = jrunner.sample(argparse.Namespace(), cfg, ds, mcfg, g, d_modules,
                          text_enc, enc_vars, str(world["tmp"] /
                                                  "sample_jax"), SEED)
    names = sorted(os.listdir(os.path.join(out, "samples")))
    assert names == sorted(os.listdir(jdir))
    assert len(names) == TEST_ITEMS
    assert all(n.rsplit("_", 1)[1][:-4].isdigit() for n in names)
    first = [n for n in names if n.endswith("_0.png")][0]
    row = read_png(os.path.join(out, "samples", first), "RGB")
    assert row.shape == (258 + 2, 10 * 258 + 2, 3)
    tiles = [row[2:258, 2 + 258 * i:258 * (i + 1)] for i in range(10)]
    white = [int((t == 255).all(axis=-1).sum()) for t in tiles]
    assert min(white) > 100, white


def test_gen_example_and_sampling_through_the_entry(world, capsys,
                                                    monkeypatch):
    with open(os.path.join(world["data"], "example_captions.txt"),
              "w") as f:
        f.write("\n".join(CAPTIONS[:2]) + "\n")
    out = str(world["tmp"] / "gen_entry")
    try:
        assert _main(world, out, "--eval_mode", "gen_example") == []
    finally:
        os.remove(os.path.join(world["data"], "example_captions.txt"))
    assert "coco-attngan gen_example on cpu" in capsys.readouterr().out
    assert sorted(os.listdir(os.path.join(out, "example_captions"))) == \
        sorted(f"0_s_{j}_{k}.png" for j in range(2)
               for k in ("g0", "g1", "g2", "a0", "a1"))
    assert os.path.isfile(os.path.join(out, "example_captions.png"))
    # sampling: two images, their features at batch 2, the host FID's
    # matrix root (tens of seconds at 2048) left to the sampling tests
    monkeypatch.setattr(attngan_runner, "FID_BATCH", 2)
    monkeypatch.setattr(attngan_runner, "fid_from_activations",
                        lambda real, fake: 0.0)
    out = str(world["tmp"] / "sampling")
    assert _main(world, out, "--eval_mode", "sampling", "--num_images",
                 "2") == []
    assert "coco-attngan sampling on cpu" in capsys.readouterr().out
    assert sorted(os.listdir(os.path.join(out, "single_samples"))) == [
        "s_000000.png", "s_000001.png"]
    with open(os.path.join(out, "eval_metrics.json")) as f:
        metrics = json.load(f)
    assert metrics["n_images"] == 2 and metrics["fid_encoder"] == "random"


def test_restore_g_takes_a_run_directorys_ema(world, tmp_path, capsys):
    """A port run directory: its latest checkpoint's G with the EMA in
    place of the parameters; a missing NET_G warns and gives the seeded
    init."""
    mcfg = world["mcfg"]
    state = create_attngan_state(mcfg, seed=1, device="cpu")
    with torch.no_grad():
        for v in state.g_ema.values():
            v.add_(0.5)
    CheckpointManager(str(tmp_path / "run" / "models")).save(4, state)
    g = attngan_runner.restore_g(str(tmp_path / "run"), mcfg, seed=0,
                                 device="cpu")
    assert "(epoch 4, EMA weights)" in capsys.readouterr().out
    for k, v in g.named_parameters():
        assert torch.equal(v, state.g_ema[k]), k
    for k, v in g.named_buffers():
        assert torch.equal(v, state.g.state_dict()[k]), k
    assert not g.training
    g0 = attngan_runner.restore_g(str(tmp_path / "none.pth"), mcfg, seed=2,
                                  device="cpu")
    assert "WARNING: TRAIN.NET_G=" in capsys.readouterr().out
    want = build_attngan_g(mcfg, seed=2, device="cpu").state_dict()
    for k, v in g0.state_dict().items():
        assert torch.equal(v, want[k]), k
