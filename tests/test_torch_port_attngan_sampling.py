"""AttnGAN's ``--eval_mode sampling`` in the port on the CPU
(``cli/attngan_runner.py:sampling``), on the port writer's synthetic COCO
split on disk (n = 16: a test split of 4 items with their 268x268 JPEGs),
from a copy of runs_r5/attngan_flagship/coco_attn_sampling.yml at GF 4,
R_NUM 1, embedding 16, with NET_G and NET_E ``.pth`` files the test writes
from seeded port modules (and ``image_encoder5.pth`` beside NET_E).

* ``sampling`` with an injected z: its PNGs are the G's images at that z
  (0 levels), its FID equals JAX's ``fid_from_activations`` on the
  activations the dump kept (rtol 1e-12: the same numpy/scipy calls),
  its IS JAX's ``inception_score`` on them, and its features equal the
  DAMSM encoder's pool of those images at atol 1e-6;
* ``cli/main.py --eval_mode sampling`` writes ``single_samples/`` and
  ``eval_metrics.json`` with JAX's seven keys and provenance strings:
  ``random`` (no NET_E), ``damsm`` (NET_E and its image encoder) and
  ``fid_canonical`` ($FID_INCEPTION_WEIGHTS at a seeded pt_inception
  file: FID on the canonical encoder, IS on the DAMSM backbone);
  ``--num_images`` truncates inside a batch; a batch larger than the
  split is clamped with JAX's message.

The entry runs take the Inception forwards at ``FID_BATCH`` 2 (the
activations do not depend on the batch) and replace the host FID by a
recorder: its 2048-square matrix root takes tens of seconds on the CPU,
and the first case holds the real one.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from multiple_objects_gan_tpu.utils import metrics as jm
from multiple_objects_gan_tpu_torch.cli import attngan_runner
from multiple_objects_gan_tpu_torch.cli import main as port_main
from multiple_objects_gan_tpu_torch.config.config import (
    attngan_model_config, attngan_train_settings, cfg_from_file)
from multiple_objects_gan_tpu_torch.data.attngan import (
    AttnGanDataset, attngan_split, write_synthetic_attngan)
from multiple_objects_gan_tpu_torch.data.png import read_png
from multiple_objects_gan_tpu_torch.models.attngan import build_attngan_g
from multiple_objects_gan_tpu_torch.nn.encoders import (
    build_image_encoder, build_text_encoder)
from multiple_objects_gan_tpu_torch.nn.fid_inception import FIDInceptionV3
from multiple_objects_gan_tpu_torch.utils import metrics as pm
from multiple_objects_gan_tpu_torch.utils.images import tile_uint8
from test_cnn_encoder_parity import _randomize

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
SAMPLING_CFG = os.path.join(ROOT, "runs_r5", "attngan_flagship",
                            "coco_attn_sampling.yml")
JAX_KEYS = {"fid", "inception_score_mean", "inception_score_std",
            "n_images", "is_head", "is_backbone", "fid_encoder"}
SEED = 3
TEST_ITEMS = 4              # max(4, 16 // 4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads and two BLAS threads: the host FID's matrix root
    gains little from more, and the suite runs six files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(2):
        yield
    torch.set_num_threads(n)


def _cfg(path, data, imgs, net_g, net_e, batch):
    with open(SAMPLING_CFG) as f:
        text = f.read()
    text = (text.replace("GF_DIM: 48", "GF_DIM: 4")
            .replace("DF_DIM: 96", "DF_DIM: 4")
            .replace("R_NUM: 3", "R_NUM: 1")
            .replace("EMBEDDING_DIM: 256", "EMBEDDING_DIM: 16")
            .replace("BATCH_SIZE: 14", f"BATCH_SIZE: {batch}")
            .replace("DATA_DIR: 'data/coco/coco'", f"DATA_DIR: '{data}'")
            .replace("IMG_DIR: 'data/MS-COCO/train/train2014'",
                     f"IMG_DIR: '{imgs}'"))
    lines = []
    for line in text.splitlines():
        key = line.strip().split(":")[0]
        if key in ("NET_G", "NET_E"):
            line = f"    {key}: '{net_g if key == 'NET_G' else net_e}'"
        lines.append(line)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("attngan_sampling")
    data, imgs = str(tmp / "data"), str(tmp / "imgs")
    write_synthetic_attngan(data, imgs, n=16, seed=SEED)
    n_words = AttnGanDataset(data, "test").n_words
    cfg_file = _cfg(tmp / "probe.yml", data, imgs, "", "", 2)
    mcfg = attngan_model_config(cfg_from_file(cfg_file, "coco-attngan"))
    net_g, net_e = str(tmp / "netG.pth"), str(tmp / "text_encoder5.pth")
    torch.save({"netG": build_attngan_g(mcfg, seed=4,
                                        device="cpu").state_dict()}, net_g)
    torch.save(build_text_encoder(n_words, 16, seed=5,
                                  device="cpu").state_dict(), net_e)
    torch.save(_randomize(build_image_encoder(16, seed=6, device="cpu"),
                          seed=6).state_dict(),
               str(tmp / "image_encoder5.pth"))
    return {"tmp": tmp, "data": data, "imgs": imgs, "mcfg": mcfg,
            "net_g": net_g, "net_e": net_e,
            "cfg": lambda name, batch=2, net_e=net_e: _cfg(
                tmp / f"{name}.yml", data, imgs, net_g, net_e, batch)}


def test_sampling_fid_is_jaxs_on_the_dumps_activations(world, capsys,
                                                      monkeypatch):
    """One batch of the 4 test items at an injected z, real encoders,
    the features 4 images a forward."""
    monkeypatch.setattr(attngan_runner, "FID_BATCH", TEST_ITEMS)
    cfg = cfg_from_file(world["cfg"]("direct", batch=TEST_ITEMS),
                        "coco-attngan")
    mcfg, st = world["mcfg"], attngan_train_settings(cfg)
    ds = attngan_split(cfg.DATA_DIR, cfg.IMG_DIR, st, SEED, "test")
    text, image, prov = attngan_runner.init_encoders(
        st.net_e, ds.n_words, mcfg, seed=SEED, device="cpu",
        float32_image=True)
    g = attngan_runner.restore_g(st.net_g, mcfg, seed=SEED, device="cpu")
    z = torch.from_numpy(np.random.RandomState(8).randn(
        TEST_ITEMS, mcfg.z_dim).astype(np.float32))
    calls = []

    def noise(written, bs):
        calls.append((written, bs))
        return z

    out = str(world["tmp"] / "direct")
    res = attngan_runner.sampling(
        ds, mcfg, g, text, image, out, image_prov=prov["image_encoder"],
        batch_size=st.batch_size, seed=SEED, device="cpu", noise=noise)
    assert calls == [(0, TEST_ITEMS)]
    m = res["metrics"]
    with open(os.path.join(out, "eval_metrics.json")) as f:
        assert json.load(f) == m
    assert set(m) == JAX_KEYS
    assert (m["fid_encoder"], m["is_backbone"], m["is_head"]) == (
        "damsm", "imported", "random")
    assert m["n_images"] == TEST_ITEMS
    assert m["fid"] == pytest.approx(
        jm.fid_from_activations(res["real_acts"], res["fake_acts"]),
        rel=1e-12)
    assert (m["inception_score_mean"], m["inception_score_std"]) == \
        jm.inception_score(None, None, acts=res["fake_acts"])
    assert f"FID: {m['fid']:.3f}" in capsys.readouterr().out

    # the same batch again, from a fresh reader's draws: G's images at z,
    # and their DAMSM pool at the dump's batch
    ds2 = attngan_split(cfg.DATA_DIR, cfg.IMG_DIR, st, SEED, "test")
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in ds2.get_batch(np.arange(TEST_ITEMS)).items()}
    with torch.no_grad():
        words, sent = text(batch["captions"], batch["cap_lens"])
        fakes = g(z, sent, words, batch["captions"] == 0, batch["bbox"],
                  batch["label_onehot"]).permute(0, 2, 3, 1)
    names = sorted(os.listdir(res["dir"]))
    assert names == [f"s_{i:06d}.png" for i in range(TEST_ITEMS)]
    for i, name in enumerate(names):
        np.testing.assert_array_equal(
            read_png(os.path.join(res["dir"], name), "RGB"),
            tile_uint8(fakes[i].numpy()))
    np.testing.assert_allclose(
        res["fake_acts"], pm.inception_activations(image, fakes, TEST_ITEMS),
        atol=1e-6, rtol=1e-5)
    reals = batch["image256"].float() / 127.5 - 1.0
    np.testing.assert_allclose(
        res["real_acts"], pm.inception_activations(image, reals, TEST_ITEMS),
        atol=1e-6, rtol=1e-5)
    assert res["real_acts"].std() > 0 and res["fake_acts"].std() > 0


@pytest.fixture
def recorded(monkeypatch):
    """FID_BATCH 2 and the host FID replaced by a recorder of its inputs
    (the real one is held above)."""
    monkeypatch.setattr(attngan_runner, "FID_BATCH", 2)
    seen = []

    def fid(real, fake):
        seen.append((real, fake))
        return float(np.abs(real.mean(0) - fake.mean(0)).sum())

    monkeypatch.setattr(attngan_runner, "fid_from_activations", fid)
    return seen


def _entry(world, name, *extra, batch=2, net_e=None):
    out = str(world["tmp"] / name)
    cfg = world["cfg"](name, batch, world["net_e"] if net_e is None
                       else net_e)
    assert port_main.main(["--variant", "coco-attngan", "--cfg", cfg,
                           "--output_dir", out, "--manualSeed", str(SEED),
                           "--device", "cpu", "--eval_mode", "sampling",
                           *extra]) == []
    with open(os.path.join(out, "eval_metrics.json")) as f:
        metrics = json.load(f)
    return out, metrics, sorted(os.listdir(os.path.join(out,
                                                        "single_samples")))


@pytest.mark.parametrize("prov", ["random", "damsm", "fid_canonical"])
def test_entry_writes_jax_keys_and_provenance(world, recorded, prov,
                                              monkeypatch, capsys):
    monkeypatch.delenv("FID_INCEPTION_WEIGHTS", raising=False)
    monkeypatch.delenv("INCEPTION_V3_WEIGHTS", raising=False)
    if prov == "fid_canonical":
        pth = str(world["tmp"] / "pt_inception.pth")
        if not os.path.isfile(pth):
            torch.save(_randomize(FIDInceptionV3(), seed=11).state_dict(),
                       pth)
        monkeypatch.setenv("FID_INCEPTION_WEIGHTS", pth)
    sweeps = []
    acts = attngan_runner.inception_activations
    monkeypatch.setattr(attngan_runner, "inception_activations",
                        lambda enc, *a: sweeps.append(type(enc).__name__)
                        or acts(enc, *a))
    out, m, names = _entry(world, prov, "--num_images", "2",
                           net_e="" if prov == "random" else None)
    printed = capsys.readouterr().out
    assert set(m) == JAX_KEYS
    assert (m["fid_encoder"], m["is_backbone"], m["is_head"]) == {
        "random": ("random", "random", "random"),
        "damsm": ("damsm", "imported", "random"),
        "fid_canonical": ("fid_canonical", "imported", "random")}[prov]
    assert names == ["s_000000.png", "s_000001.png"] and m["n_images"] == 2
    assert read_png(os.path.join(out, "single_samples", names[0]),
                    "RGB").shape == (256, 256, 3)
    (real, fake), = recorded
    assert real.shape == fake.shape == (2, 2048)
    assert m["fid"] == float(np.abs(real.mean(0) - fake.mean(0)).sum())
    fid_net = ("FIDInceptionV3" if prov == "fid_canonical"
               else "CNNEncoder")
    # FID's two sweeps, then IS's own only on the canonical path
    assert sweeps == [fid_net, fid_net] + (
        ["CNNEncoder"] if prov == "fid_canonical" else [])
    assert "coco-attngan sampling on cpu" in printed
    assert "wrote 2 single images to" in printed
    assert ("WARNING: IS is not comparable" in printed)


def test_entry_num_images_truncates_and_batch_clamps(world, recorded,
                                                     capsys):
    """--num_images 3 at batch 2: the second batch gives 1 of its 2; a
    cfg batch of 6 over the 4-item split is clamped to 4."""
    _, m, names = _entry(world, "truncated", "--num_images", "3")
    assert names == [f"s_{i:06d}.png" for i in range(3)]
    assert m["n_images"] == 3 and recorded[-1][0].shape == (3, 2048)
    assert "clamping" not in capsys.readouterr().out
    _, m, names = _entry(world, "clamped", batch=6)
    assert (f"sampling(): batch 6 > test split {TEST_ITEMS} — clamping to "
            f"{TEST_ITEMS}") in capsys.readouterr().out
    assert len(names) == m["n_images"] == TEST_ITEMS
