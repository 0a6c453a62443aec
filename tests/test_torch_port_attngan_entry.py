"""The port's AttnGAN train entry on the CPU: the in-memory train set
against the JAX reader, the config, the encoders and the warm start, and
``cli/main.py --variant coco-attngan --synthetic`` with its artifacts,
``run_flags.json`` and a resume; and the float32 policy both entries
apply.

The train set is held bit for bit against the JAX ``AttnGanDataset``:
the JAX writer's set, its JPEGs overwritten by PNGs of the writer's own
pixels under the same names (PIL opens by content), so that the JAX
reader sees the pixels the port holds in memory; the same indices in the
``Loader``'s order for two epochs, WORDS_NUM cut to 5 so that long
captions are subsampled. The entry runs a copy of cfg/coco_attn_train.yml
at gf 4, df 4, embedding 16, R_NUM 1 and batch 8 (32 synthetic items, 4
steps an epoch) with the image encoder replaced by the stand-in of
tests/test_torch_port_attngan_step.py (the Inception-v3 encoder is held
in tests/test_torch_port_attngan_d.py; here it is only built, from
runs_r5's image_encoder29.pth); the resumed run equals an uninterrupted
one bit for bit: checkpoint, log and images.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from multiple_objects_gan_tpu.data import attngan as jdata
from multiple_objects_gan_tpu_torch import float32_policy
from multiple_objects_gan_tpu_torch.cli import attngan_runner
from multiple_objects_gan_tpu_torch.cli import main as port_main
from multiple_objects_gan_tpu_torch.config.config import (
    attngan_model_config, attngan_train_settings, cfg_from_file)
from multiple_objects_gan_tpu_torch.data import attngan as pdata
from multiple_objects_gan_tpu_torch.data.datasets import Loader
from multiple_objects_gan_tpu_torch.data.png import read_png
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.models.attngan import build_attngan_d
from multiple_objects_gan_tpu_torch.nn.encoders import (
    CNNEncoder, build_text_encoder)
from multiple_objects_gan_tpu_torch.train.state import create_attngan_state
from test_torch_port_attngan_step import TinyImageEncoder

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
ATTN_TRAIN = os.path.join(ROOT, "cfg", "coco_attn_train.yml")
DAMSM = os.path.join(ROOT, "runs_r5", "attngan_flagship", "damsm",
                     "DAMSMencoders")
NET_E = os.path.join(DAMSM, "text_encoder29.pth")
SEED = 3
BATCH = 8


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cfg(tmp_path, data_dir, net_g="", net_e="", b_net_d=True,
             name="coco_attn_train.yml"):
    """cfg/coco_attn_train.yml at GF 4, DF 4, embedding 16, R_NUM 1, batch
    8, with DATA_DIR, NET_G, NET_E and B_NET_D set."""
    with open(ATTN_TRAIN) as f:
        text = f.read()
    text = (text.replace("BATCH_SIZE: 14", f"BATCH_SIZE: {BATCH}")
            .replace("GF_DIM: 48", "GF_DIM: 4")
            .replace("DF_DIM: 96", "DF_DIM: 4")
            .replace("R_NUM: 3", "R_NUM: 1")
            .replace("EMBEDDING_DIM: 256", "EMBEDDING_DIM: 16")
            .replace("DATA_DIR: 'data/coco/coco'", f"DATA_DIR: '{data_dir}'")
            .replace("NET_G: ''", f"NET_G: '{net_g}'")
            .replace("B_NET_D: True", f"B_NET_D: {b_net_d}")
            .replace("NET_E: 'DAMSMencoders/coco/text_encoder100.pth'",
                     f"NET_E: '{net_e}'"))
    path = tmp_path / name
    path.write_text(text)
    return str(path)


# ------------------------------------------------------------ the data


def test_train_set_matches_the_jax_reader_bit_for_bit(tmp_path):
    """Two epochs of the port's AttnGanTrainSet in the Loader's order
    against the JAX reader, both reading the JAX writer's JPEGs from disk
    (the port's own decoder against PIL): every image at 64, 128 and 256,
    the rescaled boxes, one-hots, captions (subsampled to 5 words where
    longer), lengths and class ids; a missing JPEG raises with its path."""
    data, imgs = str(tmp_path / "data"), str(tmp_path / "imgs")
    jdata.write_synthetic_attngan(data, imgs, n=16, seed=SEED)
    jds = jdata.AttnGanDataset(data, imgs, split="train", words_num=5,
                               seed=SEED)
    pds = pdata.AttnGanTrainSet(data, imgs, words_num=5, seed=SEED)
    loader = Loader(pds, 4, seed=SEED)
    subsampled = 0
    for epoch in range(2):
        order = np.arange(16)
        np.random.RandomState(SEED + epoch).shuffle(order)
        batches = list(loader.epoch(epoch))
        assert len(batches) == 4
        for b, got in enumerate(batches):
            items = [jds[int(i)] for i in order[4 * b:4 * b + 4]]
            for k in items[0]:
                want = np.stack([it[k] for it in items])
                assert got[k].shape == want.shape, k
                np.testing.assert_array_equal(got[k], want, err_msg=k)
            subsampled += int((got["cap_lens"] == 5).sum())
    assert subsampled > 0
    os.remove(os.path.join(imgs, "train_00003.jpg"))
    with pytest.raises(FileNotFoundError, match="train_00003.jpg"):
        pds.get_batch([2, 3])


def test_config_reads_cfg_coco_attn_train():
    cfg = cfg_from_file(ATTN_TRAIN, "coco-attngan")
    st = attngan_train_settings(cfg)
    assert (st.batch_size, st.max_epoch, st.snapshot_interval,
            st.words_num, st.captions_per_image, st.base_size,
            st.branch_num, st.b_net_d) == (14, 120, 5, 12, 5, 64, 3, True)
    assert st.smooth == {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0,
                         "LAMBDA": 50.0}
    mcfg = attngan_model_config(cfg)
    assert (mcfg.gf_dim, mcfg.df_dim, mcfg.r_num, mcfg.embedding_dim) == (
        48, 96, 3, 256)


# -------------------------------------------------- encoders, warm start


def test_init_encoders_reads_net_e_and_its_image_encoder(tmp_path, capsys):
    """NET_E's text encoder keeps its 140 rows over a smaller vocabulary;
    the image encoder beside it is image_encoder29.pth; a NET_E without an
    image encoder beside it, and a missing NET_E, give WARNINGs and random
    weights."""
    mcfg = attngan_model_config(cfg_from_file(ATTN_TRAIN, "coco-attngan"))
    text, image, prov = attngan_runner.init_encoders(
        NET_E, 60, mcfg, seed=0, device="cpu")
    assert prov == {"text_encoder": "imported", "image_encoder": "imported"}
    assert text.encoder.weight.shape[0] == 140
    assert isinstance(image, CNNEncoder) and not image.training
    assert not any(p.requires_grad for p in image.parameters())
    lone = tmp_path / "text_encoder29.pth"
    lone.write_bytes(open(NET_E, "rb").read())
    _, _, prov = attngan_runner.init_encoders(str(lone), 60, mcfg, seed=0,
                                              device="cpu")
    assert prov == {"text_encoder": "imported", "image_encoder": "random"}
    _, _, prov = attngan_runner.init_encoders("", 60, mcfg, seed=0,
                                              device="cpu")
    assert prov == {"text_encoder": "random", "image_encoder": "random"}
    out = capsys.readouterr().out
    assert "Load image encoder from:" in out
    assert "image_encoder29.pth' not found" in out
    assert "WARNING: NET_E='' not found" in out
    with pytest.raises(ValueError, match="embeds 140 words"):
        attngan_runner.init_encoders(NET_E, 141, mcfg, seed=0, device="cpu")


def _tiny_mcfg(tmp_path):
    return attngan_model_config(cfg_from_file(
        tiny_cfg(tmp_path, "unused"), "coco-attngan"))


def test_warm_start_loads_g_and_its_ema_and_the_ds_it_finds(tmp_path,
                                                           capsys):
    """A NET_G .pth loads G and seeds the EMA; its netD0.pth loads d64; the
    missing netD1/netD2 give WARNINGs; a NET_G_<epoch>.pth gives the start
    epoch; B_NET_D False reads no D."""
    mcfg = _tiny_mcfg(tmp_path)
    src = create_attngan_state(mcfg, seed=11, device="cpu")
    net_g = tmp_path / "netG_epoch_6.pth"
    torch.save({"netG": src.g.state_dict()}, net_g)
    torch.save(build_attngan_d(mcfg, 64, seed=12, device="cpu").state_dict(),
               tmp_path / "netD0.pth")
    state = create_attngan_state(mcfg, seed=0, device="cpu")
    d128 = {k: v.clone() for k, v in state.ds["d128"].state_dict().items()}
    assert attngan_runner.maybe_warm_start_attngan(state, str(net_g)) == 7
    for k, v in src.g.state_dict().items():
        assert torch.equal(state.g.state_dict()[k], v), k
    for k, p in src.g.named_parameters():
        assert torch.equal(state.g_ema[k], p), k
    want = build_attngan_d(mcfg, 64, seed=12, device="cpu").state_dict()
    for k, v in want.items():
        assert torch.equal(state.ds["d64"].state_dict()[k], v), k
    for k, v in d128.items():
        assert torch.equal(state.ds["d128"].state_dict()[k], v), k
    out = capsys.readouterr().out
    assert f"Load G from: {net_g}" in out and "netD0.pth" in out
    assert out.count("WARNING") == 2 and "netD2.pth not found" in out
    fresh = create_attngan_state(mcfg, seed=0, device="cpu")
    assert attngan_runner.maybe_warm_start_attngan(
        fresh, str(net_g), b_net_d=False) == 7
    assert "WARNING" not in capsys.readouterr().out
    assert attngan_runner.maybe_warm_start_attngan(fresh, "") == 0


# ------------------------------------------------------------ the entry


@pytest.fixture
def stand_in_encoder(monkeypatch):
    """The image encoder of the entry: the step test's stand-in."""
    monkeypatch.setattr(attngan_runner, "build_image_encoder",
                        lambda *a, **k: TinyImageEncoder())


def _main(cfg, out, *flags):
    return port_main.main(["--variant", "coco-attngan", "--cfg", cfg,
                           "--synthetic", "--manualSeed", str(SEED),
                           "--device", "cpu", "--output_dir", str(out),
                           "--img_dir",
                           os.path.join(os.path.dirname(cfg), "imgs"),
                           *flags])


def _files(run):
    """The run's images but real_samples.png, and its logged scalars
    without their wall-clock times."""
    out = {}
    for name in os.listdir(os.path.join(run, "images")):
        if name != "real_samples.png":
            with open(os.path.join(run, "images", name), "rb") as f:
                out[name] = f.read()
    with open(os.path.join(run, "logs", "metrics.jsonl")) as f:
        out["metrics"] = [{k: v for k, v in json.loads(line).items()
                           if k != "time"} for line in f]
    return out


def test_entry_trains_resumes_and_equals_an_uninterrupted_run(
        tmp_path, capsys, stand_in_encoder, monkeypatch):
    """One epoch with a NET_G warm start (B_NET_D False) and a NET_E text
    encoder at the tiny width (150 rows; no image encoder beside it, so
    that one is random after a WARNING), then a resume in place to epoch
    2: the artifacts, run_flags.json with the encoders' provenance, the
    float32 policy applied, and the resumed run equal bit for bit to two
    straight epochs."""
    calls = []
    monkeypatch.setattr(port_main, "float32_policy",
                        lambda *a: calls.append(a))
    mcfg = _tiny_mcfg(tmp_path)
    net_g = tmp_path / "netG_ema_final.pth"
    torch.save({"netG": create_attngan_state(mcfg, seed=11, device="cpu")
                .g.state_dict()}, net_g)
    net_e = tmp_path / "text_encoder7.pth"
    torch.save(build_text_encoder(150, mcfg.embedding_dim, seed=4,
                                  device="cpu").state_dict(), net_e)
    cfg = tiny_cfg(tmp_path, str(tmp_path / "data"), net_g=str(net_g),
                   net_e=str(net_e), b_net_d=False)
    run, straight = tmp_path / "run", tmp_path / "straight"
    first = _main(cfg, run, "--max_epochs", "1")
    out = capsys.readouterr().out
    assert f"Load G from: {net_g}" in out
    assert f"Load text encoder from: {net_e}" in out
    assert out.count("WARNING") == 1 and "image_encoder7.pth" in out
    hist = _main(cfg, run, "--max_epochs", "2", "--resume", str(run))
    out = capsys.readouterr().out
    assert "resumed from" in out and "Load G from" not in out
    for h in first + hist:
        assert h["steps"] == 4
        assert all(np.isfinite(v) for v in h.values())
        assert h["w_loss"] > 0 and h["s_loss"] > 0
    flags = json.loads((run / "run_flags.json").read_text())
    assert flags["encoders"] == {"text_encoder": "imported",
                                 "image_encoder": "random"}
    assert (flags["net_e"], flags["smooth_lambda"], flags["variant"]) == (
        str(net_e), 50.0, "coco-attngan")
    want = ["attention_maps_epoch_000.png", "attention_maps_epoch_001.png",
            "attention_maps_step_0000000.png", "fake_samples_epoch_000.png",
            "fake_samples_epoch_001.png", "fake_samples_step_0000000.png",
            "real_samples.png"]
    assert sorted(os.listdir(run / "images")) == want
    montage = read_png(str(run / "images" / "attention_maps_epoch_001.png"),
                       "RGB")
    assert montage.shape == (8 * 64, 9 * 64, 3)
    grid = read_png(str(run / "images" / "fake_samples_epoch_001.png"), "RGB")
    assert grid.shape == (2 * 258 + 2, 4 * 258 + 2, 3)
    assert (run / "models" / "0" / "state.pth").is_file()
    assert (run / "src_snapshot" / "cli" / "attngan_runner.py").is_file()
    _main(cfg, straight, "--max_epochs", "2")
    assert calls and all(c == (torch.device("cpu"), None) for c in calls)
    got = CheckpointManager(str(run / "models")).load(1)[0]
    ref = CheckpointManager(str(straight / "models")).load(1)[0]
    assert got["step"] == ref["step"] == 8
    for part in ("g", "g_ema"):
        for k, v in ref[part].items():
            assert torch.equal(got[part][k], v), (part, k)
    for name, sd in ref["d"].items():
        for k, v in sd.items():
            assert torch.equal(got["d"][name][k], v), (name, k)
    for name, opt in ref["d_opt"].items():
        for i, st in opt["state"].items():
            assert torch.equal(got["d_opt"][name]["state"][i]["exp_avg_sq"],
                               st["exp_avg_sq"]), (name, i)
    assert torch.equal(got["extra"]["data_rng"]["keys"],
                       ref["extra"]["data_rng"]["keys"])
    # real_samples.png is the first batch of each process's first epoch,
    # as in the JAX runner; the logs' wall-clock times differ
    assert _files(run) == _files(straight)


def test_float32_policy_turns_tf32_off_for_float32_on_the_card_only(
        monkeypatch):
    """float32_policy, which cli/main.py and cli/serve.py call: float32 on
    the card turns TF32 off; bf16, and the CPU, leave it as it was."""
    for device, dtype, off in (("cuda", None, True),
                               ("cuda", torch.bfloat16, False),
                               ("cpu", None, False)):
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        float32_policy(torch.device(device), dtype)
        assert torch.backends.cuda.matmul.allow_tf32 is not off
        assert torch.backends.cudnn.allow_tf32 is not off
