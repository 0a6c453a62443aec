"""The port's COCO StackGAN stage-2 entries on the CPU: the config of
cfg/coco_s2_*.yml, the train entry (cli/main.py --variant coco-stackgan-2
--synthetic) with its artifacts and resume, and ``Stage2Service`` over
HTTP.

The train entry runs a copy of cfg/coco_s2_train.yml at gf 8, df 4 and
batch 4 (64 synthetic items, 16 steps an epoch, 256px); the frozen
stage-1 G comes from a reference-format ``.pth`` written from a seeded
``Stage1G``. The service runs at gf 8, df 4.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import http.client
import io
import json
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from multiple_objects_gan_tpu_torch.cli import main as port_main
from multiple_objects_gan_tpu_torch.cli import serve as port_serve
from multiple_objects_gan_tpu_torch.cli.serve import Stage2Service
from multiple_objects_gan_tpu_torch.config.config import (
    cfg_from_file, stage2_model_config, train_settings)
from multiple_objects_gan_tpu_torch.data.png import read_png
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.models import common
from multiple_objects_gan_tpu_torch.models.stage1 import build_stage1_g
from multiple_objects_gan_tpu_torch.train.state import create_state_stage2
from test_torch_port_stage2_step import _he_randomize

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
S2_TRAIN = os.path.join(ROOT, "cfg", "coco_s2_train.yml")
S2_EVAL = os.path.join(ROOT, "cfg", "coco_s2_eval.yml")
_TINY = dict(gf_dim=8, df_dim=4)
PS1 = dataclasses.replace(common.COCO_S1, **_TINY)
PS2 = dataclasses.replace(common.COCO_S2, **_TINY)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_s2_cfg(tmp_path, stage1_g="", flag=True):
    """cfg/coco_s2_train.yml with GF 8, DF 4, batch 4, and STAGE1_G (and
    TRAIN.FLAG) set."""
    with open(S2_TRAIN) as f:
        text = f.read()
    text = (text.replace("BATCH_SIZE: 40", "BATCH_SIZE: 4")
            .replace("GF_DIM: 192", "GF_DIM: 8")
            .replace("DF_DIM: 96", "DF_DIM: 4")
            .replace("STAGE1_G: 'data/models/pretrained_model.pth'",
                     f"STAGE1_G: '{stage1_g}'")
            .replace("FLAG: True", f"FLAG: {flag}"))
    path = tmp_path / "coco_s2_train.yml"
    path.write_text(text)
    return str(path)


def test_config_reads_the_stage2_cfgs():
    """cfg/coco_s2_train.yml and cfg/coco_s2_eval.yml with the port's own
    YAML reader: the stage-1 G of the frozen path at GF_DIM * 8 and stage
    2 at GF_DIM and DF_DIM directly, R_NUM 2, both D heads; --bf16 and
    --bn_groups reach both configs."""
    cfg = cfg_from_file(S2_TRAIN, "coco-stackgan-2")
    assert (cfg.STAGE, cfg.IMSIZE, cfg.GAN.R_NUM) == (2, 256, 2)
    assert cfg.STAGE1_G == "data/models/pretrained_model.pth"
    s1, s2 = stage2_model_config(cfg, compute_dtype=torch.bfloat16,
                                 bn_groups=2)
    assert (s1.variant, s1.ngf, s1.df_dim, s1.condition_dim,
            s1.text_dim) == ("coco-stackgan-1", 1536, 96, 128, 1024)
    assert (s2.variant, s2.gf_dim, s2.df_dim, s2.r_num, s2.condition_dim,
            s2.d_cond_dim, s2.text_dim, s2.num_objects, s2.label_dim) == (
        "coco-stackgan-2", 192, 96, 2, 128, 128, 1024, 3, 81)
    assert s2.use_uncond_head and not s1.use_uncond_head
    for c in (s1, s2):
        assert (c.compute_dtype, c.bn_groups) == (torch.bfloat16, 2)
    train = train_settings(cfg)
    assert (train.batch_size, train.max_epoch, train.lr_decay_epoch,
            train.kl_coeff) == (40, 120, 20, 2.0)
    ev = cfg_from_file(S2_EVAL, "coco-stackgan-2")
    assert not ev.TRAIN.FLAG and ev.NET_G.endswith("stage-ii-0110.pth")
    assert stage2_model_config(ev)[1].gf_dim == 192
    with pytest.raises(ValueError, match="bn_groups"):
        stage2_model_config(cfg, bn_groups=0)


def _stage1_pth(tmp_path):
    """A reference-format STAGE1_G .pth of a seeded tiny Stage1G."""
    g1 = build_stage1_g(PS1, seed=5, device="cpu")
    path = str(tmp_path / "stage1_netG.pth")
    torch.save({"netG": g1.state_dict()}, path)
    return path, g1


def _main(cfg, out, *flags, variant="coco-stackgan-2"):
    """cli/main.py with --synthetic: the set is written beside the cfg
    (data/, imgs/) when missing."""
    where = os.path.dirname(cfg)
    return port_main.main(["--variant", variant, "--cfg", cfg,
                           "--synthetic", "--manualSeed", "3", "--device",
                           "cpu", "--data_dir", os.path.join(where, "data"),
                           "--img_dir", os.path.join(where, "imgs"),
                           "--output_dir", str(out), *flags])


def test_cli_trains_one_synthetic_epoch_and_resumes(tmp_path, capsys):
    """One epoch at gf 8, df 4, batch 4, with STAGE1_G a reference .pth,
    then a resume in place to epoch 2: the artifacts of a run, the G2
    grid (one row of four 256px tiles at batch 4: min(16, batch) images,
    4 a row), and the checkpoints of both epochs."""
    stage1_g, _ = _stage1_pth(tmp_path)
    cfg = tiny_s2_cfg(tmp_path, stage1_g)
    out = tmp_path / "out"
    hist = _main(cfg, out, "--max_epochs", "1")
    text = capsys.readouterr().out
    assert f"Load from: {stage1_g}" in text
    assert ("coco-stackgan-2 stage 2 on cpu: gf 8, df 4, R_NUM 2, frozen "
            "stage-1 G ngf 64, 3 objects, batch 4, 16 steps an epoch") in text
    assert len(hist) == 1 and hist[0]["steps"] == 16
    for k in ("d_loss", "d_loss_real", "d_loss_wrong", "d_loss_fake",
              "g_loss", "g_loss_total", "kl_loss"):
        assert np.isfinite(hist[0][k]) and hist[0][k] > 0, k
    with open(out / "logs" / "metrics.jsonl") as f:
        first = json.loads(f.readline())
    assert first["step"] == 0 and "kl_loss" in first
    grid = read_png(str(out / "images" / "fake_samples_epoch_000.png"), "RGB")
    assert grid.shape == (256 + 4, 4 * 258 + 2, 3) and grid.std() > 1.0
    assert read_png(str(out / "images" / "real_samples.png"),
                    "RGB").shape == grid.shape
    with open(out / "run_flags.json") as f:
        flags = json.load(f)
    assert (flags["variant"], flags["bf16"], flags["manualSeed"]) == (
        "coco-stackgan-2", False, 3)
    assert (out / "coco_s2_train.yml").is_file()
    assert (out / "src_snapshot" / "cli" / "stage2_runner.py").is_file()
    ckpt, epoch = CheckpointManager(str(out / "models")).load()
    assert epoch == 0 and ckpt["step"] == 16
    assert "encoder.0.weight" in ckpt["g"] and "conv8.weight" in ckpt["d"]
    assert not any(k.startswith("STAGE1_G.") for k in ckpt["g"])

    hist = _main(cfg, out, "--resume", str(out), "--max_epochs", "2")
    assert "resumed from" in capsys.readouterr().out
    assert len(hist) == 1 and hist[0]["steps"] == 16
    assert CheckpointManager(str(out / "models")).epochs() == [0, 1]
    assert CheckpointManager(str(out / "models")).load()[0]["step"] == 32
    assert (out / "images" / "fake_samples_epoch_001.png").is_file()


def test_cli_bf16_bn_groups_epoch_warns_without_stage1_g(tmp_path, capsys):
    """--bf16 --bn_groups 2 for one epoch, with STAGE1_G naming no file:
    the WARNING, and the frozen G's reference random init."""
    cfg = tiny_s2_cfg(tmp_path, str(tmp_path / "missing.pth"))
    hist = _main(cfg, tmp_path / "out", "--max_epochs", "1", "--bf16",
                 "--bn_groups", "2")
    out = capsys.readouterr().out
    assert "WARNING: STAGE1_G=" in out and "not found" in out
    assert "bf16, BatchNorm groups 2" in out
    assert all(np.isfinite(v) for v in hist[0].values())


def test_train_flag_false_exits_with_its_message(tmp_path):
    """TRAIN.FLAG False samples stage 2 (tests/test_torch_port_stage2_
    sample.py); without a test split and without --synthetic it exits with
    the data's path, as the JAX CLI does."""
    cfg = tiny_s2_cfg(tmp_path, flag=False)
    with pytest.raises(SystemExit, match="COCO data not found under "
                       f"{tmp_path}.*pass --synthetic"):
        port_main.main(["--variant", "coco-stackgan-2", "--cfg", cfg,
                        "--device", "cpu", "--data_dir", str(tmp_path),
                        "--output_dir", str(tmp_path / "out")])


def _tiny_s1_cfg(tmp_path, flag=True):
    """cfg/coco_s1_train.yml (STAGE 1) at GF/DF 8, batch 4."""
    with open(os.path.join(ROOT, "cfg", "coco_s1_train.yml")) as f:
        text = f.read()
    text = (text.replace("BATCH_SIZE: 128", "BATCH_SIZE: 4")
            .replace("DF_DIM: 96", "DF_DIM: 8")
            .replace("GF_DIM: 192", "GF_DIM: 8")
            .replace("FLAG: True", f"FLAG: {flag}"))
    path = tmp_path / "coco_s1_train.yml"
    path.write_text(text)
    return str(path)


def _jax_dispatch(monkeypatch, variant, cfg, tmp_path):
    """Where the JAX CLI sends ``variant`` with ``cfg``: "stage1" (its
    stage-1 trainer) or "stage2" (its stage-2 runner), both stubbed."""
    import sys as _sys

    from multiple_objects_gan_tpu.cli import main as jax_main
    from multiple_objects_gan_tpu.cli import stage2_runner as jax_s2
    from multiple_objects_gan_tpu.train import loop as jax_loop
    went = []
    monkeypatch.setattr(jax_s2, "run_stage2",
                        lambda *a, **k: went.append("stage2"))
    monkeypatch.setattr(jax_loop, "train",
                        lambda *a, **k: went.append("stage1"))
    monkeypatch.setattr(_sys, "argv", [
        "main", "--variant", variant, "--cfg", cfg, "--synthetic",
        "--manualSeed", "3", "--data_dir", str(tmp_path / "jdata"),
        "--img_dir", str(tmp_path / "jimgs"), "--output_dir",
        str(tmp_path / "jout")])
    jax_main.main()
    return went


@pytest.mark.parametrize("variant, stage, flag", [
    ("coco-stackgan-1", 2, True), ("coco-stackgan-2", 1, True),
    ("coco-stackgan-2", 1, False)], ids=["s1-variant-s2-cfg",
                                         "s2-variant-s1-cfg",
                                         "s1-cfg-train-flag-false"])
def test_stackgan_variants_dispatch_on_cfg_stage(tmp_path, monkeypatch,
                                                 variant, stage, flag):
    """F4: both coco-stackgan variants go where cfg STAGE says, as the JAX
    CLI's run_stackgan does: a stage-2 cfg to the stage-2 runner with
    Stage2G's config, a stage-1 cfg to the stage-1 trainer with COCO
    Stage1G's, and a stage-1 cfg with TRAIN.FLAG False trains stage 1 too
    (the JAX dispatch reads no TRAIN.FLAG there)."""
    cfg = (tiny_s2_cfg(tmp_path, flag=flag) if stage == 2
           else _tiny_s1_cfg(tmp_path, flag=flag))
    went = []
    monkeypatch.setattr(port_main, "run_stage2",
                        lambda cfg, s1, s2, loader, *a, **k:
                        went.append(("stage2", s2, loader)) or [])
    monkeypatch.setattr(port_main, "train",
                        lambda cfg, mcfg, loader, *a, **k:
                        went.append(("stage1", mcfg, loader)) or (None, []))
    _main(cfg, tmp_path / "out", variant=variant)
    assert [w[0] for w in went] == [f"stage{stage}"]
    mcfg, loader = went[0][1], went[0][2]
    assert loader.ds.stage == stage
    if stage == 2:
        assert (mcfg.gf_dim, mcfg.df_dim, mcfg.r_num) == (8, 4, 2)
        assert loader.ds.imsize == 256
    else:
        assert (mcfg.ngf, mcfg.text_dim, mcfg.label_dim) == (64, 1024, 81)
        assert loader.ds.imsize == 64
    assert _jax_dispatch(monkeypatch, variant, cfg, tmp_path) == [
        f"stage{stage}"]


def test_cli_entries_refuse_stage2_without_a_card(tmp_path, monkeypatch):
    cfg = tiny_s2_cfg(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main.main(["--variant", "coco-stackgan-2", "--cfg", cfg,
                        "--synthetic"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.build_service(port_serve.parse_args(
            ["--variant", "coco-stackgan-2", "--cfg", cfg]))


# ------------------------------------------------------------ the service


def service(seed):
    """Stage2Service at gf 8, df 4 on the CPU, its G1 and
    G2 given He-scale weights (at the reference's init the tiny G2's
    images are flat grey)."""
    svc = Stage2Service(PS1, PS2, seed=seed, device="cpu")
    _he_randomize(svc.g1, 1)
    _he_randomize(svc.g2, 2)
    return svc


class Server:
    """:func:`service` over HTTP."""

    def __init__(self):
        self.svc = service(3)
        args = argparse.Namespace(variant="coco-stackgan-2",
                                  host="127.0.0.1", port=0, max_wait_ms=5.0)
        self.httpd = port_serve.serve(args, self.svc)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def post(self, items):
        conn = http.client.HTTPConnection(
            "127.0.0.1", self.httpd.server_address[1], timeout=60)
        try:
            conn.request("POST", "/generate", body=json.dumps(
                {"items": items}))
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.httpd.batcher.close()
        self.thread.join(timeout=10)


@pytest.fixture(scope="module")
def server():
    srv = Server()
    yield srv
    srv.close()


def _item(rs, n=2):
    w, h = rs.uniform(0.2, 0.4, n), rs.uniform(0.2, 0.4, n)
    boxes = np.stack([rs.uniform(0, 1 - w), rs.uniform(0, 1 - h), w, h],
                     -1).round(4).tolist()
    return {"labels": rs.randint(0, 80, n).tolist(), "bboxes": boxes,
            "text_embedding": rs.randn(1024).round(5).tolist()}


def _png(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64)))
                      .convert("RGB"))


def test_service_answers_with_256px_pngs(server):
    rs = np.random.RandomState(30)
    status, body = server.post([_item(rs), _item(rs, 3)])
    assert status == 200 and len(body["images"]) == 2, body
    imgs = [_png(b) for b in body["images"]]
    assert all(im.shape == (256, 256, 3) for im in imgs)
    assert imgs[0].std() > 1.0
    assert server.svc.stats()["device_batches"] >= 2


def test_service_bboxes_s2_override_moves_only_the_256px_pathway():
    """The same item and the same draws (two services from one seed):
    ``bboxes_s2`` equal to ``bboxes`` gives the image without it, bit for
    bit; other ``bboxes_s2`` change it."""
    rs = np.random.RandomState(31)
    item = _item(rs)
    moved = dict(item, bboxes_s2=[[0.5, 0.5, 0.3, 0.3], [0.0, 0.1, 0.4,
                                                          0.2]])
    runs = []
    for it in (item, dict(item, bboxes_s2=item["bboxes"]), moved):
        runs.append(_png(service(4).run([it])[0]))
    assert np.array_equal(runs[0], runs[1])
    assert np.abs(runs[0].astype(int) - runs[2]).max() > 0


@pytest.mark.parametrize("item, message", [
    ({"labels": [1, 2], "bboxes": [[0.1, 0.1, 0.3, 0.3],
                                   [0.5, 0.5, 0.3, 0.3]],
      "bboxes_s2": [[0.1, 0.1, 0.3, 0.3]],
      "text_embedding": [0.0] * 1024}, "bboxes_s2 must match bboxes"),
    ({"labels": [1], "bboxes": [[0.1, 0.1, 0.3, 0.3]]}, "text_embedding"),
    ({"labels": [1], "bboxes": [[0.1, 0.1, 0.3, 0.3]],
      "bboxes_s2": [[0.1, 0.1, 0.3, -0.3]],
      "text_embedding": [0.0] * 1024}, "w, h > 0"),
], ids=["bboxes_s2-length", "no-embedding", "bboxes_s2-negative-height"])
def test_service_rejects_bad_stage2_items(server, item, message):
    status, body = server.post([item])
    assert status == 400 and message in body["error"], body


def test_service_loads_a_run_directory_and_a_stage1_pth(tmp_path):
    """NET_G a port run directory (its latest checkpoint's G2) and the
    frozen G from a STAGE1_G .pth."""
    stage1_g, g1 = _stage1_pth(tmp_path)
    run = tmp_path / "run"
    st = create_state_stage2(PS2, seed=9, device="cpu")
    CheckpointManager(str(run / "models")).save(0, st)
    svc = Stage2Service(PS1, PS2, net_g=str(run), stage1_g=stage1_g,
                        device="cpu")
    for k, v in st.g.state_dict().items():
        assert torch.equal(svc.g2.state_dict()[k], v), k
    for k, v in g1.state_dict().items():
        assert torch.equal(svc.g1.state_dict()[k], v), k
    assert str(run) in svc.weights and stage1_g in svc.weights
