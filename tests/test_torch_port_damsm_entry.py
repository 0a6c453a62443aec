"""``cli/main.py --variant damsm`` on the CPU: DAMSM pretraining's entry.

A copy of cfg/coco_damsm.yml at BASE_SIZE 64, batch 8 and embedding 16 on
the synthetic set (32 items, 4 steps an epoch; its test split of 8 holds
a batch, so the eval runs), the image encoder replaced by the tiny
stand-in of tests/test_torch_port_damsm_step.py (the real Inception-v3
step is held there). Two epochs write the ``.pth`` pair of each epoch, the
checkpoints and a ``logs/metrics.jsonl`` whose records carry the keys of
the JAX run's (runs_r5/attngan_flagship/damsm/logs/metrics.jsonl); the
learning rate follows damsm_lr; a resume equals the uninterrupted run bit
for bit (checkpoint, exports, log); NET_E continues pretraining from an
exported pair.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from multiple_objects_gan_tpu_torch.cli import damsm_runner
from multiple_objects_gan_tpu_torch.cli import main as port_main
from multiple_objects_gan_tpu_torch.data.attngan import AttnGanDataset
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.io.weights import (
    load_image_encoder, load_text_encoder)
from multiple_objects_gan_tpu_torch.nn.encoders import build_text_encoder
from test_torch_port_damsm_step import TinyImageEncoder

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
DAMSM_CFG = os.path.join(ROOT, "cfg", "coco_damsm.yml")
JAX_LOG = os.path.join(ROOT, "runs_r5", "attngan_flagship", "damsm", "logs",
                       "metrics.jsonl")
SEED = 3
NEF = 16


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tiny_image_encoder(monkeypatch):
    def build(nef=256, state_dict=None, *, seed=0, compute_dtype=None,
              device="cuda"):
        torch.manual_seed(seed)
        model = TinyImageEncoder(nef)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        return model.to(device).eval().requires_grad_(False)

    monkeypatch.setattr(damsm_runner, "build_image_encoder", build)
    monkeypatch.delenv(damsm_runner.BACKBONE_ENV, raising=False)


def tiny_cfg(tmp_path, net_e=""):
    with open(DAMSM_CFG) as f:
        text = f.read()
    text = (text.replace("BASE_SIZE: 256", "BASE_SIZE: 64")
            .replace("BATCH_SIZE: 48", "BATCH_SIZE: 8")
            .replace("EMBEDDING_DIM: 256", f"EMBEDDING_DIM: {NEF}")
            .replace("NET_E: ''", f"NET_E: '{net_e}'"))
    path = tmp_path / ("coco_damsm_net_e.yml" if net_e else "coco_damsm.yml")
    path.write_text(text)
    return str(path)


def _run(cfg, data, out, *extra):
    return port_main.main(["--variant", "damsm", "--cfg", cfg, "--data_dir",
                           data, "--img_dir", str(data) + "_imgs",
                           "--output_dir", out, "--synthetic",
                           "--manualSeed", str(SEED), "--device", "cpu",
                           "--snapshot_interval", "1", *extra])


def _records(out):
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in f]


def _equal(a, b, where=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_damsm_entry_two_epochs_resume_and_net_e(tmp_path, capsys):
    cfg, data = tiny_cfg(tmp_path), str(tmp_path / "data")
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    hist = _run(cfg, data, straight, "--max_epochs", "2")
    assert [h["steps"] for h in hist] == [4, 4]
    assert "WARNING: $INCEPTION_V3_WEIGHTS unset and no NET_E" in \
        capsys.readouterr().out
    for want in ([f"DAMSMencoders/{k}_encoder{e}.pth" for k in ("text",
                                                                "image")
                  for e in (0, 1)]
                 + ["models/0/state.pth", "models/1/state.pth",
                    "logs/metrics.jsonl", "run_flags.json",
                    "coco_damsm.yml", "src_snapshot/cli/damsm_runner.py"]):
        assert os.path.isfile(os.path.join(straight, want)), want
    with open(JAX_LOG) as f:
        jax_keys = {tuple(sorted(k for k in json.loads(line) if k != "time"))
                    for line in f}
    records = _records(straight)
    assert {tuple(sorted(r)) for r in records} == jax_keys
    evals = [r for r in records if "eval_damsm_loss" in r]
    assert [r["step"] for r in evals] == [0, 1]     # keyed by the epoch
    ckpt, _ = CheckpointManager(os.path.join(straight, "models")).load(1)
    assert ckpt["step"] == 8
    assert ckpt["opt"]["param_groups"][0]["lr"] == damsm_runner.damsm_lr(
        0.002, 1)
    n_words = AttnGanDataset(data, "train", 5).n_words
    text = build_text_encoder(n_words, NEF, load_text_encoder(os.path.join(
        straight, "DAMSMencoders", "text_encoder1.pth")), device="cpu")
    _equal(text.state_dict(), ckpt["text"])
    TinyImageEncoder(NEF).load_state_dict(load_image_encoder(os.path.join(
        straight, "DAMSMencoders", "image_encoder1.pth")), strict=True)

    _run(cfg, data, resumed, "--max_epochs", "1")
    hist_r = _run(cfg, data, resumed, "--max_epochs", "2", "--resume",
                  resumed)
    assert "resumed from" in capsys.readouterr().out and len(hist_r) == 1
    _equal(CheckpointManager(os.path.join(resumed, "models")).load(1)[0],
           ckpt)
    for k in ("text", "image"):
        name = os.path.join("DAMSMencoders", f"{k}_encoder1.pth")
        _equal(load_text_encoder(os.path.join(resumed, name)),
               load_text_encoder(os.path.join(straight, name)), name)
    assert _records(resumed) == records

    net_e = os.path.join(straight, "DAMSMencoders", "text_encoder1.pth")
    cont = str(tmp_path / "continued")
    hist_c = _run(tiny_cfg(tmp_path, net_e), data, cont, "--max_epochs", "1")
    out = capsys.readouterr().out
    assert f"Load text encoder from: {net_e}" in out
    assert "Load image encoder from: " + net_e.replace(
        "text_encoder", "image_encoder") in out
    assert "WARNING" not in out
    assert hist_c[0]["damsm_loss"] < hist[0]["damsm_loss"]
    text_c, image_c = damsm_runner.init_damsm_encoders(
        net_e, n_words, NEF, seed=SEED, device="cpu")
    _equal(text_c.state_dict(), ckpt["text"])
    _equal(image_c.state_dict(), ckpt["image"])
