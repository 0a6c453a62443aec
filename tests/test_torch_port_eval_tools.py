"""The port's eval tools and ``--profile`` on the CPU.

* ``tools/eval_fid.py`` of the port and of the JAX package on the same two
  small directories (PNGs, and a JPEG of another size that both resize
  with PIL's bilinear filter), ``--image_encoder`` one seeded DAMSM
  ``.pth``: the same JSON keys and provenance, the same counts, FID
  within rtol 1e-3 and IS within 1e-4 of JAX's (both decode to the same
  pixels; the features agree to float32 rounding);
* ``tools/eval_layout_fidelity.py`` on a port run directory at GF 8: one
  JSON line with JAX's keys, its layouts drawn from ``RandomState(seed)``
  as the JAX tool draws them;
* ``cli/main.py --profile`` writes a torch.profiler trace of a Multi-MNIST
  epoch and reaches the AttnGAN and DAMSM runners.
"""

from __future__ import annotations

import json
import os
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from multiple_objects_gan_tpu_torch.cli import main as port_main
from multiple_objects_gan_tpu_torch.config.config import (
    cfg_from_file, stage1_model_config)
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.nn.encoders import build_image_encoder
from multiple_objects_gan_tpu_torch.tools import eval_fid as port_fid
from multiple_objects_gan_tpu_torch.tools import (
    eval_layout_fidelity as port_lf)
from multiple_objects_gan_tpu_torch.train.state import create_state
from test_cnn_encoder_parity import _randomize

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, os.path.join(ROOT, "tools"))
import eval_fid as jax_fid  # noqa: E402  (the JAX package's tool)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads and two BLAS threads: the host FID's matrix root
    gains little from more, and the suite runs six files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(2):
        yield
    torch.set_num_threads(n)


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def test_eval_fid_matches_the_jax_tool(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("FID_INCEPTION_WEIGHTS", raising=False)
    monkeypatch.delenv("INCEPTION_V3_WEIGHTS", raising=False)
    rs = np.random.RandomState(0)
    real, fake = tmp_path / "real", tmp_path / "fake"
    real.mkdir()
    fake.mkdir()
    for i in range(3):
        Image.fromarray(rs.randint(0, 256, (64, 64, 3), np.uint8)).save(
            real / f"r{i}.png")
        img = np.full((64, 64, 3), 40 * i, np.uint8)
        img[16:48, 8:40] = rs.randint(0, 256, 3)
        Image.fromarray(img).save(fake / f"f{i}.png")
    # a JPEG of another size, resized to 64 by both tools
    Image.fromarray(rs.randint(0, 256, (80, 96, 3), np.uint8)).save(
        real / "r3.jpg")
    enc = str(tmp_path / "image_encoder0.pth")
    torch.save(_randomize(build_image_encoder(256, seed=1, device="cpu"),
                          seed=2).state_dict(), enc)
    args = [str(real), str(fake), "--image_encoder", enc, "--size", "64",
            "--batch", "4"]
    got = port_fid.main([*args, "--device", "cpu",
                         "--out", str(tmp_path / "port.json")])
    port_out = capsys.readouterr().out
    jax_fid.main(args)
    want = _last_json(capsys.readouterr().out)
    assert _last_json(port_out) == got
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == got
    assert list(got) == list(want)
    for k in ("n_real", "n_fake", "is_head", "is_backbone", "fid_encoder"):
        assert got[k] == want[k], k
    assert (got["n_real"], got["n_fake"], got["fid_encoder"]) == (
        4, 3, "damsm")
    assert got["fid"] > 1.0
    assert got["fid"] == pytest.approx(want["fid"], rel=1e-3)
    assert got["is_mean"] == pytest.approx(want["is_mean"], abs=1e-4)
    assert got["is_std"] == pytest.approx(want["is_std"], abs=1e-4)


def test_eval_layout_fidelity_on_a_port_run(tmp_path, capsys):
    with open(os.path.join(ROOT, "cfg", "mnist_train.yml")) as f:
        text = f.read()
    cfg_file = tmp_path / "mnist_narrow.yml"
    cfg_file.write_text(text.replace("GF_DIM: 128", "GF_DIM: 8")
                        .replace("DF_DIM: 64", "DF_DIM: 8"))
    mcfg = stage1_model_config(cfg_from_file(str(cfg_file), "multi-mnist"),
                               "multi-mnist")
    run = tmp_path / "run"
    CheckpointManager(str(run / "models")).save(
        3, create_state(mcfg, seed=5, device="cpu"))
    out = port_lf.main(["--ckpt", str(run), "--cfg", str(cfg_file),
                        "--n", "12", "--batch", "8", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"restored G from {run} (epoch 3)" in printed
    assert _last_json(printed) == json.loads(json.dumps(out))
    assert set(out) == {"recall", "per_label_recall", "loc_iou",
                        "n_objects"}
    assert out["n_objects"] == 12 * mcfg.num_objects
    assert 0.0 <= out["recall"] <= 1.0 and 0.0 <= out["loc_iou"] <= 1.0
    # the JAX tool's draw (tools/eval_layout_fidelity.py:86-104), batch 8
    rs = np.random.RandomState(7)
    bbox, cond, labels, text = port_lf.draw_layouts(rs, 8, mcfg, "mnist")
    ref = np.random.RandomState(7)
    want = np.stack([ref.uniform(0.05, 0.6, (8, 3)),
                     ref.uniform(0.05, 0.6, (8, 3)),
                     ref.uniform(0.2, 0.33, (8, 3)),
                     ref.uniform(0.2, 0.33, (8, 3))], -1).astype(np.float32)
    np.testing.assert_array_equal(bbox, want)
    np.testing.assert_array_equal(labels, ref.randint(0, 10, (8, 3)))
    assert text is None and cond.shape == (8, 3, 10)
    with pytest.raises(SystemExit, match="no checkpoint"):
        port_lf.main(["--ckpt", str(tmp_path / "empty"), "--device", "cpu"])


def test_profile_traces_an_mnist_epoch_and_reaches_the_coco_runners(
        tmp_path, capsys, monkeypatch):
    with open(os.path.join(ROOT, "cfg", "mnist_train.yml")) as f:
        text = f.read()
    cfg_file = tmp_path / "mnist.yml"
    cfg_file.write_text(text.replace("GF_DIM: 128", "GF_DIM: 8")
                        .replace("DF_DIM: 64", "DF_DIM: 8")
                        .replace("BATCH_SIZE: 128", "BATCH_SIZE: 64"))
    trace = tmp_path / "trace"
    port_main.main(["--variant", "multi-mnist", "--cfg", str(cfg_file),
                    "--data_dir", str(tmp_path / "data"), "--output_dir",
                    str(tmp_path / "out"), "--synthetic", "--max_epochs",
                    "1", "--manualSeed", "1", "--device", "cpu",
                    "--profile", str(trace)])
    assert f"profiler trace written to {trace}" in capsys.readouterr().out
    files = os.listdir(trace)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(trace / files[0]) as f:
        events = json.load(f)["traceEvents"]
    # steps 2-5 of the 8-step epoch: K3 (StnPlaceMulti) and its backward
    names = [str(e.get("name", "")) for e in events]
    assert sum(n == "StnPlaceMulti" for n in names) >= 4
    assert sum(n == "StnPlaceMultiBackward" for n in names) >= 4
    seen = {}
    for runner in ("run_attngan", "run_damsm"):
        monkeypatch.setattr(port_main, runner,
                            lambda *a, _r=runner, **k: seen.setdefault(
                                _r, k["profile_dir"]) and [])
    for variant, name in (("coco-attngan", "coco_attn_train.yml"),
                          ("damsm", "coco_damsm.yml")):
        with open(os.path.join(ROOT, "cfg", name)) as f:
            small = re.sub(r"BATCH_SIZE: \d+", "BATCH_SIZE: 2", f.read())
        cfg = tmp_path / name                   # --synthetic writes 32 items
        cfg.write_text(small)
        port_main.main(["--variant", variant, "--cfg", str(cfg), "--data_dir",
                        str(tmp_path / variant), "--img_dir",
                        str(tmp_path / f"{variant}_imgs"), "--synthetic",
                        "--output_dir", str(tmp_path / f"{variant}_out"),
                        "--device", "cpu", "--profile", str(trace)])
    assert seen == {"run_attngan": str(trace), "run_damsm": str(trace)}
