"""The port's dataset checker (``multiple_objects_gan_tpu_torch/tools/
check_dataset.py``) against the JAX package's ``tools/check_dataset.py``
on the CPU: every case of tests/test_check_dataset.py runs through both
tools on the same directory (the JAX package's synthetic writers, then the
same corruptions), and the two must agree on ``ok``, the exit code, the
number of errors and of warnings, and every field of ``report`` (the
image modes and sizes the port reads from the PNG and JPEG headers
included). The wording of a message may differ; the port runs with
``--device cpu`` (the numpy codecs)."""

from __future__ import annotations

import json
import os
import pickle
import shutil

import numpy as np
import pytest

from multiple_objects_gan_tpu.data.attngan import (
    AttnGanDataset, write_synthetic_attngan)
from multiple_objects_gan_tpu.data.coco import write_synthetic_coco
from multiple_objects_gan_tpu.data.datasets import (
    write_synthetic_clevr, write_synthetic_multimnist)
from multiple_objects_gan_tpu.io.pycompat import load_pickle
from multiple_objects_gan_tpu_torch.tools.check_dataset import (
    main as port_main)
from multiple_objects_gan_tpu_torch.utils.images import png_bytes
from test_pycompat import write_py2_pickle
from tools.check_dataset import main as jax_main


def _both(capsys, *argv) -> dict:
    """Run both tools; hold them equal; return the port's JSON."""
    outs = []
    for main, extra in ((jax_main, []), (port_main, ["--device", "cpu"])):
        rc = main([*argv, *extra])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert (rc == 0) == out["ok"]
        outs.append((rc, out))
    (jrc, j), (prc, p) = outs
    assert prc == jrc and p["ok"] == j["ok"], (j, p)
    assert len(p["errors"]) == len(j["errors"]), (j["errors"], p["errors"])
    assert len(p["warnings"]) == len(j["warnings"]), (j["warnings"],
                                                      p["warnings"])
    assert p["report"] == j["report"]
    assert {k: p[k] for k in ("variant", "data_dir", "split")} == {
        k: j[k] for k in ("variant", "data_dir", "split")}
    return p


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mnist_ck")
    write_synthetic_multimnist(str(d), n=8, split="train", seed=0)
    return str(d)


def _copy(src, tmp_path):
    d = tmp_path / "m"
    shutil.copytree(src, d)
    return d, d / "train" / "normal"


def test_mnist_healthy(mnist_dir, capsys):
    out = _both(capsys, "mnist", mnist_dir)
    assert out["ok"], out["errors"]
    assert out["report"]["n_items"] == 8
    assert out["report"]["image_modes_sampled"] == ["L"]


def test_mnist_wrong_channel_count_warns(mnist_dir, tmp_path, capsys):
    d, sd = _copy(mnist_dir, tmp_path)
    name = sorted(os.listdir(sd / "imgs"))[0]
    (sd / "imgs" / name).write_bytes(png_bytes(
        np.full((64, 64, 3), (10, 20, 30), np.uint8)))
    out = _both(capsys, "mnist", str(d))
    assert out["ok"], out["errors"]
    assert any("channels" in w for w in out["warnings"]), out["warnings"]
    assert out["report"]["image_modes_sampled"] == ["L", "RGB"]


def test_mnist_py2_pickles_reported(mnist_dir, tmp_path, capsys):
    d, sd = _copy(mnist_dir, tmp_path)
    bb = np.asarray(load_pickle(str(sd / "bboxes.pickle")), np.float32)
    write_py2_pickle(str(sd / "bboxes.pickle"), bb)
    out = _both(capsys, "mnist", str(d))
    assert out["ok"], out["errors"]
    assert out["report"]["bboxes_pickle_encoding"] in ("utf-8", "latin1")
    assert out["report"]["filenames_pickle_encoding"] == "py3"


def test_mnist_corrupted_pickle_is_diagnosed(mnist_dir, tmp_path, capsys):
    d, sd = _copy(mnist_dir, tmp_path)
    (sd / "labels.pickle").write_bytes(b"\x80\x02not a pickle at all")
    out = _both(capsys, "mnist", str(d))
    assert not out["ok"]
    assert any("labels" in e and "undecodable" in e for e in out["errors"])


def test_mnist_missing_file_and_bad_range(mnist_dir, tmp_path, capsys):
    d, sd = _copy(mnist_dir, tmp_path)
    os.remove(sd / "filenames.pickle")
    with open(sd / "bboxes.pickle", "wb") as f:
        pickle.dump(np.full((8, 3, 4), 17.0, np.float32), f)
    out = _both(capsys, "mnist", str(d))
    assert not out["ok"]
    assert any("missing file" in e for e in out["errors"])
    assert any("outside [0, 1]" in e for e in out["errors"])


def test_clevr_healthy_and_corrupt(tmp_path, capsys):
    d = tmp_path / "clevr"
    write_synthetic_clevr(str(d), n=6, split="train", seed=0)
    out = _both(capsys, "clevr", str(d))
    assert out["ok"], out["errors"]
    assert out["report"]["n_items"] == 6
    scene_dir = d / "train" / "scenes"
    victim = sorted(os.listdir(scene_dir))[0]
    (scene_dir / victim).write_text("{broken json")
    out = _both(capsys, "clevr", str(d))
    assert not out["ok"]
    assert any("unparsable" in e for e in out["errors"])


def test_coco_healthy_and_embedding_shape(tmp_path, capsys):
    data, imgs = str(tmp_path / "d"), str(tmp_path / "imgs")
    write_synthetic_coco(data, imgs, n=6, split="train", seed=0)
    out = _both(capsys, "coco-stackgan", data, "--img_dir", imgs)
    assert out["ok"], out["errors"]
    assert out["report"]["image_modes_sampled"] == ["RGB"]
    with open(os.path.join(data, "train",
                           "char-CNN-RNN-embeddings.pickle"), "wb") as f:
        pickle.dump(np.zeros((6, 5, 77), np.float32), f)
    out = _both(capsys, "coco-stackgan", data, "--img_dir", imgs)
    assert not out["ok"]
    assert any("1024" in e for e in out["errors"])
    out = _both(capsys, "coco-stackgan", data)       # no --img_dir: a warning
    assert any("img_dir" in w for w in out["warnings"])


def test_coco_truncated_jpeg_is_an_error_naming_it(tmp_path, capsys):
    data, imgs = str(tmp_path / "d"), str(tmp_path / "imgs")
    write_synthetic_coco(data, imgs, n=4, split="train", seed=1)
    victim = os.path.join(imgs, sorted(os.listdir(imgs))[0])
    with open(victim, "rb") as f:
        head = f.read()[:300]
    with open(victim, "wb") as f:
        f.write(head)
    rc = port_main(["coco-stackgan", data, "--img_dir", imgs,
                    "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and not out["ok"]
    assert any("undecodable" in e and victim in e for e in out["errors"])


def test_attngan_healthy_and_vocab(tmp_path, capsys):
    data, imgs = str(tmp_path / "d"), str(tmp_path / "imgs")
    write_synthetic_attngan(data, imgs, n=6, seed=0)
    out = _both(capsys, "coco-attngan", data, "--img_dir", imgs)
    assert out["ok"], out["errors"]
    AttnGanDataset(data, imgs, split="train", branch_num=2, base_size=64)
    out = _both(capsys, "coco-attngan", data, "--img_dir", imgs)
    assert out["ok"], out["errors"]
    assert out["report"]["vocab_size"] > 0
    cache = os.path.join(data, "captions.pickle")
    tr, te, ixtoword, wordtoix = load_pickle(cache)
    wordtoix = {w: ix + 1 for w, ix in wordtoix.items()}
    with open(cache, "wb") as f:
        pickle.dump([tr, te, ixtoword, wordtoix], f)
    out = _both(capsys, "coco-attngan", data, "--img_dir", imgs)
    assert not out["ok"]
    assert any("not inverse" in e for e in out["errors"])


def test_missing_dataset_dir_is_diagnosed(tmp_path, capsys):
    for variant in ("mnist", "clevr"):
        out = _both(capsys, variant, str(tmp_path / "nope"))
        assert not out["ok"] and out["errors"]


def test_the_card_is_the_default_device(mnist_dir, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main(["mnist", mnist_dir])
