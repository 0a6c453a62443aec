"""The port's FID/IS harness (``multiple_objects_gan_tpu_torch/tools/
parity_harness.py``) against the JAX package's ``tools/parity_harness.py``
on the CPU.

* The merged eval cfg: the port writes it with its own YAML writer
  (``config/config.py:dump_yaml``; the card's machine has no PyYAML) and
  reads it with ``cfg_from_file``; JAX writes it with PyYAML and reads it
  with its own ``cfg_from_file``. Every key of the merged file, the
  overridden ones included, reads the same on both sides, for the test
  stand-in and for cfg/coco_attn_eval.yml.
* The one-shot run on the synthetic stand-ins of tests/test_parity_harness.py
  (a tiny GNet exported by the JAX package, 8 items): both harnesses return
  the same keys and provenance, the same image count, and
  ``comparable_to_published`` false. The host FID (two 2048-square matrix
  roots, 13-18 s each on the CPU) is replaced on both sides by a stand-in;
  tests/test_torch_port_attngan_sampling.py holds the real one.
"""

from __future__ import annotations

import json
import os
import sys

import jax
import pytest
import torch
import yaml

import multiple_objects_gan_tpu.utils.metrics as jmetrics
from multiple_objects_gan_tpu.config.config import (
    cfg_from_file as jcfg_from_file)
from multiple_objects_gan_tpu_torch.cli import attngan_runner
from multiple_objects_gan_tpu_torch.config.config import (
    cfg_from_file, parse_yaml)
from multiple_objects_gan_tpu_torch.tools import parity_harness as port_tool

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import parity_harness as jax_tool  # noqa: E402
from test_parity_harness import _EVAL_YML  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(doc: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in doc.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _get(cfg, path: str):
    for k in path.split("."):
        cfg = cfg[k]
    return cfg


@pytest.mark.parametrize("base", ["stand-in", "coco_attn_eval.yml"])
@pytest.mark.parametrize("net_e", ["", "dir with space/text_encoder7.pth"])
def test_merged_cfg_reads_as_jax_reads_its_own(tmp_path, base, net_e):
    if base == "stand-in":
        path = tmp_path / "eval.yml"
        path.write_text(_EVAL_YML.format(data="d", imgs="i"))
        path = str(path)
    else:
        path = os.path.join(ROOT, "cfg", base)
    args = ("run dir/netG_epoch_100.pth", net_e, str(tmp_path / "data"),
            str(tmp_path / "imgs"))
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    want = jcfg_from_file(jax_tool.build_merged_cfg(path, str(jdir), *args),
                          "coco-attngan")
    merged = port_tool.build_merged_cfg(path, str(pdir), *args)
    got = cfg_from_file(merged, "coco-attngan")
    with open(merged) as f:
        text = f.read()
    assert parse_yaml(text) == yaml.safe_load(text)
    keys = _flat(parse_yaml(text))
    for k in ("TRAIN.FLAG", "TRAIN.NET_G", "TRAIN.NET_E", "DATA_DIR",
              "IMG_DIR"):
        assert k in keys
    for k in keys:
        assert _get(got, k) == _get(want, k), k
        assert type(_get(got, k)) is type(_get(want, k)), k
    assert got.TRAIN.FLAG is False
    assert got.TRAIN.NET_G == args[0]
    if net_e:
        assert got.TRAIN.NET_E == net_e


@pytest.fixture(scope="module")
def stand_ins(tmp_path_factory):
    """tests/test_parity_harness.py's stand-ins: 8 synthetic items and a
    bare netG .pth of a seeded tiny GNet, exported by the JAX package."""
    root = tmp_path_factory.mktemp("parity")
    data, imgs = str(root / "data"), str(root / "imgs")
    from multiple_objects_gan_tpu.cli.attngan_runner import build_all
    from multiple_objects_gan_tpu.data.attngan import (
        AttnGanDataset, write_synthetic_attngan)
    from multiple_objects_gan_tpu.io.torch_export import (
        export_attngan_g, save_bare_state_dict)
    from multiple_objects_gan_tpu.train.attngan_step import (
        create_attngan_state)

    write_synthetic_attngan(data, imgs, n=8, seed=11)
    base_yml = root / "eval.yml"
    base_yml.write_text(_EVAL_YML.format(data=data, imgs=imgs))
    cfg = jcfg_from_file(str(base_yml), "coco-attngan")
    ds = AttnGanDataset(data, imgs, split="test",
                        base_size=int(cfg.TREE.BASE_SIZE), branch_num=2,
                        captions_per_image=5, words_num=12, seed=11)
    mcfg, g, d_modules, _, _ = build_all(cfg, ds.n_words)
    state = create_attngan_state(mcfg, g, d_modules, jax.random.PRNGKey(5),
                                 batch_size=2, seq_len=12)
    net_g = str(root / "netG_epoch_100.pth")
    save_bare_state_dict(export_attngan_g(
        jax.device_get(state.g_params), jax.device_get(state.g_stats),
        branch_num=2, r_num=2), net_g)
    return root, str(base_yml), net_g, data, imgs


def _stand_in_fid(real, fake):
    return float(abs(real.mean() - fake.mean()))


def test_one_shot_returns_jax_keys_and_provenance(stand_ins, capsys,
                                                   monkeypatch):
    root, base_yml, net_g, data, imgs = stand_ins
    monkeypatch.delenv("FID_INCEPTION_WEIGHTS", raising=False)
    monkeypatch.delenv("INCEPTION_V3_WEIGHTS", raising=False)
    monkeypatch.setattr(jmetrics, "fid_from_activations", _stand_in_fid)
    monkeypatch.setattr(attngan_runner, "fid_from_activations",
                        _stand_in_fid)
    argv = ["--net_g", net_g, "--data_dir", data, "--img_dir", imgs,
            "--cfg", base_yml, "--num_images", "4", "--seed", "3"]
    want = jax_tool.main([*argv, "--out", str(root / "jax_out")])
    capsys.readouterr()
    out = str(root / "port_out")
    got = port_tool.main([*argv, "--out", out, "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == got
    assert any(line.startswith("NOTE: non-canonical") for line in printed)
    assert sorted(got) == sorted(want)
    for k in ("n_images", "fid_encoder", "is_backbone", "is_head",
              "comparable_to_published", "net_g", "net_e"):
        assert got[k] == want[k], k
    assert got["n_images"] == 4
    assert got["comparable_to_published"] is False
    assert got["fid"] >= 0.0 and got["inception_score_mean"] >= 1.0
    assert len(os.listdir(got["samples_dir"])) == 4
    assert os.path.isfile(got["metrics_json"])
    assert os.path.isfile(os.path.join(out, "parity_eval.yml"))


def test_comparable_needs_all_three_published_weights():
    full = {"is_head": "imported", "is_backbone": "imported",
            "fid_encoder": "fid_canonical"}
    assert port_tool.comparable(full)
    for k, v in (("is_head", "random"), ("is_backbone", "random"),
                 ("fid_encoder", "damsm")):
        assert not port_tool.comparable({**full, k: v})


def test_missing_net_g_exits(tmp_path):
    with pytest.raises(SystemExit, match="--net_g not found"):
        port_tool.main(["--net_g", str(tmp_path / "none.pth"),
                        "--data_dir", str(tmp_path), "--device", "cpu"])
