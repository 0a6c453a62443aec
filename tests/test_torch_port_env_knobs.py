"""The JAX package's two environment knobs in the port's entries:
``MOG_COMPUTE_DTYPE`` and ``MOG_BN_GROUPS`` (JAX ``nn/blocks.py:40-43``,
``:104``), read by ``nn/blocks.py:env_compute_dtype`` and
``env_bn_groups`` when an entry parses its arguments.

Each entry under the env is held against the same entry under the flags;
the readers against the JAX package's own reading of every value, taken in
one subprocess (``JAX_PLATFORMS=cpu``) so that the JAX ``blocks`` module of
this process, whose globals later JAX tests read, is never reloaded; the
train entry's ``run_flags.json`` records what it computed; and a GF-8
Multi-MNIST step built under the env equals the ``--bf16 --bn_groups 2``
step bit for bit (same arithmetic, so no tolerance). Every env change goes
through ``monkeypatch`` and is undone after its test.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multiple_objects_gan_tpu_torch.cli import main as port_main
from multiple_objects_gan_tpu_torch.cli import serve as port_serve
from multiple_objects_gan_tpu_torch.config.config import (
    cfg_from_file, stage1_model_config)
from multiple_objects_gan_tpu_torch.data.datasets import (
    write_synthetic_multimnist)
from multiple_objects_gan_tpu_torch.data.synthetic import synthetic_batch
from multiple_objects_gan_tpu_torch.nn.blocks import (
    env_bn_groups, env_compute_dtype)
from multiple_objects_gan_tpu_torch.tools import profile_step
from multiple_objects_gan_tpu_torch.tools import validate_learning as vl
from multiple_objects_gan_tpu_torch.train.state import create_state
from multiple_objects_gan_tpu_torch.train.step import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST_TRAIN = os.path.join(ROOT, "cfg", "mnist_train.yml")
KNOBS = ("MOG_COMPUTE_DTYPE", "MOG_BN_GROUPS")
UNSET = None
DTYPE_VALUES = [UNSET, "", "bf16", "BF16", "bfloat16", "BFloat16",
                "float32", "f32", "fp16", " bf16"]
GROUP_VALUES = [UNSET, "", "1", "3", " 2", "abc", "2.0"]


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _set(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


def _port_reading(monkeypatch, name, value):
    _set(monkeypatch, name, value)
    try:
        if name == "MOG_COMPUTE_DTYPE":
            return "bfloat16" if env_compute_dtype() == torch.bfloat16 \
                else "float32"
        return env_bn_groups()
    except ValueError as e:
        assert "MOG_BN_GROUPS" in str(e)
        return "ValueError"


_JAX_TABLE = """
import importlib, json, os, sys
from multiple_objects_gan_tpu.nn import blocks
rows = []
for name, value in json.loads(sys.argv[1]):
    for k in ("MOG_COMPUTE_DTYPE", "MOG_BN_GROUPS"):
        os.environ.pop(k, None)
    if value is not None:
        os.environ[name] = value
    try:
        importlib.reload(blocks)
    except ValueError:
        rows.append("ValueError")
        continue
    rows.append(("bfloat16" if blocks.COMPUTE_DTYPE is not None
                 else "float32") if name == "MOG_COMPUTE_DTYPE"
                else blocks.BN_GROUPS)
print(json.dumps(rows))
"""


def test_readers_match_the_jax_package(monkeypatch):
    """Every value of both knobs, the port's reading against the JAX
    package's (one subprocess; the JAX module here is not reloaded)."""
    cases = ([("MOG_COMPUTE_DTYPE", v) for v in DTYPE_VALUES]
             + [("MOG_BN_GROUPS", v) for v in GROUP_VALUES])
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    env.update(JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([ROOT, env.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _JAX_TABLE,
                          json.dumps(cases)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    jax_rows = json.loads(out.stdout.strip().splitlines()[-1])
    port_rows = [_port_reading(monkeypatch, n, v) for n, v in cases]
    assert port_rows == jax_rows
    assert port_rows[:5] == ["float32", "float32", "bfloat16", "bfloat16",
                             "bfloat16"]
    assert port_rows[len(DTYPE_VALUES):] == [1, 1, 1, 3, 2, "ValueError",
                                             "ValueError"]


def test_bad_groups_value_names_the_variable(monkeypatch):
    monkeypatch.setenv("MOG_BN_GROUPS", "two")
    with pytest.raises(ValueError, match="MOG_BN_GROUPS.*'two'"):
        port_main.parse_args(["--variant", "multi-mnist", "--cfg",
                              MNIST_TRAIN])


MAIN_ARGV = ["--variant", "multi-mnist", "--cfg", MNIST_TRAIN]


@pytest.mark.parametrize("env, flags, want", [
    ({}, [], (False, 1)),
    ({"MOG_COMPUTE_DTYPE": "bfloat16"}, [], (True, 1)),
    ({}, ["--bf16"], (True, 1)),
    ({"MOG_COMPUTE_DTYPE": "float32"}, ["--bf16"], (True, 1)),
    ({"MOG_BN_GROUPS": "3"}, [], (False, 3)),
    ({}, ["--bn_groups", "3"], (False, 3)),
    ({"MOG_BN_GROUPS": "3"}, ["--bn_groups", "2"], (False, 2)),
    ({"MOG_BN_GROUPS": "4", "MOG_COMPUTE_DTYPE": "BF16"}, [], (True, 4)),
])
def test_train_entry_effective_knobs(monkeypatch, env, flags, want):
    """cli/main.py: ``--bf16`` is on under the flag or the env; an absent
    ``--bn_groups`` takes the env, else 1; a given one wins (JAX
    ``cli/main.py:58,188-195``). The model configs follow."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = port_main.parse_args([*MAIN_ARGV, *flags])
    assert (args.bf16, args.bn_groups) == want
    assert port_main.model_knobs(args) == {
        "compute_dtype": torch.bfloat16 if want[0] else None,
        "bn_groups": want[1]}


@pytest.mark.parametrize("env, flags, want", [
    ({}, [], False), ({"MOG_COMPUTE_DTYPE": "bf16"}, [], True),
    ({}, ["--bf16"], True), ({"MOG_COMPUTE_DTYPE": "f32"}, [], False)])
def test_serve_entry_effective_dtype(monkeypatch, env, flags, want):
    """cli/serve.py: the service computes bf16 under the env as under
    ``--bf16``."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = port_serve.parse_args(["--variant", "multi-mnist", "--device",
                                  "cpu", "--port", "0", *flags])
    assert args.bf16 is want


def test_service_built_under_the_env_computes_bf16(monkeypatch):
    monkeypatch.setenv("MOG_COMPUTE_DTYPE", "bfloat16")
    svc = port_serve.build_service(port_serve.parse_args(
        ["--variant", "multi-mnist", "--device", "cpu", "--port", "0"]))
    assert svc.mcfg.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("env, flags, want", [
    ({}, [], True), ({}, ["--no-bf16"], False),
    ({"MOG_COMPUTE_DTYPE": "bfloat16"}, ["--no-bf16"], True)])
def test_validate_tool_effective_dtype(monkeypatch, env, flags, want):
    """tools/validate_learning.py: bf16 by default; under the env even
    with ``--no-bf16``, as the JAX package's import-time knob computes."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert vl.parse_args(["mnist", *flags]).bf16 is want


def test_profile_tool_reads_the_env(monkeypatch):
    """tools/profile_step.py: the env turns ``--bf16`` on before the run
    starts (stopped where it asks for the card)."""
    seen = {}

    def stop(device="cuda"):
        raise RuntimeError("stop")

    monkeypatch.setenv("MOG_COMPUTE_DTYPE", "bfloat16")
    monkeypatch.setattr(profile_step, "resolve_device", stop)
    real_parse = profile_step.argparse.ArgumentParser.parse_args

    def spy(self, argv=None, namespace=None):
        seen["args"] = real_parse(self, argv, namespace)
        return seen["args"]

    monkeypatch.setattr(profile_step.argparse.ArgumentParser, "parse_args",
                        spy)
    with pytest.raises(RuntimeError, match="stop"):
        profile_step.main([])
    assert seen["args"].bf16 is True


def _tiny_cfg(tmp_path):
    yml = tmp_path / "mnist_tiny.yml"
    yml.write_text("TRAIN:\n    FLAG: True\n    BATCH_SIZE: 32\n"
                   "    MAX_EPOCH: 5\n    LR_DECAY_EPOCH: 10\n"
                   "GAN:\n    DF_DIM: 8\n    GF_DIM: 8\n")
    return str(yml)


def test_run_flags_record_the_effective_knobs(monkeypatch, tmp_path,
                                              capsys):
    """A train entry under both env knobs and no flags computes bf16 with
    2 groups and records that in run_flags.json (JAX records the flags;
    the port what it computed); a resume under the flags agrees with the
    record and warns of nothing."""
    monkeypatch.setenv("MOG_COMPUTE_DTYPE", "bfloat16")
    monkeypatch.setenv("MOG_BN_GROUPS", "2")
    out, data = tmp_path / "out", str(tmp_path / "data")
    write_synthetic_multimnist(data, n=64, split="train", seed=3)
    hist = port_main.main(["--variant", "multi-mnist", "--cfg",
                           _tiny_cfg(tmp_path), "--max_epochs", "1",
                           "--manualSeed", "3", "--device", "cpu",
                           "--data_dir", data, "--output_dir", str(out)])
    assert len(hist) == 1 and hist[0]["steps"] == 2
    assert np.isfinite(hist[0]["d_loss"])
    assert "bf16, BatchNorm groups 2" in capsys.readouterr().out
    flags = json.loads((out / "run_flags.json").read_text())
    assert (flags["bf16"], flags["bn_groups"]) == (True, 2)
    monkeypatch.delenv("MOG_COMPUTE_DTYPE")
    monkeypatch.delenv("MOG_BN_GROUPS")
    assert port_main.check_resume_flags(str(out), bn_groups=2,
                                        bf16=True) == []


def test_step_under_the_env_equals_the_flag_step(monkeypatch):
    """A GF-8 Multi-MNIST step whose config comes from the env equals the
    ``--bf16 --bn_groups 2`` step bit for bit, from one state and one
    batch of 8 (two groups of 4)."""
    cfg = cfg_from_file(MNIST_TRAIN, "multi-mnist")
    cfg.GAN.GF_DIM, cfg.GAN.DF_DIM = 8, 8
    flagged = port_main.parse_args([*MAIN_ARGV, "--bf16", "--bn_groups",
                                    "2"])
    monkeypatch.setenv("MOG_COMPUTE_DTYPE", "bfloat16")
    monkeypatch.setenv("MOG_BN_GROUPS", "2")
    from_env = port_main.parse_args(MAIN_ARGV)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        stage1_model_config(cfg, "multi-mnist"), 8, seed=3).items()}
    results = []
    for args in (flagged, from_env):
        mcfg = stage1_model_config(cfg, "multi-mnist",
                                   **port_main.model_knobs(args))
        assert (mcfg.compute_dtype, mcfg.bn_groups) == (torch.bfloat16, 2)
        state = create_state(mcfg, seed=5, device="cpu")
        metrics = make_train_step(mcfg)(
            state, batch, torch.Generator().manual_seed(11), 2e-4, 2e-4)
        results.append((metrics, {**state.g.state_dict(),
                                  **state.d.state_dict()}))
    (m0, s0), (m1, s1) = results
    assert m0.keys() == m1.keys()
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert s0.keys() == s1.keys()
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
