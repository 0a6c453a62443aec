"""The port's headline bench (``multiple_objects_gan_tpu_torch/bench.py``)
on the CPU: the child guard in the four cases tests/test_bench_guard.py
holds for the JAX bench (``subprocess.run`` stubbed), the JSON keys
against the JAX bench's source (read with ``ast``, not imported), one
small measurement at GF 16 / DF 8, batch 4, 2 steps and 1 round with the
module's clock replaced (``value`` = batch x steps / seconds whatever
``torch.cuda.device_count()`` says, ``mfu`` null on the CPU), the physical-sanity check at an impossible rate, and
the variants extra: skipped by ``MOG_BENCH_VARIANTS=0``, and a variant
that raises reported as ``{"error": ...}`` while the others report.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import subprocess
import types

import pytest
import torch

import chip_smoke
from multiple_objects_gan_tpu_torch import bench as port_bench
from multiple_objects_gan_tpu_torch.models.common import MNIST
from multiple_objects_gan_tpu_torch.tools import bench_variants

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dataclasses.replace(MNIST, gf_dim=16, df_dim=8)
B, N = 4, 2


@pytest.fixture(autouse=True)
def _setting(monkeypatch):
    for k in ("MOG_COMPUTE_DTYPE", "MOG_BN_GROUPS", "MOG_BENCH_TIMEOUT",
              "MOG_BENCH_CHILD"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MOG_BENCH_VARIANTS", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the guard


class _Proc:
    def __init__(self, returncode):
        self.returncode = returncode


def _timeouts_then_ok(calls, cmd, timeout=None, env=None):
    calls.append(env.get("MOG_BENCH_CHILD"))
    if len(calls) < 3:
        raise subprocess.TimeoutExpired(cmd, timeout)
    return _Proc(0)


def _signal_then_ok(calls, cmd, timeout=None, env=None):
    calls.append(env.get("MOG_BENCH_CHILD"))
    return _Proc(-6 if len(calls) == 1 else 0)   # SIGABRT, then success


def _clean_failure(calls, cmd, timeout=None, env=None):
    calls.append(env.get("MOG_BENCH_CHILD"))
    return _Proc(3)          # a clean non-zero exit (the sanity check)


def _always_hangs(calls, cmd, timeout=None, env=None):
    calls.append(env.get("MOG_BENCH_CHILD"))
    raise subprocess.TimeoutExpired(cmd, timeout)


@pytest.mark.parametrize("run, attempts, rc, n_calls, retries", [
    (_timeouts_then_ok, 3, 0, 3, 2),
    (_signal_then_ok, 2, 0, 2, 1),
    (_clean_failure, 3, 3, 1, 0),
    (_always_hangs, 2, 124, 2, 2),
], ids=["retry-on-timeout", "retry-on-signal-death",
        "clean-failure-not-retried", "124-after-every-attempt-hung"])
def test_guard(monkeypatch, capsys, run, attempts, rc, n_calls, retries):
    """JAX's four guard cases: the child flag set on every attempt, the
    command the port's module, each retry said on stderr."""
    calls, cmds = [], []

    def fake_run(cmd, timeout=None, env=None):
        cmds.append(cmd)
        assert timeout == 1.0
        return run(calls, cmd, timeout=timeout, env=env)

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert port_bench.run_guarded(attempts=attempts, timeout_s=1.0) == rc
    assert calls == ["1"] * n_calls
    assert all(c[1:3] == ["-m", "multiple_objects_gan_tpu_torch.bench"]
               for c in cmds)
    assert capsys.readouterr().err.count("retrying") == retries


def test_guard_timeout_defaults(monkeypatch):
    """900 s without the variants, 2700 s with them, MOG_BENCH_TIMEOUT
    over both."""
    seen = []

    def fake_run(cmd, timeout=None, env=None):
        seen.append(timeout)
        return _Proc(0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    port_bench.run_guarded()
    monkeypatch.setenv("MOG_BENCH_VARIANTS", "1")
    port_bench.run_guarded()
    monkeypatch.setenv("MOG_BENCH_TIMEOUT", "5")
    port_bench.run_guarded()
    assert seen == [900.0, 2700.0, 5.0]


# ------------------------------------------------------------- the line


def _jax_keys() -> set:
    """The keys of the dict bench.py prints with json.dumps."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dumps({...}) in bench.py")


def _clock(step: float):
    """A stand-in for the module's ``time``: perf_counter advances by
    ``step`` seconds a call."""
    t = [0.0]

    def perf_counter():
        t[0] += step
        return t[0]

    return types.SimpleNamespace(perf_counter=perf_counter)


def test_keys_are_the_jax_bench_keys():
    keys = _jax_keys()
    assert keys == {"metric", "value", "unit", "vs_baseline", "mfu",
                    "tflops_per_step", "step_ms", "variants"}
    assert keys == chip_smoke.HEADLINE_KEYS


@pytest.mark.parametrize("cards", [1, 4])
def test_main_prints_one_line_at_batch_times_steps_over_seconds(
        monkeypatch, capsys, cards):
    """The step runs on one card: a host with more cards does not divide
    the rate."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(port_bench, "time", _clock(0.5))
    line = port_bench.main(device="cpu", cfg=SMALL, batch_size=B, n_steps=N,
                           rounds=1)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert set(line) == _jax_keys()
    # one round: t0 at 0.5, the end at 1.0
    assert line["value"] == round(B * N / 0.5, 1)
    assert line["step_ms"] == round(0.5 / N * 1000, 3)
    assert line["mfu"] is None and line["vs_baseline"] is None
    assert line["metric"] == "multi_mnist_train_throughput"
    assert line["unit"] == "images/sec/chip"
    assert line["variants"] == {}
    flops, _ = bench_variants.count_step(port_bench.headline_step(
        "cpu", SMALL, B)[0])
    assert line["tflops_per_step"] == round(flops / 1e12, 4) > 0


def test_headline_step_follows_the_env_knobs(monkeypatch):
    """bf16 unless MOG_COMPUTE_DTYPE is f32/float32 (any case)."""
    assert port_bench.headline_step("cpu", SMALL, 2)[1] == torch.bfloat16
    monkeypatch.setenv("MOG_COMPUTE_DTYPE", "Float32")
    assert port_bench.headline_step("cpu", SMALL, 2)[1] is None


def test_sanity_check_fires_at_an_impossible_rate(monkeypatch, capsys):
    """A round of 2 steps in 1e-15 s is above the H100's dense peak."""
    monkeypatch.setenv("MOG_COMPUTE_DTYPE", "f32")
    monkeypatch.setattr(port_bench, "time", _clock(1e-15))
    with pytest.raises(RuntimeError, match="dense peak"):
        port_bench.main(device="cpu", cfg=SMALL, batch_size=B, n_steps=N,
                        rounds=1)
    assert capsys.readouterr().out == ""


# --------------------------------------------------------- the variants


def test_variants_skipped_by_the_env(monkeypatch):
    called = []
    for _, fn in port_bench.VARIANTS:
        monkeypatch.setattr(bench_variants, fn,
                            lambda device="cuda": called.append(1))
    for value in ("0", "false"):
        monkeypatch.setenv("MOG_BENCH_VARIANTS", value)
        assert port_bench.bench_variants_extra(device="cpu") == {}
    assert not called


def test_a_variant_that_raises_reports_an_error(monkeypatch):
    monkeypatch.setenv("MOG_BENCH_VARIANTS", "1")

    def row(name):
        def fn(device="cuda"):
            assert device == "cpu"
            return {"variant": name, "batch": 2, "step_ms": 1.0}
        return fn

    def broken(device="cuda"):
        raise MemoryError("x" * 300)

    monkeypatch.setattr(bench_variants, "bench_clevr", row("clevr"))
    monkeypatch.setattr(bench_variants, "bench_stage2", broken)
    monkeypatch.setattr(bench_variants, "bench_attngan", row("attngan"))
    out = port_bench.bench_variants_extra(device="cpu")
    assert list(out) == ["clevr", "coco-stackgan-2", "coco-attngan"]
    assert out["clevr"] == out["coco-attngan"] == {"batch": 2,
                                                   "step_ms": 1.0}
    err = out["coco-stackgan-2"]["error"]
    assert err.startswith("MemoryError: xxx") and len(err) == 200
