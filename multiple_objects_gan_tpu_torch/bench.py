"""Headline benchmark: Multi-MNIST 64px training throughput (images/s a
card), the port's counterpart of the JAX package's ``bench.py``.

    python -m multiple_objects_gan_tpu_torch.bench [--device cpu]

Prints ONE JSON line with the JAX bench's keys: {"metric", "value",
"unit", "vs_baseline", "mfu", "tflops_per_step", "step_ms", "variants"}.
``vs_baseline`` is null: the card's baseline is not set yet.

The step is ``train/step.py:make_train_step`` at ``MNIST``'s full width
(GF 128, DF 64), batch 128 of ``data/synthetic.py:synthetic_batch``, from
``create_state(cfg, seed=0)``, bf16 unless ``MOG_COMPUTE_DTYPE`` is
``f32`` or ``float32`` (then float32 with TF32 off, ``float32_policy``);
``MOG_BN_GROUPS`` sets the BatchNorm groups. Timing: 3 warm-up steps and
a host sync, then the best of 3 rounds of 30 steps, each round ending
with a host sync on its last step's ``d_loss`` (``.item()``: a
device-to-host copy cannot finish before the step that made the value,
and the steps chain on the state).

FLOPs a step come from one counted step
(``tools/bench_variants.py:count_step``: ``FlopCounterMode`` counts
convolutions and matrix products only, not elementwise work). ``mfu`` is
the achieved FLOP/s over the H100's dense peak for the compute dtype (989
TFLOP/s bf16, 67 TFLOP/s float32), null on the CPU. The physical-sanity
check raises if the achieved rate reaches that peak: the timing would
then not be synchronizing.

Run as a module, the parent runs the measurement in a timed child process
(:func:`run_guarded`) and retries a child that hangs or dies of a signal,
so one hung process cannot eat the whole run; the parent imports no CUDA
code. ``variants`` adds the clevr, coco-stackgan-2 and coco-attngan steps
of ``tools/bench_variants.py`` (:func:`bench_variants_extra`).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

METRIC = "multi_mnist_train_throughput"
UNIT = "images/sec/chip"
BATCH = 128         # cfg/mnist_train.yml TRAIN.BATCH_SIZE
N_STEPS = 30        # timed steps a round
ROUNDS = 3          # the best round counts
WARMUP = 3
# the variants and their bench functions in tools/bench_variants.py
VARIANTS = (("clevr", "bench_clevr"), ("coco-stackgan-2", "bench_stage2"),
            ("coco-attngan", "bench_attngan"))
MODULE = "multiple_objects_gan_tpu_torch.bench"


def headline_step(device="cuda", cfg=None, batch_size: int = BATCH):
    """The measured step: ``step() -> metrics`` on ``device`` (module
    docstring; ``tools/bench_variants.py:stage1_step``), and its compute
    dtype (None is float32)."""
    from multiple_objects_gan_tpu_torch.models.common import MNIST
    from multiple_objects_gan_tpu_torch.tools.bench_variants import (
        stage1_step)

    step, dtype, _ = stage1_step(cfg or MNIST, batch_size, device)
    return step, dtype


def main(device="cuda", cfg=None, batch_size: int = BATCH,
         n_steps: int = N_STEPS, rounds: int = ROUNDS) -> dict:
    """Measure, print the JSON line and return it as a dict. ``cfg``
    (default ``MNIST``), ``batch_size``, ``n_steps`` and ``rounds`` exist
    for small runs on the CPU; the CLI keeps the defaults."""
    import torch

    from multiple_objects_gan_tpu_torch.tools import bench_variants

    dev = torch.device(device)
    step, dtype = headline_step(device, cfg, batch_size)
    flops_per_step, _ = bench_variants.count_step(step)
    for _ in range(WARMUP):
        metrics = step()
    metrics["d_loss"].item()                     # device -> host sync
    best_dt = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n_steps):
            metrics = step()
        sync = metrics["d_loss"].item()
        best_dt = min(best_dt, time.perf_counter() - t0)
    if not math.isfinite(sync):
        raise RuntimeError("non-finite loss in bench step")

    # the step runs on one card, whatever the host has: per card is per
    # step
    img_per_sec = n_steps * batch_size / best_dt
    achieved = flops_per_step * n_steps / best_dt
    peak = bench_variants.peak_ops(dtype)
    # physical sanity: the measured rate must be below the card's peak
    if not achieved < peak:
        raise RuntimeError(
            f"measured {achieved / 1e12:.1f} TFLOP/s a card reaches the "
            f"H100's dense peak {peak / 1e12:.0f} TFLOP/s: the timing is "
            "not synchronizing")
    line = {
        "metric": METRIC,
        "value": round(img_per_sec, 1),
        "unit": UNIT,
        "vs_baseline": None,
        "mfu": round(achieved / peak, 4) if dev.type == "cuda" else None,
        "tflops_per_step": round(flops_per_step / 1e12, 4),
        "step_ms": round(best_dt / n_steps * 1000, 3),
        "variants": bench_variants_extra(device=device),
    }
    print(json.dumps(line), flush=True)
    return line


def bench_variants_extra(device="cuda") -> dict:
    """The clevr, coco-stackgan-2 and coco-attngan train steps of
    ``tools/bench_variants.py`` at the tool's own n, each row without its
    ``variant`` key; a variant that raises reports ``{"error": "<Type>:
    <msg>"}`` (200 characters at most) and the others still run. Skipped
    (``{}``) with ``MOG_BENCH_VARIANTS=0`` or ``false``."""
    if os.environ.get("MOG_BENCH_VARIANTS", "1") in ("0", "false"):
        return {}
    from multiple_objects_gan_tpu_torch.tools import bench_variants

    out = {}
    for name, fn in VARIANTS:
        try:
            row = getattr(bench_variants, fn)(device=device)
            row.pop("variant", None)
            out[name] = row
        except Exception as e:  # noqa: BLE001 — report, keep the headline
            out[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
    return out


def run_guarded(attempts: int = 3, timeout_s: float = 0.0,
                argv: tuple = ()) -> int:
    """Run the measurement (``python -m`` this module with
    ``MOG_BENCH_CHILD=1`` and ``argv``) in a timed child; retry a child
    that hangs past the timeout or dies of a signal, printing each retry
    on stderr. A clean non-zero exit is returned without a retry; 124
    after every attempt hung. The timeout is ``timeout_s``, else
    ``MOG_BENCH_TIMEOUT``, else 900 s without the variants and 2700 s
    with them. The child's output passes through unchanged."""
    import subprocess

    default_to = ("900" if os.environ.get("MOG_BENCH_VARIANTS", "1")
                  in ("0", "false") else "2700")
    timeout_s = timeout_s or float(os.environ.get("MOG_BENCH_TIMEOUT",
                                                  default_to))
    env = dict(os.environ, MOG_BENCH_CHILD="1")
    cmd = [sys.executable, "-m", MODULE, *argv]
    for attempt in range(1, attempts + 1):
        try:
            proc = subprocess.run(cmd, timeout=timeout_s, env=env)
        except subprocess.TimeoutExpired:
            print(f"bench attempt {attempt}/{attempts} hung past "
                  f"{timeout_s:.0f} s — retrying", file=sys.stderr,
                  flush=True)
            continue
        if proc.returncode == 0:
            return 0
        if proc.returncode < 0:      # killed by a signal
            print(f"bench attempt {attempt}/{attempts} died with signal "
                  f"{-proc.returncode} — retrying", file=sys.stderr,
                  flush=True)
            continue
        return proc.returncode
    print(f"bench failed: all {attempts} attempts hung", file=sys.stderr,
          flush=True)
    return 124


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if os.environ.get("MOG_BENCH_CHILD"):
        main(device=args.device)
        return 0
    return run_guarded(argv=("--device", args.device))


if __name__ == "__main__":
    sys.exit(cli())
