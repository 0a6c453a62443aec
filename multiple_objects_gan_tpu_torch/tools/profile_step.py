"""Where the Stage-1 train step's time goes on the card, by kernel.

    python -m multiple_objects_gan_tpu_torch.tools.profile_step [--bf16]

Runs the full-width Multi-MNIST train step at batch 128
(``cfg/mnist_train.yml``; the reference init from seed 0, synthetic data)
for three warm-up steps, then traces five steps with ``torch.profiler``
(CPU and CUDA activity) and prints the device time of each kernel group
per step (convolutions and matrix products, cuDNN's layout transforms,
BatchNorm and other elementwise or reduction kernels, the port's K1/K2,
the optimizer, copies),
the top kernels by device time, and the device's busy share of the traced
wall time. The last line is one JSON object of those numbers. It needs a
card; float32 runs with TF32 off, as ``chip_smoke.py`` times it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from multiple_objects_gan_tpu_torch import resolve_device
from multiple_objects_gan_tpu_torch.data.synthetic import synthetic_multimnist
from multiple_objects_gan_tpu_torch.models.common import MNIST
from multiple_objects_gan_tpu_torch.train.state import create_state
from multiple_objects_gan_tpu_torch.train.step import make_train_step

BATCH = 128    # cfg/mnist_train.yml TRAIN.BATCH_SIZE
STEPS = 5      # traced steps
TOP = 12       # kernels listed

# kernel-name fragments of each group, tried in this order
GROUPS = [
    ("K1/K2 (STN place)", ("stn_place",)),
    ("optimizer", ("multi_tensor", "adam", "foreach")),
    ("layout (cuDNN NCHW<->NHWC)", ("nchwtonhwc", "nhwctonchw")),
    ("conv / matmul", ("conv", "gemm", "cutlass", "sm90", "sm80", "cudnn",
                       "xmma", "implicit", "wgrad", "dgrad", "fprop",
                       "winograd", "fft", "complex", "region_transform")),
    ("reduction", ("reduce", "norm", "welford", "batch_norm")),
    ("copy / cast", ("copy", "memcpy", "memset", "cat", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "upsample",
                     "index")),
]


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def kernel_times(prof) -> dict[str, float]:
    """Device ms of each kernel in a finished ``torch.profiler`` trace;
    raises when the trace holds no device time."""
    kernels: dict[str, float] = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        # a user annotation (the optimizer's record_function range) spans
        # kernels counted on their own
        if getattr(e, "is_user_annotation", False) or "#" in e.key:
            continue
        if dev_us and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + dev_us / 1e3
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    return kernels


def group_times(kernels: dict[str, float]) -> dict[str, float]:
    """The kernels' device ms summed by :data:`GROUPS`."""
    groups: dict[str, float] = {}
    for name, ms in kernels.items():
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + ms
    return groups


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bf16", action="store_true")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(
        MNIST, compute_dtype=torch.bfloat16 if args.bf16 else None)
    state = create_state(cfg, seed=0, device=dev)
    data = {k: torch.from_numpy(v).to(dev)
            for k, v in synthetic_multimnist(BATCH, seed=8).items()}
    step = make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(3):
        step(state, data, gen, 2e-4, 2e-4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(state, data, gen, 2e-4, 2e-4)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = kernel_times(prof)
    groups = group_times(kernels)
    busy = sum(kernels.values())
    n = STEPS
    kind = "bf16" if args.bf16 else "float32 (TF32 off)"
    print(f"{torch.cuda.get_device_name(dev)}; train step, batch {BATCH}, "
          f"full width, {kind}: {n} traced steps, {wall_ms / n:.2f} ms a step "
          f"on the host clock (profiler on), device busy {busy / n:.2f} ms a "
          f"step ({busy / wall_ms:.1%} of the wall time)", flush=True)
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:20s} {ms / n:8.3f} ms a step ({ms / busy:6.1%})",
              flush=True)
    print("top kernels:", flush=True)
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"  {ms / n:8.3f} ms  [{group_of(name)}] {name[:110]}",
              flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "bf16": args.bf16, "batch": BATCH, "steps": n,
                      "wall_ms_per_step": wall_ms / n,
                      "busy_ms_per_step": busy / n,
                      "groups_ms_per_step": {g: ms / n
                                             for g, ms in groups.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
