#!/usr/bin/env python3
"""Drive the PyTorch port (multiple_objects_gan_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root, on a machine with a CUDA card, nvcc and the
checkpoint runs_r5/mnist_repin/netG_final.pth. Phases, each logged with the
elapsed time:

  1. device   - the card's name and power limit, torch and CUDA versions;
  2. build    - nvcc builds csrc/stn_place.cu and csrc/normconv.cu for
                sm_90a, one nvcc for each, started together; one ptxas
                line a kernel (registers, shared memory, spills);
  3. kernel   - the STN place kernel (K1) against its plain PyTorch version
                on the card, at the served generator's shape, at the G and
                D shapes of the train step and at edge cases (padded,
                off-canvas and wider-than-canvas boxes, 37 channels, sides
                32 and 64, a side of 65 refused), timed cold in turns with
                the plain version (plain, K1, K1, plain, on a rotation of
                input copies larger than twice the L2) beside the bound;
  4. model    - the full-width trained Stage1G on the card against the port
                on the CPU, batch 64, and its forward time on the card;
  5. serve    - the port's HTTP server on the card: concurrent /generate
                requests, a 64-item request, /stats, and the proof that the
                served batches went through K1 (its launch count);
  6. grad     - the place backward (K2) against its plain version on the
                card, at the G and D shapes of the train step and at edge
                cases, timed cold in turns with the plain version (as K1
                in phase 3) and warm (one set of buffers) beside the bound
                and the rate it implies;
  7. autograd - gradients through StnPlaceMulti (K3) on the card against
                the CPU, and a train-mode Stage1G's object-pathway gradient
                on the card against the CPU;
  8. step     - one full-width train step (batch 128) on the card against
                the same step on the CPU, from the reference init and from
                the weights tests/test_step_parity.py draws: losses,
                BatchNorm statistics and per-tensor gradient cosines held,
                the Adam deltas read;
  9. steptime - the train step's time on the card at batch 128, and its K1
                and K2 launches per step;
 10. train    - the port's train entry (cli/main.py) for one synthetic
                epoch on the card, and the proof that it went through K1
                and K2 (their launch counts) and not K4;
 11. normconv - K4's path, the port's spike tool (tools/spike_normconv.py:
                its check, then its bench at the three hot shapes), with
                its launches; then K4 against its plain version, twice for
                bit-identical sums, at the two check shapes, the three hot
                shapes, five edge shapes of its tiling and a zero-gamma
                channel; then K4 timed in turns with the plain chain and
                cuDNN's bf16 F.conv2d at the hot shapes (TFLOP/s, share of
                the bound);
 12. bf16     - K1 and K2 in bf16 against their plain versions at the G
                and D train shapes and the serve shape, with padded boxes,
                boxes off the canvas and wider than it, and at K1's tile
                edges (37 channels, sides 32 and 64; 65 refused), timed
                cold in turns (as in phases 3 and 6);
 13. step16   - one bf16 train step, full width, on the card against the
                same step on the CPU: losses, BatchNorm statistics and
                per-tensor gradient cosines held;
 14. time16   - the bf16 train step's time at batch 128 beside phase 9's
                float32 time, and its K1 and K2 launches per step;
 15. entry16  - the train entry for one epoch with --bf16 and one with
                --bn_groups 2, and one 64-item request served with --bf16
                against the card's float32 image of it.

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Any failed check raises, and the script
exits non-zero; without a card it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import base64
import concurrent.futures
import dataclasses
import http.client
import json
import os
import statistics
import struct
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import torch

from multiple_objects_gan_tpu_torch.cli import main as train_main
from multiple_objects_gan_tpu_torch.cli.serve import (
    Stage1Service, _item_layout, _png_b64, build_service, serve)
from multiple_objects_gan_tpu_torch.data.synthetic import synthetic_multimnist
from multiple_objects_gan_tpu_torch.io.weights import load_reference_g
from multiple_objects_gan_tpu_torch.models.common import MNIST
from multiple_objects_gan_tpu_torch.models.stage1 import build_stage1_g
from multiple_objects_gan_tpu_torch.ops import _build
from multiple_objects_gan_tpu_torch.ops import normconv as k4
from multiple_objects_gan_tpu_torch.ops import stn_place_cuda as k1
from multiple_objects_gan_tpu_torch.ops.stn import place_weights
from multiple_objects_gan_tpu_torch.tools import spike_normconv
from multiple_objects_gan_tpu_torch.train.state import create_state
from multiple_objects_gan_tpu_torch.train.step import make_train_step

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "runs_r5", "mnist_repin", "netG_final.pth")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
KERNEL_ATOL = 1e-5
MODEL_ATOL = 5e-4
MIN_SEPARATION = 0.5
GRAD_RTOL = 1e-3            # Stage1G object-pathway gradient, card vs CPU
LOSS_ATOL = 1e-3            # train step, card vs CPU: tests/test_step_parity.py
STATS_ATOL = 5e-4
MIN_GRAD_COSINE = 0.995     # per tensor, card vs CPU (PERF.md: >= 0.9984 read)
STEP_BATCH = 128            # cfg/mnist_train.yml TRAIN.BATCH_SIZE
LR = 2e-4
DEVICE = "cuda"
BF16 = dataclasses.replace(MNIST, compute_dtype=torch.bfloat16)
BF16_ULPS = 1               # a bf16 kernel against its plain version: ulps
                            # of the largest |value| (the same f32 sums in
                            # another order, rounded to bf16 once)
K4_SUM_RTOL = 1e-3          # K4's sums against the plain ones, of max |sum|
STEP16_BATCH = STEP_BATCH   # the bf16 step card vs CPU (phase 13): the CPU's
                            # bf16 step at full width and batch 128 takes
                            # about 15 s, so nothing is cut
# the bf16 step card vs CPU (phase 13), from tests/test_bf16.py's rtol 0.05
# tightened to what an H100 showed at batch 128 (PERF.md): losses 2.98e-3
# relative (limit 3.4 times that), statistics 1.79e-3 (2.8 times), lowest
# gradient cosine 0.939, a layout-encoder BatchNorm bias (the limit leaves
# 1 - 0.9 = 1.6 times its 0.061 gap to 1). A cut place backward reads 0 on
# the object pathways, a mirrored one down to 0.55 (on the CPU at gf/df 8:
# tests/test_torch_port_bf16.py holds both below the limit)
BF16_LOSS_RTOL = 0.01
BF16_STATS_ATOL = 5e-3
BF16_MIN_GRAD_COSINE = 0.9
MIN_BF16_SEPARATION = MIN_SEPARATION
MAX_BF16_SERVE_MEAN_DIFF = 0.05  # bf16 served image vs float32, [-1, 1]
COLD_BYTES = 100 * 2**20    # twice the card's 50 MB L2: K1 and K2 are timed
                            # on a rotation of inputs that reads more than
                            # this before it reuses one (cold_sets)


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, warmup: int = 5, runs: int = 50) -> float:
    """Median time of one call of ``fn`` by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cold_sets(args, read_bytes: int, min_bytes: int = COLD_BYTES) -> list:
    """``args``, a call's tensor arguments, and copies of them: enough sets
    that a rotation through them reads more than ``min_bytes`` (each call
    ``read_bytes``) before it comes back to a set, so that every call finds
    its inputs in device memory and not in the L2 cache. The first set is
    ``args`` itself; there are at least two."""
    n = max(2, min_bytes // max(1, read_bytes) + 1)
    return [tuple(args)] + [tuple(a.clone() for a in args)
                            for _ in range(n - 1)]


def run_ms(fn, warmup: int = 5, runs: int = 50, sets=None) -> float:
    """Time of one call of ``fn`` in a run of ``runs`` calls back to back
    between two CUDA events, over the count: the host's launch work
    overlaps the card's, as in the train step, where :func:`cuda_ms` adds
    it to every call. With ``sets`` (:func:`cold_sets`), call k, warm-up
    included, takes the arguments ``sets[k % len(sets)]``; without, ``fn``
    takes none and reads the same buffers every call."""
    sets = sets or [()]
    for k in range(warmup):
        fn(*sets[k % len(sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(warmup, warmup + runs):
        fn(*sets[k % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def graph_ms(fn, sets, runs: int = 50) -> float:
    """Device time of one call of ``fn``: ``runs`` calls, call k taking
    ``sets[k % len(sets)]``, captured in one CUDA graph and replayed
    between two CUDA events, over the count. The host's launch work, which
    :func:`run_ms` overlaps but cannot hide when a call's device work is
    shorter than its host work, is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # capture wants a warmed-up side stream
        for k in range(3):
            fn(*sets[k % len(sets)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # relaxed: a wrapper sets its kernel's shared-memory attribute per launch
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for k in range(runs):
            fn(*sets[k % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def in_turns(order, warmup: int = 5, runs: int = 50, sets=None) -> dict:
    """Time the calls of ``order``, a list of (name, fn) in the order to
    run them (plain, kernel, kernel, plain), each reading a run of ``runs``
    back-to-back calls (:func:`run_ms`, through ``sets`` when given);
    returns {name: [reading, ...]} in run order."""
    out: dict = {}
    for name, fn in order:
        out.setdefault(name, []).append(run_ms(fn, warmup, runs, sets))
    return out


def ptxas_lines(log: str) -> list[str]:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name (the
    readable part of the mangled one), registers, shared memory, stack
    frame and spill stores and loads."""
    out, name, frame = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = mangled
            for key in ("normconv", "stn_place"):
                at = mangled.rfind(key)
                if at >= 0:
                    name = mangled[at:].split("EEv")[0].split("Ev")[0]
                    break
            frame = ""
        elif "bytes stack frame" in line and name:
            frame = line.strip()
        elif "Used" in line and "registers" in line and name:
            used = line.split("Used", 1)[1].strip()
            out.append(f"{name}: used {used}; {frame or 'no frame line'}")
            name = None
    return out


# ------------------------------------------------------------------ phases


def phase_device():
    log("phase 1/15 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible")
    # full float32 everywhere below: the plain versions and the model
    # comparison are numerical references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN (torch.backends.*.allow_tf32 = False)")
    return name


def phase_build():
    log("phase 2/15 build")
    names = ("stn_place", "normconv")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build.build, names))
    for b in built:
        log(f"build: {os.path.relpath(b.path, ROOT)} ready in "
            f"{b.seconds:.2f}s; ptxas -v, one line a kernel:")
        lines = ptxas_lines(b.log)
        for line in lines:
            print(f"  {line}", flush=True)
        check(bool(lines) or not b.log, f"no ptxas report in the build log "
              f"of {b.path}:\n{b.log}")


def _service_boxes(rs, b, o):
    """Layouts as the service draws them for items without one."""
    pairs = [_item_layout({}, o, 10, rs) for _ in range(b)]
    return np.stack([p[1] for p in pairs])


def _bound(features, bbox, out_hw):
    """Least time for this run's data: the input values with a non-zero
    weight, the boxes and the output, in the features' element size, over
    the memory rate; two flops a tap over the float32 rate (the kernel's
    arithmetic in either type). Returns (bound_ms, bound_by, dense_ms,
    read_bytes): dense_ms reads every input value, read_bytes is what the
    bound reads."""
    b, o, c, hi, wi = features.shape
    es = features.element_size()
    wy, wx = place_weights(bbox.reshape(b * o, 4), out_hw, (hi, wi))
    rows = (wy != 0).any(dim=1).sum(dim=1)
    cols = (wx != 0).any(dim=1).sum(dim=1)
    read = int((rows * cols).sum()) * c * es + bbox.numel() * 4
    out_bytes = b * c * out_hw[0] * out_hw[1] * es
    taps = int(((wy != 0).sum(2)[:, :, None]
                * (wx != 0).sum(2)[:, None, :]).sum()) * c
    bytes_ms = (read + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * taps / F32_OPS_PER_S * 1e3
    dense_ms = (features.numel() * es + bbox.numel() * 4 + out_bytes) \
        / HBM_BYTES_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), dense_ms, read


def phase_kernel():
    log("phase 3/15 kernel against its plain version, on the card")
    rs = np.random.RandomState(0)
    dev = torch.device(DEVICE)

    def case(b, o, c, hw, kind):
        feats = rs.randn(b, o, c, hw[0], hw[1]).astype(np.float32)
        bbox = _service_boxes(rs, b, o)
        if kind == "padded":          # every other item: all objects padded
            bbox[::2] = -1.0
        elif kind == "off-canvas":    # boxes that stick out on every side
            w = rs.uniform(0.3, 0.6, (b, o))
            h = rs.uniform(0.3, 0.6, (b, o))
            bbox = np.stack([rs.uniform(-0.4, 0.9, (b, o)),
                             rs.uniform(-0.4, 0.9, (b, o)), w, h],
                            -1).astype(np.float32)
        elif kind == "train":         # the train step's boxes
            bbox = _train_boxes(b, int(rs.randint(1 << 30)))
        elif kind == "wide":          # wider than the canvas, any place
            bbox = _grad_boxes(rs, b, o, "wide")
        return (torch.from_numpy(feats).to(dev),
                torch.from_numpy(bbox).to(dev))

    cases = [  # (label, (B, O, C, input side, boxes), output side)
        ("generator path", (64, 3, 256, (16, 16), "service"), 16),
        ("train step, G", (STEP_BATCH, 3, 256, (16, 16), "train"), 16),
        ("train step, D, 15x15", (STEP_BATCH, 3, 128, (15, 15), "train"), 16),
        ("padded objects", (64, 3, 256, (16, 16), "padded"), 16),
        ("boxes partly off the canvas", (64, 3, 256, (16, 16), "off-canvas"),
         16),
        ("odd channel count", (64, 3, 37, (16, 16), "service"), 16),
        ("batch of one", (1, 3, 256, (16, 16), "service"), 16),
        ("15x15 maps onto the 16x16 canvas", (64, 3, 128, (15, 15), "service"),
         16),
        ("boxes wider than the canvas", (STEP_BATCH, 3, 256, (16, 16), "wide"),
         16),
        ("boxes wider than the canvas, 15x15",
         (STEP_BATCH, 3, 128, (15, 15), "wide"), 16),
    ] + K1_TILE_EDGES
    worst = 0.0
    timed = {}
    for label, (b, o, c, hw, kind), side in cases:
        feats, bbox = case(b, o, c, hw, kind)
        got = k1.stn_place_multi_nchw(feats, bbox, (side, side))
        want = k1.stn_place_multi_plain(feats, bbox, (side, side))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        log(f"  {label}: {tuple(feats.shape)} -> {(side, side)}: max |kernel "
            f"- plain| = {err:.3e} (atol {KERNEL_ATOL:g}); tile "
            f"{k1.place_tile(hw, (side, side))}")
        check(err <= KERNEL_ATOL, f"K1 disagrees with its plain version "
              f"({label}): {err:.3e} > {KERNEL_ATOL:g}")
        if kind == "padded":
            check(int(torch.count_nonzero(got[::2])) == 0,
                  "padded items must place exact zeros")
        if kind in ("service", "train") and c != 37 and b > 1 and side == 16:
            timed.setdefault(f"{kind} {hw[0]}", (feats, bbox))
    check_side_limit(dev, torch.float32)

    out = {"max_abs_err": worst}
    for path, key in (("serve", "service 16"), ("train G", "train 16"),
                      ("train D", "train 15")):
        feats, bbox = timed[key]
        out[path] = time_place(feats, bbox, f"K1 at the {path} shape")
    return out


# K1 at the sides of Stage 2's places (label, (B, O, C, input side, boxes),
# output side), where its channel tile halves to 4 and to 1
K1_TILE_EDGES = [
    ("32x32 onto 32x32", (8, 3, 64, (32, 32), "service"), 32),
    ("64x64 onto 64x64", (4, 3, 32, (64, 64), "service"), 64),
]


def check_side_limit(dev, dtype):
    """K1 refuses a side above MAX_SIDE (64) with a ValueError before it
    launches anything."""
    before = k1.launch_count()
    for in_side, out_side in ((65, 16), (16, 65)):
        feats = torch.zeros((1, 3, 4, in_side, in_side), device=dev,
                            dtype=dtype)
        bbox = torch.full((1, 3, 4), 0.25, device=dev)
        try:
            k1.stn_place_multi_nchw(feats, bbox, (out_side, out_side))
        except ValueError as e:
            log(f"  side {max(in_side, out_side)} ({in_side} -> {out_side}), "
                f"{str(dtype)[6:]}: refused ({e})")
        else:
            check(False, f"K1 took a side of {max(in_side, out_side)}")
    check(k1.launch_count() == before, "a refused call launched K1")


def time_place(feats, bbox, label):
    """K1 and its plain version timed cold in turns (plain, kernel, kernel,
    plain), each reading a run of 50 calls (:func:`run_ms`) on a rotation
    of input copies that finds every call's inputs in device memory
    (:func:`cold_sets`), beside the bound for this run's boxes and the rate
    it implies."""
    bound_ms, bound_by, dense_ms, read = _bound(feats, bbox, (16, 16))
    sets = cold_sets((feats, bbox), read)

    def kernel(f, bb):
        return k1.stn_place_multi_nchw(f, bb, (16, 16))

    def plain(f, bb):
        return k1.stn_place_multi_plain(f, bb, (16, 16))

    t = in_turns([("plain", plain), ("kernel", kernel), ("kernel", kernel),
                  ("plain", plain)], sets=sets)
    ms, plain_ms = statistics.mean(t["kernel"]), statistics.mean(t["plain"])
    dev_ms = graph_ms(kernel, sets)
    gbps = bound_ms / ms * HBM_BYTES_PER_S / 1e9 if bound_by == "bytes" \
        else float("nan")
    log(f"{label} {tuple(feats.shape)} -> (16, 16) {str(feats.dtype)[6:]}, "
        f"cold in turns (plain, K1, K1, plain; CUDA events around 50 calls "
        f"back to back each, rotating over {len(sets)} copies of the "
        f"inputs): K1 {t['kernel'][0]:.4f}, {t['kernel'][1]:.4f} ms; plain "
        f"{t['plain'][0]:.4f}, {t['plain'][1]:.4f} ms; bound {bound_ms:.4f} "
        f"ms ({bound_by}, this run's boxes; {dense_ms:.4f} ms if every input "
        f"value were read); {gbps:.0f} GB/s of the bytes it needs, "
        f"{bound_ms / ms:.1%} of the bound; on the device alone (the same "
        f"calls in a CUDA graph) {dev_ms:.4f} ms, {bound_ms / dev_ms:.1%} of "
        f"the bound")
    return {"ms": ms, "ms_turns": t["kernel"], "plain_ms": plain_ms,
            "plain_ms_turns": t["plain"], "graph_ms": dev_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "dense_bound_ms": dense_ms, "share_of_bound": bound_ms / ms,
            "graph_share_of_bound": bound_ms / dev_ms, "gb_per_s": gbps,
            "input_sets": len(sets)}


def phase_model():
    log("phase 4/15 model: full-width trained Stage1G, card against CPU")
    sd = load_reference_g(CKPT)
    g_gpu = build_stage1_g(MNIST, sd, device=DEVICE)
    g_cpu = build_stage1_g(MNIST, sd, device="cpu")
    n_params = sum(p.numel() for p in g_gpu.parameters())
    log(f"weights: {os.path.relpath(CKPT, ROOT)} ({len(sd)} tensors, "
        f"{n_params} parameters, ngf {MNIST.ngf})")
    rs = np.random.RandomState(1)
    z = torch.from_numpy(rs.randn(64, MNIST.z_dim).astype(np.float32))
    bbox = torch.from_numpy(_service_boxes(rs, 64, MNIST.num_objects))
    labels = torch.zeros(64, MNIST.num_objects, MNIST.label_dim)
    labels.scatter_(2, torch.from_numpy(rs.randint(0, 10, (64, 3, 1))), 1.0)
    labels[bbox[..., 2] < 0] = 0.0
    args_gpu = [t.to(DEVICE) for t in (z, bbox, labels)]
    with torch.inference_mode():
        on_gpu = g_gpu(*args_gpu).cpu()
        on_cpu = g_cpu(z, bbox, labels)
    diff = float((on_gpu - on_cpu).abs().max())
    check(bool(torch.isfinite(on_gpu).all()), "non-finite image values")
    log(f"generator card vs CPU, batch 64, float32 both (TF32 off): max "
        f"|diff| = {diff:.3e} (atol {MODEL_ATOL:g}); image mean "
        f"{float(on_gpu.mean()):.4f} std {float(on_gpu.std()):.4f}")
    check(diff <= MODEL_ATOL, f"card and CPU disagree: {diff:.3e}")
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: g_gpu(*args_gpu), warmup=3, runs=20)
    log(f"generator forward at batch 64 on the card: {fwd_ms:.3f} ms "
        f"(CUDA events, median of 20; {64e3 / fwd_ms:.0f} images/s)")
    imgs = on_gpu.permute(0, 2, 3, 1).numpy()
    encode = []
    for _ in range(5):
        t = time.perf_counter()
        for im in imgs:
            _png_b64(im)
        encode.append((time.perf_counter() - t) * 1e3)
    log(f"PNG + base64 of 64 images on the host: "
        f"{statistics.median(encode):.2f} ms (host clock, median of 5)")
    return fwd_ms


def _png_gray64(b64: str):
    """Decode a served PNG without an imaging library: signature, IHDR of
    a 64x64 8-bit grayscale image, IDAT rows of filter type 0."""
    raw = base64.b64decode(b64)
    check(raw[:8] == b"\x89PNG\r\n\x1a\n", "PNG signature")
    length, kind = struct.unpack(">I4s", raw[8:16])
    check(kind == b"IHDR" and length == 13, "IHDR chunk")
    check(struct.unpack(">IIBBBBB", raw[16:29]) == (64, 64, 8, 0, 0, 0, 0),
          "IHDR: 64x64, 8-bit grayscale")
    pos, data = 33, b""
    while pos < len(raw):
        length, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        if kind == b"IDAT":
            data += raw[pos + 8:pos + 8 + length]
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(data), np.uint8).reshape(64, 65)
    check(not rows[:, 0].any(), "PNG row filters")
    return rows[:, 1:]


def _separation(u8, boxes) -> float:
    """In-box minus out-of-box mean luminance in [-1, 1] units (the
    separation measure of tools/validate_learning.py)."""
    img = u8.astype(np.float32) / 127.5 - 1.0
    mask = np.zeros(img.shape, bool)
    for x, y, w, h in boxes:
        mask[int(round(y * 64)):int(round((y + h) * 64)),
             int(round(x * 64)):int(round((x + w) * 64))] = True
    return float(img[mask].mean() - img[~mask].mean())


def phase_serve():
    log("phase 5/15 serve: the port's main path over HTTP, on the card")
    k1.reset_launch_count()
    svc = Stage1Service(MNIST, CKPT, seed=0, device=DEVICE)
    httpd = serve(argparse.Namespace(variant="multi-mnist",
                                     host="127.0.0.1", port=0,
                                     max_wait_ms=5.0), svc)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    log(f"serving on 127.0.0.1:{port}, max_batch {svc.max_batch}, weights "
        f"{os.path.relpath(CKPT, ROOT)}")

    def request(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request(method, path,
                         body=None if body is None else json.dumps(body))
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    try:
        results = [None] * 24

        def call(i):
            # 1-3 items, every other one with a random layout
            items = [{} if (i + j) % 2 else
                     {"labels": [(i + k) % 10 for k in range(1 + j % 3)],
                      "bboxes": [[0.05 + 0.3 * k, 0.3, 0.3, 0.35]
                                 for k in range(1 + j % 3)]}
                     for j in range(1 + i % 3)]
            results[i] = (request("POST", "/generate", {"items": items}),
                          len(items))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(results))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            check(not t.is_alive(), "a request did not finish")
        n_images = 0
        for (status, body), n in results:
            check(status == 200, f"/generate returned {status}: {body}")
            check(len(body["images"]) == n, "one image per item")
            for b64 in body["images"]:
                _png_gray64(b64)
                n_images += 1
        log(f"{len(results)} concurrent requests, {n_images} images: all "
            "200, valid 64x64 grayscale PNGs")

        rs = np.random.RandomState(2)
        items, boxes = [], []
        for _ in range(64):
            n = int(rs.randint(1, 4))
            w, h = rs.uniform(0.25, 0.4, n), rs.uniform(0.25, 0.4, n)
            bb = np.stack([rs.uniform(0, 1 - w), rs.uniform(0, 1 - h), w, h],
                          -1).round(4).tolist()
            items.append({"labels": rs.randint(0, 10, n).tolist(),
                          "bboxes": bb})
            boxes.append(bb)
        t = time.perf_counter()
        status, body = request("POST", "/generate", {"items": items})
        latency_ms = (time.perf_counter() - t) * 1e3
        check(status == 200 and len(body["images"]) == 64,
              f"64-item request: {status}")
        sep = [_separation(_png_gray64(b), bb)
               for b, bb in zip(body["images"], boxes)]
        log(f"64-item request: {latency_ms:.1f} ms end to end over HTTP "
            f"(host clock); digits in their boxes: separation mean "
            f"{np.mean(sep):.3f}, min {np.min(sep):.3f} (need mean > "
            f"{MIN_SEPARATION})")
        check(float(np.mean(sep)) > MIN_SEPARATION,
              "served images do not place content in the requested boxes")
        status, stats = request("GET", "/stats")
        check(status == 200, "/stats")
        log(f"/stats: {stats}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.close()
        thread.join(timeout=30)
    launches = (k1.launch_count(), k1.grad_launch_count())
    check(stats["device"].startswith(DEVICE), "served on the card")
    check(launches[0] == svc.device_batches == stats["batches"] + 1,
          f"K1 launches {launches[0]} != device batches "
          f"{svc.device_batches} (= {stats['batches']} served + 1 warm-up)")
    check(launches[1] == 0, f"serving launched K2 {launches[1]} times")
    log(f"K1 launches during serving: {launches[0]} for "
        f"{svc.device_batches} device batches ({stats['batches']} served + 1 "
        f"warm-up): every generator forward went through the kernel; K2 "
        f"launches {launches[1]}")
    return launches, latency_ms


def _train_boxes(b, seed):
    """Boxes as the training data draws them (the synthetic Multi-MNIST
    set: three objects, 0.2-0.33 wide, inside the canvas)."""
    return synthetic_multimnist(b, seed=seed)["bbox"]


def _grad_boxes(rs, b, o, kind):
    if kind == "wide":                # wider than the canvas, any place
        w = rs.uniform(1.0, 1.6, (b, o))
        h = rs.uniform(1.0, 1.6, (b, o))
        return np.stack([rs.uniform(-0.8, 0.5, (b, o)),
                         rs.uniform(-0.8, 0.5, (b, o)), w, h],
                        -1).astype(np.float32)
    if kind == "off-canvas":          # sticking out on every side
        w = rs.uniform(0.3, 0.6, (b, o))
        h = rs.uniform(0.3, 0.6, (b, o))
        return np.stack([rs.uniform(-0.4, 0.9, (b, o)),
                         rs.uniform(-0.4, 0.9, (b, o)), w, h],
                        -1).astype(np.float32)
    bbox = _train_boxes(b, int(rs.randint(1 << 30)))
    if kind == "padded":              # every other item: all objects padded
        bbox[::2] = -1.0
    return bbox


def _grad_bound(g, bbox, in_hw):
    """Least time of K2 for this run's data: the gradient values some
    object's weights touch, the boxes, and the whole output over the
    memory rate, in the gradient's element size; two flops a tap over the
    float32 rate. Returns (bound_ms, bound_by, dense_ms, read_bytes),
    dense_ms reading every gradient value, read_bytes what the bound
    reads."""
    b, c, ho, wo = g.shape
    o = bbox.shape[1]
    es = g.element_size()
    wy, wx = place_weights(bbox.reshape(b * o, 4), (ho, wo), in_hw)
    ry = (wy != 0).any(dim=2).reshape(b, o, ho)
    rx = (wx != 0).any(dim=2).reshape(b, o, wo)
    need = (ry[:, :, :, None] & rx[:, :, None, :]).any(dim=1)
    out_bytes = b * o * c * in_hw[0] * in_hw[1] * es
    read = int(need.sum()) * c * es + bbox.numel() * 4
    taps = int(((wy != 0).sum(dim=(1, 2)) * (wx != 0).sum(dim=(1, 2))).sum()) * c
    bytes_ms = (read + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * taps / F32_OPS_PER_S * 1e3
    dense_ms = (g.numel() * es + bbox.numel() * 4 + out_bytes) \
        / HBM_BYTES_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), dense_ms, read


def phase_grad_kernel():
    log("phase 6/15 grad: K2 (place backward) against its plain version, "
        "on the card")
    rs = np.random.RandomState(3)
    dev = torch.device(DEVICE)
    cases = [
        ("generator path", (STEP_BATCH, 3, 256, (16, 16), "train")),
        ("discriminator path, 15x15", (STEP_BATCH, 3, 128, (15, 15), "train")),
        ("padded objects", (STEP_BATCH, 3, 256, (16, 16), "padded")),
        ("boxes partly off the canvas",
         (STEP_BATCH, 3, 256, (16, 16), "off-canvas")),
        ("boxes wider than the canvas", (STEP_BATCH, 3, 256, (16, 16), "wide")),
        ("boxes wider than the canvas, 15x15",
         (STEP_BATCH, 3, 128, (15, 15), "wide")),
        ("odd channel count", (STEP_BATCH, 3, 37, (16, 16), "train")),
        ("batch of one", (1, 3, 256, (16, 16), "train")),
    ]
    worst = 0.0
    timed = {}
    for label, (b, o, c, hw, kind) in cases:
        g = torch.from_numpy(rs.uniform(-1.0, 1.0, (b, c, 16, 16)).astype(
            np.float32)).to(dev)
        bbox = torch.from_numpy(_grad_boxes(rs, b, o, kind)).to(dev)
        got = k1.stn_place_multi_grad_nchw(g, bbox, hw)
        want = k1.stn_place_multi_grad_plain(g, bbox, hw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        log(f"  {label}: {tuple(g.shape)} -> {(b, o, c) + hw}: max |kernel "
            f"- plain| = {err:.3e} (atol {KERNEL_ATOL:g}); max |df| "
            f"{float(want.abs().max()):.3f}")
        check(err <= KERNEL_ATOL, f"K2 disagrees with its plain version "
              f"({label}): {err:.3e} > {KERNEL_ATOL:g}")
        check(bool(torch.isfinite(got).all()), f"K2 non-finite ({label})")
        if kind == "padded":
            check(int(torch.count_nonzero(got[::2])) == 0,
                  "padded objects must get exact zeros")
        if kind == "train" and b == STEP_BATCH and c != 37:
            timed["G" if hw == (16, 16) else "D"] = (g, bbox, hw)

    out = {"max_abs_err": worst}
    for path in ("G", "D"):
        g, bbox, hw = timed[path]
        out[path] = time_grad(g, bbox, hw, f"K2 at the {path} shape")
    return out


def time_grad(g, bbox, hw, label):
    """K2 and its plain version timed cold in turns (plain, kernel, kernel,
    plain), each reading a run of 50 calls (:func:`run_ms`) on a rotation
    of gradient copies (:func:`cold_sets`); beside them the same turns on
    one set of buffers (warm, partly in L2, the method of earlier
    readings), K2 a call at a time (:func:`cuda_ms`), the bound for this
    run's boxes and the rate it implies."""
    def kernel(gg=g, bb=bbox):
        return k1.stn_place_multi_grad_nchw(gg, bb, hw)

    def plain(gg=g, bb=bbox):
        return k1.stn_place_multi_grad_plain(gg, bb, hw)

    order = [("plain", plain), ("kernel", kernel), ("kernel", kernel),
             ("plain", plain)]
    bound_ms, bound_by, dense_ms, read = _grad_bound(g, bbox, hw)
    sets = cold_sets((g, bbox), read)
    t = in_turns(order, sets=sets)
    warm = in_turns(order)
    ms, plain_ms = statistics.mean(t["kernel"]), statistics.mean(t["plain"])
    warm_ms = statistics.mean(warm["kernel"])
    dev_ms = graph_ms(kernel, sets)
    call_ms = cuda_ms(kernel)
    gbps = bound_ms / ms * HBM_BYTES_PER_S / 1e9 if bound_by == "bytes" \
        else float("nan")
    out_shape = (g.shape[0], bbox.shape[1], g.shape[1]) + tuple(hw)
    log(f"{label} {tuple(g.shape)} -> {out_shape} {str(g.dtype)[6:]}, cold "
        f"in turns (plain, K2, K2, plain; CUDA events around 50 calls back "
        f"to back each, rotating over {len(sets)} copies of the inputs): K2 "
        f"{t['kernel'][0]:.4f}, {t['kernel'][1]:.4f} ms; plain "
        f"{t['plain'][0]:.4f}, {t['plain'][1]:.4f} ms; warm (one set of "
        f"buffers): K2 {warm['kernel'][0]:.4f}, {warm['kernel'][1]:.4f} ms, "
        f"plain {warm['plain'][0]:.4f}, {warm['plain'][1]:.4f} ms; "
        f"{call_ms:.4f} ms a call timed alone (median of 50); bound "
        f"{bound_ms:.4f} ms ({bound_by}, this run's boxes; {dense_ms:.4f} ms "
        f"if every gradient value were read); {gbps:.0f} GB/s of the bytes "
        f"it needs, {bound_ms / ms:.1%} of the bound cold, "
        f"{bound_ms / warm_ms:.1%} warm; on the device alone (the cold calls "
        f"in a CUDA graph) {dev_ms:.4f} ms, {bound_ms / dev_ms:.1%} of the "
        f"bound")
    return {"ms": ms, "ms_turns": t["kernel"], "plain_ms": plain_ms,
            "plain_ms_turns": t["plain"], "graph_ms": dev_ms,
            "graph_share_of_bound": bound_ms / dev_ms, "warm_ms": warm_ms,
            "warm_ms_turns": warm["kernel"],
            "warm_plain_ms": statistics.mean(warm["plain"]),
            "call_ms": call_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "dense_bound_ms": dense_ms, "share_of_bound": bound_ms / ms,
            "gb_per_s": gbps, "input_sets": len(sets)}


def _f1_gradient(device, z, bbox, labels, weight):
    """Gradient of sum(image * weight) for local1.1.weight of a train-mode
    full-width Stage1G (reference init, seed 0) on ``device``."""
    g = build_stage1_g(MNIST, seed=0, device=device).train()
    img = g(*(t.to(device) for t in (z, bbox, labels)))
    (grad,) = torch.autograd.grad((img * weight.to(device)).sum(),
                                  g.local1[1].weight)
    return grad.cpu()


def phase_autograd():
    log("phase 7/15 autograd: K3 gradients on the card against the CPU")
    rs = np.random.RandomState(4)
    for label, (c, hw) in (("G", (256, (16, 16))), ("D", (128, (15, 15)))):
        feats = torch.from_numpy(rs.randn(STEP_BATCH, 3, c, *hw).astype(
            np.float32))
        bbox = torch.from_numpy(_train_boxes(STEP_BATCH, 11))
        cot = torch.from_numpy(rs.uniform(-1, 1, (STEP_BATCH, c, 16, 16))
                               .astype(np.float32))
        outs, grads = {}, {}
        for dev in ("cpu", DEVICE):
            f = feats.to(dev).requires_grad_(True)
            out = k1.stn_place_multi_nchw(f, bbox.to(dev), (16, 16))
            check(out.grad_fn is not None,
                  f"the place output on {dev} has no grad_fn")
            (grads[dev],) = torch.autograd.grad(out, f, cot.to(dev))
            outs[dev] = out.detach().cpu()
        out_err = float((outs[DEVICE] - outs["cpu"]).abs().max())
        err = float((grads[DEVICE].cpu() - grads["cpu"]).abs().max())
        log(f"  {label} shape {tuple(feats.shape)}: grad_fn "
            f"{type(out.grad_fn).__name__}; max |card - CPU| of the placed "
            f"output = {out_err:.3e}, of the feature gradient = {err:.3e} "
            f"(atol {KERNEL_ATOL:g})")
        check(out_err <= KERNEL_ATOL, f"K3 forward card vs CPU ({label}): "
              f"{out_err:.3e}")
        check(err <= KERNEL_ATOL, f"K3 gradient card vs CPU ({label}): "
              f"{err:.3e}")

    b = 16
    z = torch.from_numpy(rs.randn(b, MNIST.z_dim).astype(np.float32))
    data = synthetic_multimnist(b, seed=12)
    bbox = torch.from_numpy(data["bbox"])
    labels = torch.from_numpy(data["label_onehot"])
    weight = torch.from_numpy(rs.uniform(-1, 1, (b, 1, 64, 64)).astype(
        np.float32))
    on_cpu = _f1_gradient("cpu", z, bbox, labels, weight)
    on_card = _f1_gradient(DEVICE, z, bbox, labels, weight)
    scale = float(on_cpu.abs().max())
    rel = float((on_card - on_cpu).abs().max()) / scale
    cos = float(torch.nn.functional.cosine_similarity(
        on_card.flatten(), on_cpu.flatten(), dim=0))
    log(f"train-mode Stage1G (full width, batch {b}) local1.1.weight "
        f"gradient: max |CPU| {scale:.3e}, max |card - CPU| / max |CPU| = "
        f"{rel:.3e} (limit {GRAD_RTOL:g}), cosine {cos:.6f}")
    check(scale > 0 and float(on_card.abs().max()) > 0,
          "the object pathway got no gradient (F1)")
    check(rel <= GRAD_RTOL, f"object-pathway gradient card vs CPU: {rel:.3e}")


def randomize(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Overwrite ``module``'s weights as tests/test_torch_parity.py's
    ``_randomize`` does (the weights of tests/test_step_parity.py): every
    parameter N(0, 0.05), and BatchNorm statistics and affine terms away
    from their init. Drawn on the CPU, so any device gets the same."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        for m in module.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.copy_(
                    torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(
                    1.0 + 0.2 * torch.rand(m.running_var.shape, generator=g))
                m.weight.copy_(
                    1.0 + 0.05 * torch.randn(m.weight.shape, generator=g))
                m.bias.copy_(0.05 * torch.randn(m.bias.shape, generator=g))
    return module


def step_once(device, data, z, cfg=MNIST, randomized=False):
    """One train step on ``device`` from the reference init (seed 0), or
    from the weights of tests/test_step_parity.py when ``randomized``.
    Returns its losses, the state dicts before and after, the gradients,
    and the step's host time."""
    state = create_state(cfg, seed=0, device=device)
    nets = (("G", state.g), ("D", state.d))
    if randomized:
        randomize(state.g, 3)
        randomize(state.d, 11)
    pre = {n: {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
           for n, m in nets}
    batch = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    t = time.perf_counter()
    metrics = make_train_step(cfg)(state, batch, None, LR, LR,
                                   z=torch.from_numpy(z).to(device))
    metrics = {k: float(v) for k, v in metrics.items()}
    seconds = time.perf_counter() - t
    post = {n: {k: v.detach().cpu() for k, v in m.state_dict().items()}
            for n, m in nets}
    grads = {n: {k: (torch.zeros(p.shape) if p.grad is None
                     else p.grad.detach().cpu())
                 for k, p in m.named_parameters()} for n, m in nets}
    return metrics, pre, post, grads, seconds


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    norm = float(a.norm() * b.norm())
    if norm == 0.0:
        return 1.0 if not (a.any() or b.any()) else 0.0
    return float(a @ b) / norm


def step_disagreements(got, want, loss_atol=LOSS_ATOL, loss_rtol=0.0,
                       stats_atol=STATS_ATOL, min_cosine=MIN_GRAD_COSINE):
    """Where two results of :func:`step_once` from the same weights
    disagree beyond the limits: losses (atol ``loss_atol`` plus
    ``loss_rtol`` of the loss), BatchNorm running statistics (atol
    ``stats_atol``) and the per-tensor gradient cosine (above
    ``min_cosine``); the float32 limits by default. Returns (failures,
    worst): a message per failed check, and the worst reading of each kind,
    the loss as |difference| and as |difference| / |loss|."""
    bad = []
    worst = {"loss": 0.0, "loss_rel": 0.0, "stats": 0.0, "grad_cosine": 1.0}
    for k in sorted(want[0]):
        err = abs(got[0][k] - want[0][k])
        worst["loss"] = max(worst["loss"], err)
        worst["loss_rel"] = max(worst["loss_rel"],
                                err / max(abs(want[0][k]), 1e-12))
        if err > loss_atol + loss_rtol * abs(want[0][k]):
            bad.append(f"loss {k}: {got[0][k]:.6f} vs {want[0][k]:.6f}")
    for net in ("G", "D"):
        for k in want[2][net]:
            if k.endswith(("running_mean", "running_var")):
                err = float((got[2][net][k] - want[2][net][k]).abs().max())
                worst["stats"] = max(worst["stats"], err)
                if err > stats_atol:
                    bad.append(f"{net}:{k} running statistic off by {err:.3e}")
        for k in want[3][net]:
            gcos = _cosine(got[3][net][k], want[3][net][k])
            worst["grad_cosine"] = min(worst["grad_cosine"], gcos)
            if gcos <= min_cosine:
                bad.append(f"{net}:{k} gradient cosine {gcos:.6f}")
    return bad, worst


def delta_readings(got, want):
    """The Adam-delta measures of tests/test_step_parity.py for two results
    of :func:`step_once`, worst tensor of each: delta cosine, mean
    |difference| in lr, share of elements apart by more than 0.5 lr."""
    cos, mean_lr, flip = 1.0, 0.0, 0.0
    for net in ("G", "D"):
        pre = want[1][net]
        for k in want[3][net]:
            dg = got[2][net][k] - pre[k]
            dw = want[2][net][k] - pre[k]
            diff = (dg - dw).abs() / LR
            cos = min(cos, _cosine(dg, dw))
            mean_lr = max(mean_lr, float(diff.mean()))
            flip = max(flip, float((diff > 0.5).float().mean()))
    return cos, mean_lr, flip


def phase_step():
    log(f"phase 8/15 step: one full-width train step, batch {STEP_BATCH}, "
        "card against CPU")
    data = synthetic_multimnist(STEP_BATCH, seed=5)
    z = np.random.RandomState(6).randn(STEP_BATCH, MNIST.z_dim).astype(
        np.float32)
    # A first Adam step is about lr * sign(grad): an element whose gradient
    # is within float32 noise of zero moves a full lr either way, and the
    # G update runs through the D just updated so. At full width the deltas
    # miss tests/test_step_parity.py's limits from either set of weights
    # (see PERF.md); they are printed, and the gradients are held.
    for label, randomized in (("reference init", False),
                              ("tests/test_step_parity.py weights", True)):
        cpu = step_once("cpu", data, z, randomized=randomized)
        card = step_once(DEVICE, data, z, randomized=randomized)
        bad, worst = step_disagreements(card, cpu)
        log(f"  from the {label}: step on the CPU {cpu[4]:.1f} s "
            f"({torch.get_num_threads()} threads), on the card "
            f"{card[4]:.2f} s (host clock, first call)")
        for k in sorted(cpu[0]):
            log(f"    {k}: card {card[0][k]:.6f}, CPU {cpu[0][k]:.6f}")
        log(f"    worst card vs CPU: loss {worst['loss']:.3e} (atol "
            f"{LOSS_ATOL:g}); BatchNorm running stats {worst['stats']:.3e} "
            f"(atol {STATS_ATOL:g}); per-tensor gradient cosine "
            f"{worst['grad_cosine']:.8f} (limit {MIN_GRAD_COSINE:g})")
        cos, mean_lr, flip = delta_readings(card, cpu)
        log(f"    Adam deltas, worst tensor (read, not held): cosine "
            f"{cos:.8f}, mean |difference| {mean_lr:.5f} lr, {flip:.4%} of "
            "the elements apart by more than 0.5 lr")
        for msg in bad:
            log(f"    FAILED {msg}")
        check(not bad, f"train step card vs CPU from the {label}: "
              f"{len(bad)} checks failed")


def phase_step_time(cfg=MNIST, phase="9/15 steptime", runs: int = 20):
    kind = "bf16" if cfg.compute_dtype == torch.bfloat16 else (
        "float32 with TF32 off (matmul and cuDNN)")
    log(f"phase {phase}: the train step at batch {STEP_BATCH} on the card, "
        f"{kind}")
    dev = torch.device(DEVICE)
    state = create_state(cfg, seed=0, device=dev)
    data = {k: torch.from_numpy(v).to(dev)
            for k, v in synthetic_multimnist(STEP_BATCH, seed=8).items()}
    step = make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(3):
        step(state, data, gen, LR, LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.reset_launch_count()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(state, data, gen, LR, LR)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    per_step = (k1.launch_count() / runs, k1.grad_launch_count() / runs)
    ms = statistics.median(times)
    check(all(bool(torch.isfinite(v)) for v in metrics.values()),
          "non-finite losses while timing")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"train step at batch {STEP_BATCH}, full width, {kind}: {ms:.2f} ms "
        f"(CUDA events, median of {runs}; min {min(times):.2f}, max "
        f"{max(times):.2f}) = {STEP_BATCH * 1e3 / ms:.0f} images/s; peak "
        f"memory {peak:.2f} GiB; launches per step: K1 {per_step[0]:g}, K2 "
        f"{per_step[1]:g}")
    check(per_step == (4, 4), f"K1/K2 launches per step {per_step} != (4, 4)")
    return {"ms": ms, "images_per_s": STEP_BATCH * 1e3 / ms,
            "peak_gib": peak, "launches_per_step": per_step}


def train_entry(flags=()):
    """cli/main.py for one synthetic epoch on the card with ``flags``;
    returns its K1, K2 and K4 launches, held at 16, 16 (4 steps) and 0."""
    cfg = os.path.join(ROOT, "cfg", "mnist_train.yml")
    k1.reset_launch_count()
    k4.reset_launch_count()
    hist = train_main.main(["--variant", "multi-mnist", "--cfg", cfg,
                            "--synthetic", "--max_epochs", "1",
                            "--manualSeed", "7", "--device", DEVICE,
                            *flags])
    torch.cuda.synchronize()
    launches = (k1.launch_count(), k1.grad_launch_count(), k4.launch_count())
    check(len(hist) == 1 and hist[0]["steps"] == 4,
          f"one epoch of 4 steps expected, got {hist}")
    losses = {k: v for k, v in hist[0].items()
              if k not in ("steps", "seconds")}
    check(all(np.isfinite(v) for v in losses.values()),
          f"non-finite losses {losses}")
    log(f"train entry {' '.join(flags) or '(float32)'}: {hist[0]['steps']} "
        f"steps in {hist[0]['seconds']:.2f} s (host clock, first epoch, cuDNN "
        f"set-up included); K1 launches {launches[0]}, K2 launches "
        f"{launches[1]}, K4 launches {launches[2]}; mean losses "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items())))
    check(launches == (16, 16, 0),
          f"K1/K2/K4 launches {launches} != (16, 16, 0) for 4 steps")
    return launches


def phase_train_entry():
    log("phase 10/15 train: cli/main.py, one synthetic epoch on the card")
    return train_entry()


def _ulp_bf16(t: torch.Tensor) -> float:
    """One bf16 ulp at the largest |value| of ``t``."""
    m = float(t.float().abs().max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


# K4 at shapes that stress its tiling (name, B, H, W, Cin, Cout): M not a
# multiple of the 128-row tile, Cout not a multiple of the N tile, the
# smallest Cin the wrapper takes (one masked tail slice), Cin not a multiple
# of 64 with Cout below 128, and the largest Cin with two N tiles. Each has
# M of 450 or more: the plain chain sums its bf16 y, whose rounding errors
# cancel less over a few dozen pixels (a 32-pixel case read 1.3e-3 of the
# largest sum of squares against the f32 sums)
K4_EDGE_SHAPES = [("M = 455, not a multiple of 128", 13, 7, 5, 64, 64),
                  ("Cout 136, not a multiple of 256", 8, 16, 16, 128, 136),
                  ("Cin 8, the smallest", 16, 5, 6, 8, 8),
                  ("Cin 72 -> Cout 24", 16, 6, 6, 72, 24),
                  ("Cin 1024, the largest, Cout 264", 8, 8, 8, 1024, 264)]
# gamma 0 and beta 0.5 in channel 0: normalized 0.5 in the image, and the
# zero padding of the normalized tensor on the border (not relu(beta))
K4_ZERO_GAMMA_SHAPE = ("gamma 0, beta 0.5 in channel 0", 16, 6, 6, 64, 64)


def k4_inputs(shape, seed, device, zero_gamma=False):
    """The spike tool's inputs at ``shape``; with ``zero_gamma`` channel 0
    folds to scale 0, shift 0.5."""
    x, scale, shift, w = spike_normconv.make_inputs(shape, seed, device)
    if zero_gamma:
        scale[0], shift[0] = 0.0, 0.5
    return x, scale, shift, w


def check_k4(name, shape, args):
    """K4 against its plain version on ``args``, and again for the same
    sums; returns max |dy|."""
    got = k4.normconv(*args)
    want = k4.normconv_plain(*args)
    again = k4.normconv(*args)
    torch.cuda.synchronize()
    dy, scale, rs, rq = spike_normconv.disagreement(got, want)
    ulp = _ulp_bf16(want[0])
    same = bool(torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
                and torch.equal(got[0], again[0]))
    log(f"  {name} {tuple(shape)}: max |y - plain| = {dy:.4g} ({dy / ulp:g}"
        f" bf16 ulp of max |y| {scale:.4g}; limit {BF16_ULPS}); sums "
        f"{rs:.2e}, squares {rq:.2e} of their max (limit {K4_SUM_RTOL:g}); "
        f"a second run bit-identical: {same}")
    check(bool(torch.isfinite(got[0].float()).all()), f"K4 non-finite "
          f"({name})")
    check(dy <= BF16_ULPS * ulp, f"K4 y disagrees at {name}")
    check(rs <= K4_SUM_RTOL and rq <= K4_SUM_RTOL,
          f"K4 sums disagree at {name}")
    check(same, f"K4 gave another result on a second run at {name}")
    return dy


def time_k4(name, shape, args):
    """K4, its plain chain and cuDNN's bf16 ``F.conv2d`` (NCHW, the
    yardstick; the port never calls it) in turns: plain, K4, cuDNN, cuDNN,
    K4, plain, each reading a run of 50 calls (:func:`run_ms`)."""
    x, scale, shift, w = args
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    w_oihw = w.permute(3, 2, 0, 1).contiguous()

    def kernel():
        return k4.normconv(x, scale, shift, w)

    def plain():
        return k4.normconv_plain(x, scale, shift, w)

    def conv():
        return torch.nn.functional.conv2d(x_nchw, w_oihw, padding=1)

    t = in_turns([("plain", plain), ("kernel", kernel), ("library", conv),
                  ("library", conv), ("kernel", kernel), ("plain", plain)])
    ms, plain_ms, lib_ms = (statistics.mean(t[k])
                            for k in ("kernel", "plain", "library"))
    bound_ms, bound_by, flops, _ = spike_normconv.bound(shape)
    log(f"  {name} {tuple(shape)} in turns (plain, K4, cuDNN, cuDNN, K4, "
        f"plain; CUDA events around 50 calls back to back each): "
        f"K4 {t['kernel'][0]:.4f}, {t['kernel'][1]:.4f} ms = "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of the "
        f"{bound_ms:.4f} ms {bound_by} bound; plain chain {t['plain'][0]:.4f}"
        f", {t['plain'][1]:.4f} ms; cuDNN bf16 F.conv2d {t['library'][0]:.4f}"
        f", {t['library'][1]:.4f} ms; K4 takes {ms / lib_ms:.2f}x cuDNN's "
        f"time and {ms / plain_ms:.2f}x the plain chain's")
    return {"shape": name, "dims": list(shape), "ms": ms,
            "ms_turns": t["kernel"], "plain_ms": plain_ms,
            "plain_ms_turns": t["plain"], "library_ms": lib_ms,
            "library_ms_turns": t["library"], "bound_ms": bound_ms,
            "bound_by": bound_by, "tflops": flops / ms / 1e9,
            "share_of_bound": bound_ms / ms}


def phase_normconv():
    log("phase 11/15 normconv: K4's path (the port's spike tool), and K4 "
        "against its plain version, on the card")
    dev = torch.device(DEVICE)
    k4.reset_launch_count()
    spike_normconv.run(dev)
    torch.cuda.synchronize()
    tool_launches = k4.launch_count()
    want = len(spike_normconv.CHECK_SHAPES) + len(spike_normconv.HOT_SHAPES) \
        * (spike_normconv.WARMUP + spike_normconv.RUNS)
    check(tool_launches == want, f"the spike tool launched K4 "
          f"{tool_launches} times, {want} expected")
    log(f"tools/spike_normconv.py (check, then bench): K4 launches "
        f"{tool_launches} = {len(spike_normconv.CHECK_SHAPES)} checks + "
        f"{len(spike_normconv.HOT_SHAPES)} hot shapes x "
        f"({spike_normconv.WARMUP} warm-up + {spike_normconv.RUNS} timed)")
    worst = 0.0
    shapes = spike_normconv.CHECK_SHAPES + spike_normconv.HOT_SHAPES \
        + K4_EDGE_SHAPES
    for i, (name, *shape) in enumerate(shapes):
        args = k4_inputs(shape, 100 + i, dev)
        worst = max(worst, check_k4(name, shape, args))
    name, *shape = K4_ZERO_GAMMA_SHAPE
    args = k4_inputs(shape, 99, dev, zero_gamma=True)
    worst = max(worst, check_k4(name, shape, args))
    rows = [time_k4(name, shape, k4_inputs(shape, 1, dev))
            for name, *shape in spike_normconv.HOT_SHAPES]
    return {"max_abs_err": worst, "launches": tool_launches, "rows": rows}


def _boxes(rs, b, o, kind):
    return _service_boxes(rs, b, o) if kind == "service" else _grad_boxes(
        rs, b, o, kind)


def phase_bf16_kernels():
    log("phase 12/15 bf16: K1 and K2 in bf16 against their plain versions, "
        "on the card")
    rs = np.random.RandomState(13)
    dev = torch.device(DEVICE)
    cases = [  # (label, timed as, B, C, input side, boxes, output side)
        ("serve", "serve", 64, 256, 16, "service", 16),
        ("train G", "train G", STEP_BATCH, 256, 16, "train", 16),
        ("train D, 15x15", "train D", STEP_BATCH, 128, 15, "train", 16),
        ("padded objects", None, STEP_BATCH, 256, 16, "padded", 16),
        ("boxes partly off the canvas", None, STEP_BATCH, 256, 16,
         "off-canvas", 16),
        ("boxes wider than the canvas", None, STEP_BATCH, 256, 16, "wide", 16),
        ("boxes wider than the canvas, 15x15", None, STEP_BATCH, 128, 15,
         "wide", 16),
        ("37 channels, a tile of 16 and one of 5", None, 64, 37, 16, "train",
         16),
    ] + [(label, None, b, c, hw[0], kind, side)
         for label, (b, _, c, hw, kind), side in K1_TILE_EDGES]
    out = {"place": {"max_abs_err": 0.0}, "grad": {"max_abs_err": 0.0}}
    for label, timed, b, c, side, kind, out_side in cases:
        hw = (side, side)
        bbox = torch.from_numpy(_boxes(rs, b, 3, kind)).to(dev)
        feats = torch.from_numpy(rs.randn(b, 3, c, side, side).astype(
            np.float32)).to(dev).bfloat16()
        g = torch.from_numpy(rs.uniform(-1, 1, (b, c, out_side, out_side))
                             .astype(np.float32)).to(dev).bfloat16()
        for kernel, run, plain, arg, hw_arg in (
                ("place", k1.stn_place_multi_nchw, k1.stn_place_multi_plain,
                 feats, (out_side, out_side)),
                ("grad", k1.stn_place_multi_grad_nchw,
                 k1.stn_place_multi_grad_plain, g, hw)):
            got = run(arg, bbox, hw_arg)
            want = plain(arg, bbox, hw_arg)
            torch.cuda.synchronize()
            check(got.dtype == torch.bfloat16, f"{kernel} returned {got.dtype}")
            err = float((got.float() - want.float()).abs().max())
            ulp = _ulp_bf16(want)
            out[kernel]["max_abs_err"] = max(out[kernel]["max_abs_err"], err)
            name = "K1" if kernel == "place" else "K2"
            log(f"  {name} {label}: {tuple(arg.shape)}: max |kernel - plain| "
                f"= {err:.3e} ({err / ulp:g} bf16 ulp of the largest |value|;"
                f" limit {BF16_ULPS})")
            check(err <= BF16_ULPS * ulp,
                  f"{name} bf16 disagrees with its plain version ({label})")
            check(bool(torch.isfinite(got.float()).all()),
                  f"{name} bf16 non-finite ({label})")
            if kind == "padded":
                check(int(torch.count_nonzero(got[::2])) == 0,
                      f"{name} bf16: padded items must give exact zeros")
            if timed is None or (kernel == "grad" and timed == "serve"):
                continue
            if kernel == "grad":
                out[kernel][timed] = time_grad(arg, bbox, hw,
                                               f"K2 bf16 at the {timed} shape")
                continue
            out[kernel][timed] = time_place(arg, bbox,
                                            f"K1 bf16 at the {timed} shape")
    check_side_limit(dev, torch.bfloat16)
    return out


def phase_step_bf16():
    log(f"phase 13/15 step16: one full-width bf16 train step, batch "
        f"{STEP16_BATCH}, card against CPU")
    data = synthetic_multimnist(STEP16_BATCH, seed=5)
    z = np.random.RandomState(6).randn(STEP16_BATCH, BF16.z_dim).astype(
        np.float32)
    cpu = step_once("cpu", data, z, BF16, randomized=True)
    card = step_once(DEVICE, data, z, BF16, randomized=True)
    bad, worst = step_disagreements(
        card, cpu, loss_atol=0.0, loss_rtol=BF16_LOSS_RTOL,
        stats_atol=BF16_STATS_ATOL, min_cosine=BF16_MIN_GRAD_COSINE)
    log(f"  from the tests/test_step_parity.py weights: bf16 step on the CPU "
        f"{cpu[4]:.1f} s ({torch.get_num_threads()} threads), on the card "
        f"{card[4]:.2f} s (host clock, first call)")
    for k in sorted(cpu[0]):
        log(f"    {k}: card {card[0][k]:.6f}, CPU {cpu[0][k]:.6f}")
    log(f"    worst card vs CPU: loss {worst['loss_rel']:.3e} relative "
        f"(limit {BF16_LOSS_RTOL:g}); BatchNorm running stats "
        f"{worst['stats']:.3e} (atol {BF16_STATS_ATOL:g}); per-tensor "
        f"gradient cosine {worst['grad_cosine']:.8f} (limit "
        f"{BF16_MIN_GRAD_COSINE:g})")
    cosines = sorted((_cosine(card[3][n][k], cpu[3][n][k]), f"{n}:{k}")
                     for n in ("G", "D") for k in cpu[3][n])
    log("    lowest per-tensor gradient cosines: " + ", ".join(
        f"{k} {c:.6f}" for c, k in cosines[:4]))
    for msg in bad:
        log(f"    FAILED {msg}")
    check(not bad, f"bf16 train step card vs CPU: {len(bad)} checks failed")
    return worst


def _served_images(port, items):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/generate", body=json.dumps({"items": items}))
        resp = conn.getresponse()
        status, body = resp.status, json.loads(resp.read())
    finally:
        conn.close()
    check(status == 200 and len(body["images"]) == len(items),
          f"bf16 request: {status}")
    return [_png_gray64(b) for b in body["images"]]


def phase_entry_bf16():
    log("phase 15/15 entry16: cli/main.py --bf16 and --bn_groups 2, and a "
        "64-item request served with --bf16")
    launches = {"train_bf16": train_entry(["--bf16"]),
                "train_bn_groups_2": train_entry(["--bn_groups", "2"])}
    rs = np.random.RandomState(2)
    items, boxes = [], []
    for _ in range(64):
        n = int(rs.randint(1, 4))
        w, h = rs.uniform(0.25, 0.4, n), rs.uniform(0.25, 0.4, n)
        bb = np.stack([rs.uniform(0, 1 - w), rs.uniform(0, 1 - h), w, h],
                      -1).round(4).tolist()
        items.append({"labels": rs.randint(0, 10, n).tolist(), "bboxes": bb})
        boxes.append(bb)
    k1.reset_launch_count()
    args = argparse.Namespace(variant="multi-mnist", cfg="", net_g=CKPT,
                              seed=0, device=DEVICE, bf16=True,
                              host="127.0.0.1", port=0, max_wait_ms=5.0)
    httpd = serve(args, build_service(args))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        t = time.perf_counter()
        imgs16 = _served_images(httpd.server_address[1], items)
        latency_ms = (time.perf_counter() - t) * 1e3
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.close()
        thread.join(timeout=30)
    svc16 = httpd.service
    serve_launches = (k1.launch_count(), k1.grad_launch_count())
    check(svc16.mcfg.compute_dtype == torch.bfloat16, "served in bf16")
    check(serve_launches[0] == svc16.device_batches == 2,
          f"the bf16 request took {svc16.device_batches - 1} device batches "
          f"and {serve_launches[0]} K1 launches, warm-up included; one each "
          "expected")
    check(serve_launches[1] == 0,
          f"bf16 serving launched K2 {serve_launches[1]} times")
    # the float32 service draws the same z: one warm-up batch, then this one
    svc32 = Stage1Service(MNIST, CKPT, seed=0, device=DEVICE)
    imgs32 = [_png_gray64(b) for b in svc32.run(items)]
    diff = np.abs(np.stack(imgs16).astype(np.float32)
                  - np.stack(imgs32).astype(np.float32)) / 127.5
    sep = [_separation(u8, bb) for u8, bb in zip(imgs16, boxes)]
    log(f"64-item request with --bf16: {latency_ms:.1f} ms over HTTP (host "
        f"clock); against the float32 image of the card: mean |diff| "
        f"{diff.mean():.4f}, max {diff.max():.4f} in [-1, 1] units (limit "
        f"mean {MAX_BF16_SERVE_MEAN_DIFF:g}); separation mean "
        f"{np.mean(sep):.3f} (need > {MIN_BF16_SEPARATION}); K1 launches "
        f"{serve_launches[0]} for {svc16.device_batches} device batches, K2 "
        f"launches {serve_launches[1]}")
    check(float(diff.mean()) <= MAX_BF16_SERVE_MEAN_DIFF,
          "bf16 served images stray from the float32 ones")
    check(float(np.mean(sep)) > MIN_BF16_SEPARATION,
          "bf16 served images do not place content in the requested boxes")
    launches["serve_bf16"] = serve_launches
    return launches, float(diff.mean())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    name = phase_device()
    phase_build()
    place = phase_kernel()
    phase_model()
    serve_launches, _ = phase_serve()
    grad = phase_grad_kernel()
    phase_autograd()
    phase_step()
    step32 = phase_step_time()
    train_launches = phase_train_entry()
    normconv = phase_normconv()
    bf16 = phase_bf16_kernels()
    phase_step_bf16()
    step16 = phase_step_time(BF16, "14/15 time16")
    log(f"bf16 step {step16['ms']:.2f} ms ({step16['images_per_s']:.0f} "
        f"images/s, peak {step16['peak_gib']:.2f} GiB) beside float32 "
        f"{step32['ms']:.2f} ms ({step32['images_per_s']:.0f} images/s, peak "
        f"{step32['peak_gib']:.2f} GiB): {step32['ms'] / step16['ms']:.2f}x")
    entry16, _ = phase_entry_bf16()
    log("all phases passed")
    by_path = {"serve": serve_launches, "train": train_launches, **entry16}
    f32_paths, bf16_paths = ("serve", "train", "train_bn_groups_2"), (
        "serve_bf16", "train_bf16")

    def launches(i):
        return {"launches": sum(v[i] for v in by_path.values()),
                "launches_f32": sum(by_path[p][i] for p in f32_paths),
                "launches_bf16": sum(by_path[p][i] for p in bf16_paths),
                "launches_by_path": {p: v[i] for p, v in by_path.items()}}

    cuda = {"route": "cuda",
            "source": "multiple_objects_gan_tpu_torch/csrc/stn_place.cu",
            "library_ms": None}
    hot = normconv["rows"][0]
    k4_paths = {"spike_tool": normconv["launches"],
                **{p: v[2] for p, v in by_path.items() if len(v) > 2}}
    print(json.dumps({"kernels": [{
        "name": "stn_place_multi", **cuda,
        "replaces": "multiple_objects_gan_tpu/ops/stn_pallas.py:79",
        "redesigned": "PR 9",
        **launches(0),
        "max_abs_err": place["max_abs_err"],
        **place["serve"],
        "train_g_shape": place["train G"],
        "train_d_shape": place["train D"],
        "bf16": bf16["place"],
    }, {
        "name": "stn_place_multi_grad", **cuda,
        "replaces": "multiple_objects_gan_tpu/ops/stn_pallas.py:137",
        "redesigned": "PR 8",
        **launches(1),
        "max_abs_err": grad["max_abs_err"],
        **grad["G"],
        "d_shape": grad["D"],
        "bf16": bf16["grad"],
    }, {
        "name": "normconv_bf16", "route": "cuda",
        "source": "multiple_objects_gan_tpu_torch/csrc/normconv.cu",
        "replaces": "tools/spike_normconv.py:90",
        "redesigned": "PR 8",
        "launches": sum(k4_paths.values()),
        "launches_by_path": k4_paths,
        "max_abs_err": normconv["max_abs_err"],
        "shape": hot["dims"], "ms": hot["ms"], "plain_ms": hot["plain_ms"],
        "bound_ms": hot["bound_ms"], "bound_by": hot["bound_by"],
        "library_ms": hot["library_ms"],
        "shapes": normconv["rows"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
