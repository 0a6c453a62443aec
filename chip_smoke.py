#!/usr/bin/env python3
"""Drive the PyTorch port (multiple_objects_gan_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root, on a machine with a CUDA card, nvcc and the
checkpoint runs_r5/mnist_repin/netG_final.pth. Phases, each logged with the
elapsed time:

  1. device  - the card's name and power limit, torch and CUDA versions;
  2. build   - nvcc builds csrc/stn_place.cu for sm_90a (ptxas report);
  3. kernel  - the STN place kernel (K1) against its plain PyTorch version
               on the card, at the generator's shape and at edge cases,
               timed by CUDA events beside the plain version and the bound;
  4. model   - the full-width trained Stage1G on the card against the port
               on the CPU, batch 64, and its forward time on the card;
  5. serve   - the port's HTTP server on the card: concurrent /generate
               requests, a 64-item request, /stats, and the proof that the
               served batches went through K1 (its launch count).

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Any failed check raises, and the script
exits non-zero; without a card it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import base64
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

from multiple_objects_gan_tpu_torch.cli.serve import (
    Stage1Service, _item_layout, _png_b64, serve)
from multiple_objects_gan_tpu_torch.io.weights import load_reference_g
from multiple_objects_gan_tpu_torch.models.common import MNIST
from multiple_objects_gan_tpu_torch.models.stage1 import build_stage1_g
from multiple_objects_gan_tpu_torch.ops import _build
from multiple_objects_gan_tpu_torch.ops import stn_place_cuda as k1
from multiple_objects_gan_tpu_torch.ops.stn import place_weights

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "runs_r5", "mnist_repin", "netG_final.pth")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
KERNEL_ATOL = 1e-5
MODEL_ATOL = 5e-4
MIN_SEPARATION = 0.5
DEVICE = "cuda"


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


# ------------------------------------------------------------------ phases


def phase_device():
    log("phase 1/5 device")
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
    log("phase 2/5 build")
    built = _build.build("stn_place")
    for line in built.log.splitlines():
        if line.strip():
            print(f"  {line}", flush=True)
    log(f"build: {os.path.relpath(built.path, ROOT)} ready in "
        f"{built.seconds:.2f}s")


def _service_boxes(rs, b, o):
    """Layouts as the service draws them for items without one."""
    pairs = [_item_layout({}, o, 10, rs) for _ in range(b)]
    return np.stack([p[1] for p in pairs])


def _bound(features, bbox, out_hw):
    """Least time for this run's data: the input values with a non-zero
    weight, the boxes and the output, over the memory rate; two flops a
    tap over the float32 rate. Returns (bound_ms, bound_by, dense_ms)."""
    b, o, c, hi, wi = features.shape
    wy, wx = place_weights(bbox.reshape(b * o, 4), out_hw, (hi, wi))
    rows = (wy != 0).any(dim=1).sum(dim=1)
    cols = (wx != 0).any(dim=1).sum(dim=1)
    read = int((rows * cols).sum()) * c * 4 + bbox.numel() * 4
    out_bytes = b * c * out_hw[0] * out_hw[1] * 4
    taps = int(((wy != 0).sum(2)[:, :, None]
                * (wx != 0).sum(2)[:, None, :]).sum()) * c
    bytes_ms = (read + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * taps / F32_OPS_PER_S * 1e3
    dense_ms = (features.numel() * 4 + bbox.numel() * 4 + out_bytes) \
        / HBM_BYTES_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), dense_ms


def phase_kernel():
    log("phase 3/5 kernel against its plain version, on the card")
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
        return (torch.from_numpy(feats).to(dev),
                torch.from_numpy(bbox).to(dev))

    cases = [
        ("generator path", (64, 3, 256, (16, 16), "service")),
        ("padded objects", (64, 3, 256, (16, 16), "padded")),
        ("boxes partly off the canvas", (64, 3, 256, (16, 16), "off-canvas")),
        ("odd channel count", (64, 3, 37, (16, 16), "service")),
        ("batch of one", (1, 3, 256, (16, 16), "service")),
        ("15x15 maps onto the 16x16 canvas", (64, 3, 128, (15, 15), "service")),
    ]
    worst = 0.0
    timed = None
    for label, (b, o, c, hw, kind) in cases:
        feats, bbox = case(b, o, c, hw, kind)
        got = k1.stn_place_multi_nchw(feats, bbox, (16, 16))
        want = k1.stn_place_multi_plain(feats, bbox, (16, 16))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        log(f"  {label}: {tuple(feats.shape)} -> (16, 16): max |kernel - "
            f"plain| = {err:.3e} (atol {KERNEL_ATOL:g})")
        check(err <= KERNEL_ATOL, f"K1 disagrees with its plain version "
              f"({label}): {err:.3e} > {KERNEL_ATOL:g}")
        if kind == "padded":
            check(int(torch.count_nonzero(got[::2])) == 0,
                  "padded items must place exact zeros")
        if timed is None:
            timed = (feats, bbox)

    feats, bbox = timed
    ms = cuda_ms(lambda: k1.stn_place_multi_nchw(feats, bbox, (16, 16)))
    plain_ms = cuda_ms(lambda: k1.stn_place_multi_plain(feats, bbox, (16, 16)))
    bound_ms, bound_by, dense_ms = _bound(feats, bbox, (16, 16))
    log(f"K1 at {tuple(feats.shape)} -> (16, 16), CUDA events, median of "
        f"50: {ms:.4f} ms; plain version {plain_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms ({bound_by}, this run's boxes; {dense_ms:.4f} ms "
        f"if every input value were read); {bound_ms / ms:.1%} of the bound")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "dense_bound_ms": dense_ms}


def phase_model():
    log("phase 4/5 model: full-width trained Stage1G, card against CPU")
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
    log("phase 5/5 serve: the port's main path over HTTP, on the card")
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
    launches = k1.launch_count()
    check(stats["device"].startswith(DEVICE), "served on the card")
    check(launches == svc.device_batches == stats["batches"] + 1,
          f"K1 launches {launches} != device batches {svc.device_batches} "
          f"(= {stats['batches']} served + 1 warm-up)")
    log(f"K1 launches during serving: {launches} for {svc.device_batches} "
        f"device batches ({stats['batches']} served + 1 warm-up): every "
        "generator forward went through the kernel")
    return launches, latency_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    name = phase_device()
    phase_build()
    k1 = phase_kernel()
    phase_model()
    launches, _ = phase_serve()
    log("all phases passed")
    print(json.dumps({"kernels": [{
        "name": "stn_place_multi_f32",
        "route": "cuda",
        "source": "multiple_objects_gan_tpu_torch/csrc/stn_place.cu",
        "replaces": "multiple_objects_gan_tpu/ops/stn_pallas.py:79",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "dense_bound_ms": k1["dense_bound_ms"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
