"""Serving endpoint of the port: layout -> image over HTTP, on the card.

The PyTorch counterpart of the JAX package's ``cli/serve.py`` for the
Multi-MNIST Stage-1 generator: a micro-batcher coalesces concurrent
requests into device batches of a fixed size (``MAX_BATCH``), each batch is
one eval-mode ``Stage1G`` forward, whose object pathway places its objects
with the CUDA kernel of ``ops/stn_place_cuda.py``.

HTTP API (stdlib http.server, threaded):
  POST /generate  {"items": [{"labels": [3], "bboxes": [[x, y, w, h]]}]}
                  -> {"images": [base64 png, ...]}
  GET  /healthz   -> {"ok": true, ...}
  GET  /stats     -> batcher counters, device batches and K1 launches

Usage:
  python -m multiple_objects_gan_tpu_torch.cli.serve --variant multi-mnist \
      --net_g runs_r5/mnist_repin/netG_final.pth --device cuda \
      [--cfg cfg/mnist_eval.yml] [--port 8000] [--max_wait_ms 5] [--bf16]
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional

import numpy as np
import torch

from multiple_objects_gan_tpu_torch import resolve_device
from multiple_objects_gan_tpu_torch.io.weights import load_reference_g
from multiple_objects_gan_tpu_torch.models.common import MNIST, Stage1Config
from multiple_objects_gan_tpu_torch.models.stage1 import build_stage1_g
from multiple_objects_gan_tpu_torch.ops import stn_place_cuda
from multiple_objects_gan_tpu_torch.train.step import make_sample_fn
from multiple_objects_gan_tpu_torch.utils.images import png_bytes, to_uint8

MAX_BATCH = 64


# ---------------------------------------------------------------------------
# micro-batcher


class _Pending:
    __slots__ = ("item", "event", "result", "error")

    def __init__(self, item):
        self.item = item
        self.event = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None


class MicroBatcher:
    """Coalesce concurrent single-item requests into device batches.

    ``run_batch(items) -> results`` is called on a dedicated worker
    thread with 1..max_batch items: the first queued item starts a
    batch, which then waits up to ``max_wait_ms`` for more before
    launching. Results (or the exception) fan back to the callers.
    """

    def __init__(self, run_batch: Callable[[list], list], max_batch: int,
                 max_wait_ms: float = 5.0):
        self._run_batch = run_batch
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "items": 0,
                      "batch_ms_total": 0.0}
        self._lock = threading.Lock()
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, item) -> Any:
        """Block until the batch containing ``item`` completes."""
        return self.submit_many([item])[0]

    def submit_many(self, items: list) -> list:
        """Enqueue all items at once (so one request's items share device
        batches) and block until every result is in."""
        pending = [_Pending(it) for it in items]
        with self._lock:
            self.stats["requests"] += len(pending)
        for p in pending:
            self._q.put(p)
        for p in pending:
            p.event.wait()
        for p in pending:
            if p.error is not None:
                raise p.error
        return [p.result for p in pending]

    def close(self):
        self._stop = True
        self._q.put(None)  # wake the worker
        self._thread.join(timeout=5)

    def _collect(self) -> list:
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _worker(self):
        while not self._stop:
            batch = self._collect()
            if not batch:
                continue
            t0 = time.monotonic()
            try:
                results = self._run_batch([p.item for p in batch])
                for p, r in zip(batch, results):
                    p.result = r
            except Exception as e:  # fan the failure out to all callers
                for p in batch:
                    p.error = e
            dt = (time.monotonic() - t0) * 1e3
            with self._lock:
                self.stats["batches"] += 1
                self.stats["items"] += len(batch)
                self.stats["batch_ms_total"] += dt
            for p in batch:
                p.event.set()

    def snapshot(self) -> dict:
        with self._lock:
            s = dict(self.stats)
        b = max(s["batches"], 1)
        s["avg_batch_fill"] = round(s["items"] / b, 2)
        s["avg_batch_ms"] = round(s["batch_ms_total"] / b, 2)
        s.pop("batch_ms_total")
        s["max_batch"] = self.max_batch
        return s


# ---------------------------------------------------------------------------
# model service


def _png_b64(img: np.ndarray) -> str:
    """[-1, 1] float image (H, W, C) -> base64 PNG."""
    return base64.b64encode(png_bytes(to_uint8(img))).decode("ascii")


def _item_layout(item: dict, max_objects: int, label_dim: int,
                 rs: np.random.RandomState):
    """(labels one-hot (O, L), bbox (O, 4)) from a request item; missing
    layout -> random; missing objects padded with bbox=-1 like the
    reference datasets."""
    labels = np.zeros((max_objects, label_dim), np.float32)
    bbox = np.full((max_objects, 4), -1.0, np.float32)
    ids = item.get("labels")
    boxes = item.get("bboxes")
    if ids is None and boxes is None:
        n = rs.randint(1, max_objects + 1)
        ids = rs.randint(0, label_dim, n).tolist()
        w = rs.uniform(0.2, 0.4, n)
        h = rs.uniform(0.2, 0.4, n)
        boxes = np.stack([rs.uniform(0, 1 - w), rs.uniform(0, 1 - h), w, h],
                         axis=-1).tolist()
    ids = list(ids or [])
    boxes = list(boxes or [])
    if len(ids) != len(boxes):
        raise ValueError("labels and bboxes must have the same length")
    if len(ids) > max_objects:
        raise ValueError(f"at most {max_objects} objects supported")
    for o, (lab, bb) in enumerate(zip(ids, boxes)):
        row = np.asarray(lab, np.float32).reshape(-1)
        if row.size == 1:  # class id -> one-hot
            if not (np.isfinite(row[0]) and 0 <= row[0] < label_dim):
                raise ValueError(f"label id {lab!r} is outside "
                                 f"[0, {label_dim})")
            labels[o, int(row[0])] = 1.0
        elif row.size == label_dim:
            labels[o] = row
        else:
            raise ValueError(f"label must be an id or a {label_dim}-d "
                             "one-hot")
        box = np.asarray(bb, np.float32).reshape(-1)
        if box.size != 4:
            raise ValueError(f"bbox must be [x, y, w, h], got {bb!r}")
        # a padded object (all -1) places nothing; any other box needs
        # finite values and a positive size, or the place divides by zero
        if not (box == -1.0).all() and not (
                np.isfinite(box).all() and box[2] > 0 and box[3] > 0):
            raise ValueError(f"bbox {bb!r} needs finite values and w, h > 0")
        bbox[o] = box
    return labels, bbox


class Stage1Service:
    """Multi-MNIST generation at ``MAX_BATCH`` on one device.

    ``net_g`` is a reference-format ``.pth``; without one the generator
    gets the reference's random init from ``seed``. The generator computes
    in ``mcfg.compute_dtype`` (bf16 with ``--bf16``); the images come back
    float32 either way. z comes from a ``torch.Generator`` seeded with
    ``seed``. The constructor runs one
    warm-up batch, so the first request pays neither the kernel build nor
    cuDNN's first-call set-up.
    """

    def __init__(self, mcfg: Stage1Config = MNIST, net_g: str = "",
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.mcfg = mcfg
        self.max_batch = MAX_BATCH
        state_dict = load_reference_g(net_g) if net_g else None
        self.weights = net_g or f"random init, seed {seed}"
        self.g = build_stage1_g(mcfg, state_dict, seed=seed,
                                device=self.device)
        self._sample = make_sample_fn(mcfg)
        self._rs = np.random.RandomState(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.device_batches = 0
        self.run([{}])

    def validate(self, item: dict) -> None:
        """Raise ValueError for a malformed request item. Runs in the HTTP
        thread BEFORE the micro-batcher, so one client's bad item cannot
        fail the other requests coalesced into the same device batch."""
        _item_layout(item, self.mcfg.num_objects, self.mcfg.label_dim,
                     np.random.RandomState(0))

    def run(self, items: list) -> list:
        mc = self.mcfg
        b = self.max_batch
        labels = np.zeros((b, mc.num_objects, mc.label_dim), np.float32)
        bbox = np.full((b, mc.num_objects, 4), -1.0, np.float32)
        for i, item in enumerate(items):
            labels[i], bbox[i] = _item_layout(item, mc.num_objects,
                                              mc.label_dim, self._rs)
        z = torch.randn((b, mc.z_dim), generator=self._gen,
                        device=self.device)
        img = self._sample(self.g, z, torch.from_numpy(bbox).to(self.device),
                           torch.from_numpy(labels).to(self.device))
        imgs = img[:len(items)].permute(0, 2, 3, 1).cpu().numpy()
        self.device_batches += 1
        return [_png_b64(im) for im in imgs]

    def stats(self) -> dict:
        return {"device": str(self.device),
                "device_batches": self.device_batches,
                "k1_launches": stn_place_cuda.launch_count()}


# ---------------------------------------------------------------------------
# HTTP layer


def make_handler(batcher: MicroBatcher, info: dict, validate=None,
                 extra_stats: Optional[Callable[[], dict]] = None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, **info})
            elif self.path == "/stats":
                extra = extra_stats() if extra_stats is not None else {}
                self._json(200, {**batcher.snapshot(), **extra})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                return self._json(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                items = req.get("items", [{}])
                if not isinstance(items, list) or not items:
                    raise ValueError("items must be a non-empty list")
                if len(items) > batcher.max_batch:
                    raise ValueError(
                        f"at most {batcher.max_batch} items per request")
                if validate is not None:
                    for it in items:  # reject HERE, not inside the shared
                        validate(it)  # device batch (one bad item must not
                                      # fail other clients' requests)
                self._json(200, {"images": batcher.submit_many(items)})
            except ValueError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # keep serving; report the failure
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def build_service(args) -> Stage1Service:
    """The service the CLI arguments name: the MNIST preset, or the model
    config and NET_G of ``--cfg``; ``--net_g`` wins over the YAML, and
    ``--bf16`` makes the generator compute in bf16."""
    dt = torch.bfloat16 if getattr(args, "bf16", False) else None
    mcfg, net_g = dataclasses.replace(MNIST, compute_dtype=dt), args.net_g
    if args.cfg:
        from multiple_objects_gan_tpu_torch.config.config import (
            cfg_from_file, stage1_model_config)

        cfg = cfg_from_file(args.cfg, args.variant)
        mcfg = stage1_model_config(cfg, args.variant, compute_dtype=dt)
        net_g = net_g or cfg.NET_G
    return Stage1Service(mcfg, net_g, seed=args.seed, device=args.device)


def serve(args, service: Optional[Stage1Service] = None
          ) -> ThreadingHTTPServer:
    """Build the service (unless given) and batcher and return a bound,
    unstarted server; the CLI calls serve_forever, tests and chip_smoke.py
    drive it from a thread."""
    svc = service if service is not None else build_service(args)
    batcher = MicroBatcher(svc.run, max_batch=svc.max_batch,
                           max_wait_ms=args.max_wait_ms)
    info = {"variant": args.variant, "max_batch": svc.max_batch,
            "device": str(svc.device), "weights": svc.weights,
            "bf16": svc.mcfg.compute_dtype == torch.bfloat16}
    httpd = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(batcher, info, validate=svc.validate,
                     extra_stats=svc.stats))
    httpd.batcher = batcher
    httpd.service = svc
    return httpd


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--variant", required=True, choices=["multi-mnist"])
    p.add_argument("--cfg", default="",
                   help="reference YAML (cfg/mnist_eval.yml); default: the "
                        "Multi-MNIST preset")
    p.add_argument("--net_g", default="",
                   help="reference-format .pth (overrides the YAML's "
                        "NET_G); default: random init from --seed")
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="run the generator in bf16 (float32 weights and "
                        "running statistics, float32 images out)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    httpd = serve(args)
    print(f"serving {args.variant} on http://{args.host}:"
          f"{httpd.server_address[1]} on {httpd.service.device} "
          f"(max_batch={MAX_BATCH}, max_wait={args.max_wait_ms}ms, "
          f"weights: {httpd.service.weights})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        httpd.batcher.close()


if __name__ == "__main__":
    main()
