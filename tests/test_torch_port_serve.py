"""The port's serving path (multiple_objects_gan_tpu_torch/cli/serve.py) on
the CPU at small width, its PNG writer against the JAX package's, the
package's import boundary and its device rule."""

from __future__ import annotations

import argparse
import ast
import base64
import dataclasses
import http.client
import io
import json
import os
import struct
import threading
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from multiple_objects_gan_tpu.cli.serve import _png_b64 as jax_png_b64
from multiple_objects_gan_tpu_torch import resolve_device
from multiple_objects_gan_tpu_torch.cli import serve as port_serve
from multiple_objects_gan_tpu_torch.cli.serve import (
    MicroBatcher, Stage1Service, _item_layout, _png_b64)
from multiple_objects_gan_tpu_torch.models import common
from multiple_objects_gan_tpu_torch.utils.images import PNG_SIGNATURE

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
SMALL = dataclasses.replace(common.MNIST, gf_dim=8)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- micro-batcher


def test_microbatcher_coalesces_concurrent_requests():
    sizes = []

    def run_batch(items):
        sizes.append(len(items))
        return [i * 10 for i in items]

    b = MicroBatcher(run_batch, max_batch=4, max_wait_ms=60)
    results = [None] * 6

    def call(i):
        results[i] = b.submit(i)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    b.close()

    assert results == [0, 10, 20, 30, 40, 50]  # fan-out order preserved
    assert sum(sizes) == 6
    assert max(sizes) > 1          # concurrency actually coalesced
    assert all(s <= 4 for s in sizes)
    snap = b.snapshot()
    assert snap["requests"] == 6 and snap["items"] == 6
    assert snap["avg_batch_fill"] > 1.0


def test_microbatcher_fans_out_errors():
    def run_batch(items):
        raise RuntimeError("boom")

    b = MicroBatcher(run_batch, max_batch=2, max_wait_ms=1)
    with pytest.raises(RuntimeError, match="boom"):
        b.submit({"x": 1})
    b.close()


def test_item_layout_ids_and_onehots():
    rs = np.random.RandomState(0)
    lab, bb = _item_layout({"labels": [3, [0] * 9 + [1]],
                            "bboxes": [[0.1, 0.2, 0.3, 0.4],
                                       [0.5, 0.5, 0.2, 0.2]]}, 3, 10, rs)
    assert lab.shape == (3, 10) and bb.shape == (3, 4)
    assert lab[0, 3] == 1.0 and lab[1, 9] == 1.0
    np.testing.assert_allclose(bb[0], [0.1, 0.2, 0.3, 0.4])
    np.testing.assert_allclose(bb[2], -1.0)   # padded object
    assert lab[2].sum() == 0.0


def test_item_layout_random_fallback_and_errors():
    rs = np.random.RandomState(0)
    lab, bb = _item_layout({}, 3, 10, rs)      # no layout -> random
    n_active = int((bb[:, 0] >= 0).sum())
    assert 1 <= n_active <= 3
    assert lab.sum() == n_active               # one-hot per active object

    with pytest.raises(ValueError, match="same length"):
        _item_layout({"labels": [1], "bboxes": []}, 3, 10, rs)
    with pytest.raises(ValueError, match="at most"):
        _item_layout({"labels": [1] * 4,
                      "bboxes": [[0, 0, .1, .1]] * 4}, 3, 10, rs)
    with pytest.raises(ValueError, match="one-hot"):
        _item_layout({"labels": [[1, 0]],
                      "bboxes": [[0, 0, .1, .1]]}, 3, 10, rs)


# -------------------------------------------------------------------- PNG


def _decode(b64: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


@pytest.mark.parametrize("channels", [1, 3])
def test_png_matches_jax_pixels(channels):
    """The stdlib PNG decodes to the pixels of the JAX package's PIL PNG,
    values outside [-1, 1] clipped alike."""
    img = np.random.RandomState(channels).uniform(
        -1.3, 1.3, (9, 7, channels)).astype(np.float32)
    img[0, 0] = -1.0
    img[0, 1] = 1.0
    got, want = _decode(_png_b64(img)), _decode(jax_png_b64(img))
    assert got.shape == want.shape == ((9, 7) if channels == 1 else (9, 7, 3))
    np.testing.assert_array_equal(got, want)


def test_png_chunks_are_well_formed():
    raw = base64.b64decode(_png_b64(np.zeros((64, 64, 1), np.float32)))
    assert raw[:8] == PNG_SIGNATURE
    length, kind = struct.unpack(">I4s", raw[8:16])
    assert (length, kind) == (13, b"IHDR")
    assert struct.unpack(">IIBBBBB", raw[16:29]) == (64, 64, 8, 0, 0, 0, 0)
    assert struct.unpack(">I", raw[29:33])[0] == zlib.crc32(raw[12:29])
    assert raw.endswith(b"IEND\xaeB`\x82")


# ------------------------------------------------------------------ server


@pytest.fixture(scope="module")
def server():
    svc = Stage1Service(SMALL, seed=3, device="cpu")
    args = argparse.Namespace(variant="multi-mnist", host="127.0.0.1",
                              port=0, max_wait_ms=20.0)
    httpd = port_serve.serve(args, svc)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield httpd.server_address[1], httpd
    httpd.shutdown()
    httpd.server_close()
    httpd.batcher.close()
    thread.join(timeout=10)


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_server_concurrent_generate(server):
    port, httpd = server
    item = {"labels": [1, 7], "bboxes": [[0.1, 0.1, 0.3, 0.3],
                                         [0.5, 0.4, 0.3, 0.4]]}
    results = [None] * 8
    before = httpd.batcher.snapshot()["items"]

    def call(i):
        results[i] = _request(port, "POST", "/generate",
                              {"items": [item] * (1 + i % 3)})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for i, (status, body) in enumerate(results):
        assert status == 200, body
        assert len(body["images"]) == 1 + i % 3
        for b64 in body["images"]:
            px = _decode(b64)
            assert px.shape == (64, 64) and px.dtype == np.uint8
    assert httpd.batcher.snapshot()["items"] - before == sum(
        1 + i % 3 for i in range(8))


def test_server_healthz_and_stats(server):
    port, httpd = server
    status, body = _request(port, "GET", "/healthz")
    assert status == 200 and body["ok"] is True
    assert body["device"] == "cpu" and body["max_batch"] == 64
    _request(port, "POST", "/generate", {"items": [{}]})
    status, stats = _request(port, "GET", "/stats")
    assert status == 200
    assert stats["device"] == "cpu"
    assert stats["device_batches"] == stats["batches"] + 1  # + warm-up
    assert stats["k1_launches"] == 0       # CPU tensors: the plain version


def test_server_rejects_malformed_items(server):
    port, _ = server
    status, body = _request(port, "POST", "/generate",
                            {"items": [{"labels": [1], "bboxes": []}]})
    assert status == 400 and "same length" in body["error"]
    status, body = _request(port, "POST", "/generate",
                            {"items": [{}] * 65})
    assert status == 400 and "at most 64" in body["error"]
    assert _request(port, "GET", "/nope")[0] == 404


def test_build_service_from_yaml(tmp_path):
    yml = tmp_path / "mnist.yml"
    yml.write_text("Z_DIM: 16\nGAN:\n    GF_DIM: 8\n")
    args = port_serve.parse_args(["--variant", "multi-mnist", "--cfg",
                                  str(yml), "--device", "cpu"])
    svc = port_serve.build_service(args)
    assert svc.mcfg.z_dim == 16 and svc.mcfg.ngf == 64
    assert len(svc.run([{}, {}])) == 2


# ------------------------------------------------------ boundary and device


_BANNED = {"jax", "jaxlib", "flax", "optax", "orbax",
           "multiple_objects_gan_tpu"}


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """AST scan (jax is pre-imported in this environment, so sys.modules
    cannot tell). Matches the exact top-level name, so the port's own
    ``multiple_objects_gan_tpu_torch`` is allowed."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT,
                                            "multiple_objects_gan_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    offenders = [(os.path.relpath(p, ROOT), m) for p in files
                 for m in _imported_roots(p) if m in _BANNED]
    assert not offenders


def test_resolve_device_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Stage1Service(SMALL)


# ------------------------------------------- layout validation (F2, F3)


@pytest.mark.parametrize("item, message", [
    ({"labels": [1], "bboxes": [[0.1, 0.1, 0.0, 0.3]]}, "w, h > 0"),
    ({"labels": [1], "bboxes": [[0.1, 0.1, 0.3, -0.2]]}, "w, h > 0"),
    ({"labels": [1], "bboxes": [[float("nan"), 0.1, 0.3, 0.3]]}, "finite"),
    ({"labels": [10], "bboxes": [[0.1, 0.1, 0.3, 0.3]]}, "outside"),
    ({"labels": [-1], "bboxes": [[0.1, 0.1, 0.3, 0.3]]}, "outside"),
], ids=["zero-width", "negative-height", "nan", "id-10", "id-minus-1"])
def test_server_rejects_bad_boxes_and_label_ids(server, item, message):
    """A box the place cannot take (non-finite, w or h <= 0) and a label id
    outside [0, label_dim) are the client's fault: 400, not 500, and no
    wrap-around of -1 to class 9."""
    port, _ = server
    status, body = _request(port, "POST", "/generate", {"items": [item]})
    assert status == 400 and message in body["error"], body


def test_server_accepts_padded_objects(server):
    port, _ = server
    item = {"labels": [2, 5], "bboxes": [[0.1, 0.1, 0.3, 0.3],
                                         [-1.0, -1.0, -1.0, -1.0]]}
    status, body = _request(port, "POST", "/generate", {"items": [item]})
    assert status == 200 and len(body["images"]) == 1
    lab, bb = _item_layout(item, 3, 10, np.random.RandomState(0))
    np.testing.assert_array_equal(bb[1:], -1.0)
    assert lab[0, 2] == 1.0 and lab[1, 5] == 1.0
