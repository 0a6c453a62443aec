"""The server's ``--max_batch`` (``cli/serve.py``) on the CPU, against the
JAX package's service at the same ``max_batch``.

Both services read one cfg (cfg/mnist_eval.yml at GF_DIM 8, its NET_G a
reference-format ``.pth`` of a seeded port generator, BatchNorm moved off
its init) at ``max_batch`` 8: the port's through ``--cfg`` and
``--max_batch`` (``build_service``), the JAX package's ``Stage1Service``
from its own cfg reader. For eight seeded items (one to three objects each)
and the same z, the JAX service's draw for its second batch, replayed, the
served images decode to the same pixels within 1 level of 255 (float32
rounding at a level's edge). Over HTTP a request of 9 items gets the JAX
service's 400 ("at most 8 items per request"), /healthz reports 8, an
8-item request fills one device batch, and a service without the flag
keeps ``MAX_BATCH``.
"""

from __future__ import annotations

import base64
import dataclasses
import http.client
import io
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from multiple_objects_gan_tpu.cli.serve import (
    Stage1Service as JStage1Service)
from multiple_objects_gan_tpu.config.config import (
    cfg_from_file as jcfg_from_file)
from multiple_objects_gan_tpu_torch.cli import serve as port_serve
from multiple_objects_gan_tpu_torch.models import common
from multiple_objects_gan_tpu_torch.models.stage1 import build_stage1_g
from test_torch_parity import _randomize

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
MAX_BATCH = 8
SEED = 0
LEVELS = 1


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg_file(tmp_path_factory):
    """cfg/mnist_eval.yml at GF_DIM 8 whose NET_G is a seeded port G."""
    tmp = tmp_path_factory.mktemp("max_batch")
    g = build_stage1_g(dataclasses.replace(common.MNIST, gf_dim=8), seed=3,
                       device="cpu")
    _randomize(g, seed=5)
    pth = str(tmp / "netG.pth")
    torch.save({"netG": g.state_dict()}, pth)
    with open(os.path.join(ROOT, "cfg", "mnist_eval.yml")) as f:
        text = f.read()
    text = (text.replace("GF_DIM: 128", "GF_DIM: 8")
            .replace("NET_G: 'models/model-multi-mnist-0019.pth'",
                     f"NET_G: '{pth}'"))
    path = str(tmp / "mnist_eval_small.yml")
    with open(path, "w") as f:
        f.write(text)
    return path


def _args(cfg_file, *flags):
    return port_serve.parse_args(["--variant", "multi-mnist", "--cfg",
                                  cfg_file, "--device", "cpu", "--port", "0",
                                  "--max_wait_ms", "20", *flags])


def _items(n, seed=5):
    rs = np.random.RandomState(seed)
    items = []
    for _ in range(n):
        k = rs.randint(1, 4)
        w, h = rs.uniform(0.2, 0.45, (2, k))
        items.append({"labels": [int(v) for v in rs.randint(0, 10, k)],
                      "bboxes": [[float(rs.uniform(0, 1 - w[j])),
                                  float(rs.uniform(0, 1 - h[j])),
                                  float(w[j]), float(h[j])]
                                 for j in range(k)]})
    return items


def _decode(b64: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))),
                      np.int32)


def test_parse_args_max_batch_defaults_to_max_batch(cfg_file):
    assert _args(cfg_file).max_batch == port_serve.MAX_BATCH == 64
    assert _args(cfg_file, "--max_batch", "8").max_batch == 8


def test_service_at_max_batch_8_matches_jax_service(cfg_file, monkeypatch):
    jsvc = JStage1Service(jcfg_from_file(cfg_file, "multi-mnist"),
                          "multi-mnist", MAX_BATCH, SEED)
    svc = port_serve.build_service(_args(cfg_file, "--max_batch", "8"))
    assert svc.max_batch == jsvc.max_batch == MAX_BATCH
    items = _items(MAX_BATCH)
    want = jsvc.run(items)
    # the JAX service's z for its second batch (the first is its warm-up)
    z = np.asarray(jax.random.normal(jax.random.fold_in(
        jax.random.PRNGKey(SEED), 2), (MAX_BATCH, svc.mcfg.z_dim)))
    randn = torch.randn

    def replayed(*shape, **kwargs):
        if shape and tuple(shape[0]) == z.shape:
            return torch.from_numpy(z.copy())
        return randn(*shape, **kwargs)

    monkeypatch.setattr(torch, "randn", replayed)
    got = svc.run(items)
    assert len(got) == len(want) == MAX_BATCH
    for i, (a, b) in enumerate(zip(got, want)):
        pa, pb = _decode(a), _decode(b)
        assert pa.shape == pb.shape == (64, 64)
        assert int(np.abs(pa - pb).max()) <= LEVELS, i


@pytest.fixture(scope="module")
def server(cfg_file):
    httpd = port_serve.serve(_args(cfg_file, "--max_batch", "8"))
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


def test_server_refuses_more_items_than_max_batch(server):
    port, httpd = server
    status, body = _request(port, "POST", "/generate",
                            {"items": _items(MAX_BATCH + 1)})
    assert status == 400
    assert body["error"] == f"at most {MAX_BATCH} items per request"
    assert httpd.batcher.snapshot()["items"] == 0


def test_server_healthz_reports_max_batch(server):
    status, body = _request(server[0], "GET", "/healthz")
    assert status == 200 and body["max_batch"] == MAX_BATCH


def test_server_fills_one_device_batch_at_max_batch(server):
    port, httpd = server
    before = httpd.service.device_batches
    status, body = _request(port, "POST", "/generate",
                            {"items": _items(MAX_BATCH, seed=9)})
    assert status == 200 and len(body["images"]) == MAX_BATCH
    assert httpd.service.device_batches - before == 1
    assert httpd.batcher.snapshot()["avg_batch_fill"] == MAX_BATCH


def test_services_without_the_flag_keep_max_batch(monkeypatch):
    monkeypatch.setattr(port_serve, "MAX_BATCH", 3)
    svc = port_serve.Stage1Service(
        dataclasses.replace(common.MNIST, gf_dim=8), seed=1, device="cpu")
    assert svc.max_batch == 3
    with pytest.raises(ValueError, match="at least 1"):
        port_serve.Stage1Service(dataclasses.replace(common.MNIST, gf_dim=8),
                                 device="cpu", max_batch=0)
