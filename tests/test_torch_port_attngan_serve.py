"""The port's AttnGAN service (multiple_objects_gan_tpu_torch/cli/serve.py:
AttnGanService, ``--variant coco-attngan``) on the CPU, against the JAX
package's AttnGanService, over HTTP.

Both services are built from one cfg at small width (GF 4, CONDITION 8,
EMBEDDING 8, R_NUM 1, three branches, WORDS_NUM 6) whose TRAIN.NET_G and
TRAIN.NET_E name reference-format ``.pth`` files the test writes (He-scale
weights, BatchNorm away from its init), on one synthetic set written by the
port. The JAX service runs as the JAX package runs it on the CPU (its
own jit, no Pallas: the place is its plain einsum there). The port's z is
the JAX service's for the same request (``jax.random.normal`` of its key
folded with the batch count), so the served PNGs must agree within
PNG_LEVELS (1 level of 255: the float32 images differ by rounding only,
GNET_ATOL of tests/test_torch_port_attngan_model.py).
"""

from __future__ import annotations

import base64
import dataclasses
import http.client
import io
import json
import threading

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from multiple_objects_gan_tpu.cli.attngan_runner import build_all
from multiple_objects_gan_tpu.cli.serve import (
    AttnGanService as JAttnGanService)
from multiple_objects_gan_tpu.config.config import (
    cfg_from_file as jcfg_from_file, default_config as jdefault_config)
from multiple_objects_gan_tpu_torch.cli import serve as port_serve
from multiple_objects_gan_tpu_torch.config.config import (
    attngan_model_config, cfg_from_file, default_config)
from multiple_objects_gan_tpu_torch.data.attngan import (
    AttnGanDataset, write_synthetic_attngan)
from multiple_objects_gan_tpu_torch.models.attngan import build_attngan_g
from multiple_objects_gan_tpu_torch.nn.encoders import build_text_encoder

PNG_LEVELS = 1
MAX_BATCH = 4
SEED = 0
_YAML = """CONFIG_NAME: 'tiny'
DATA_DIR: '{data}'
TREE:
    BRANCH_NUM: 3
TRAIN:
    FLAG: False
    NET_G: '{net_g}'
    NET_E: '{net_e}'
GAN:
    DF_DIM: 4
    GF_DIM: 4
    Z_DIM: 100
    CONDITION_DIM: 8
    R_NUM: 1
TEXT:
    EMBEDDING_DIM: 8
    CAPTIONS_PER_IMAGE: 5
    WORDS_NUM: 6
"""


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _he(sd: dict, seed: int) -> dict:
    """Every tensor of a state dict drawn anew: kernels at He scale,
    BatchNorm weights near 1, biases and means near 0, variances in
    [0.5, 1.5]; the LSTM's and the embedding's uniform in [-0.3, 0.3]."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            out[k] = v
        elif k.startswith(("rnn.", "encoder.")):
            out[k] = torch.rand(v.shape, generator=gen) * 0.6 - 0.3
        elif k.endswith("running_var"):
            out[k] = torch.rand(v.shape, generator=gen) + 0.5
        elif v.dim() == 1:
            out[k] = torch.randn(v.shape, generator=gen) * 0.2 + (
                1.0 if k.endswith("weight") and "ca_net" not in k else 0.0)
        else:
            out[k] = torch.randn(v.shape, generator=gen) * (
                2.0 / v[0].numel()) ** 0.5
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The set, the two .pth files, the cfg, and the JAX service on it."""
    root = tmp_path_factory.mktemp("attn")
    data = str(root / "data")
    write_synthetic_attngan(data, n=8, seed=2)
    n_words = AttnGanDataset(data, split="test").n_words
    net_g, net_e, yml = (str(root / "netG.pth"), str(root / "text.pth"),
                         str(root / "tiny.yml"))
    with open(yml, "w") as f:
        f.write(_YAML.format(data=data, net_g=net_g, net_e=net_e))
    mcfg = attngan_model_config(cfg_from_file(yml, "coco-attngan"))
    g_sd = _he(build_attngan_g(mcfg, device="cpu").state_dict(), 1)
    e_sd = _he(build_text_encoder(n_words, mcfg.embedding_dim,
                                  device="cpu").state_dict(), 2)
    torch.save({"netG": g_sd, "epoch": 0}, net_g)
    torch.save(e_sd, net_e)
    jsvc = JAttnGanService(jcfg_from_file(yml, "coco-attngan"), data, data,
                           MAX_BATCH, SEED)
    return {"yml": yml, "data": data, "jsvc": jsvc, "n_words": n_words}


@pytest.fixture(scope="module")
def server(setup):
    mp = pytest.MonkeyPatch()
    mp.setattr(port_serve, "MAX_BATCH", MAX_BATCH)
    args = port_serve.parse_args(["--variant", "coco-attngan", "--cfg",
                                  setup["yml"], "--device", "cpu",
                                  "--port", "0"])
    httpd = port_serve.serve(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield httpd.server_address[1], httpd
    httpd.shutdown()
    httpd.server_close()
    httpd.batcher.close()
    thread.join(timeout=10)
    mp.undo()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _rgb(b64: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


ITEMS = [
    {"caption": "obj3 loc11 word2", "labels": [3],
     "bboxes": [[0.2, 0.2, 0.4, 0.4]]},
    {"caption": "An OBJ7, loc02 and a dragon obj12 loc21 word0 word9 word4",
     "labels": [7, 12], "bboxes": [[0.0, 0.1, 0.3, 0.5],
                                   [0.55, 0.5, 0.35, 0.3]]},
    {"caption": "nothing here is known", "labels": [1, 2, 79],
     "bboxes": [[0.1, 0.1, 0.2, 0.2], [0.4, 0.4, 0.2, 0.2],
                [0.7, 0.1, 0.25, 0.6]]},
]


def test_served_images_match_the_jax_service(setup, server):
    """Three items (in-vocabulary words; OOV words among them and a
    caption longer than WORDS_NUM; an all-OOV caption) over HTTP: the
    port's 256px PNGs against the JAX service's for the same items and z."""
    port, httpd = server
    jsvc = setup["jsvc"]
    want = [_rgb(b) for b in jsvc.run(ITEMS)]
    z = jax.random.normal(jax.random.fold_in(jsvc._rng, jsvc._n),
                          (MAX_BATCH, jsvc.mcfg.z_dim))
    httpd.service.draw_z = lambda: torch.from_numpy(np.array(z))
    status, body = _request(port, "POST", "/generate", {"items": ITEMS})
    assert status == 200, body
    got = [_rgb(b) for b in body["images"]]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (256, 256, 3)
        assert int(np.abs(g.astype(np.int16) - w).max()) <= PNG_LEVELS
    assert np.std(got[1]) > 5.0


def test_token_ids_match_the_jax_service(setup, server):
    """In-vocabulary words kept in order, OOV words dropped, cut at
    WORDS_NUM, an all-OOV or empty caption the largest word id."""
    _, httpd = server
    svc, jsvc = httpd.service, setup["jsvc"]
    for caption in ("obj3 loc11 word2", ITEMS[1]["caption"],
                    "nothing here is known", "", "WORD1 word1 word1!"):
        assert svc.token_ids(caption) == jsvc._tokenize(caption), caption
    assert svc.token_ids("zzz") == [setup["n_words"] - 1]
    assert svc.token_ids(ITEMS[2]["caption"]) == [setup["n_words"] - 1]
    assert len(svc.token_ids(ITEMS[1]["caption"])) == 6
    arr = svc.batch(ITEMS[:1])
    ids = svc.token_ids(ITEMS[0]["caption"])
    assert arr["caps"].shape == (MAX_BATCH, 6) and len(ids) >= 2
    assert list(arr["caps"][0, :len(ids)]) == ids
    assert not arr["caps"][0, len(ids):].any() and not arr["caps"][1:].any()
    assert list(arr["lens"]) == [len(ids), 1, 1, 1]
    assert (arr["bbox"][1:] == -1).all()


@pytest.mark.parametrize("item, message", [
    ({"caption": 3}, "caption must be a string"),
    ({"caption": "obj1", "labels": [81], "bboxes": [[0.1, 0.1, 0.2, 0.2]]},
     "outside [0, 81)"),
    ({"caption": "obj1", "labels": [1, 2], "bboxes": [[0.1, 0.1, 0.2, 0.2]]},
     "same length"),
    ({"caption": "obj1", "labels": [1] * 4,
      "bboxes": [[0.1, 0.1, 0.2, 0.2]] * 4}, "at most 3 objects"),
    ({"caption": "obj1", "labels": [1], "bboxes": [[0.1, 0.1, 0.0, 0.2]]},
     "w, h > 0"),
])
def test_server_rejects_bad_items(server, item, message):
    port, _ = server
    status, body = _request(port, "POST", "/generate", {"items": [item]})
    assert status == 400 and message in body["error"], body


def test_server_healthz_stats_and_random_layouts(server):
    """A caption without a layout draws one; /stats counts the device
    batches (the warm-up included) and K1's launches (0: CPU tensors take
    the plain version)."""
    port, httpd = server
    status, body = _request(port, "GET", "/healthz")
    assert status == 200 and body["variant"] == "coco-attngan"
    assert body["max_batch"] == MAX_BATCH and body["bf16"] is False
    assert "netG.pth" in body["weights"] and "text.pth" in body["weights"]
    status, body = _request(port, "POST", "/generate",
                            {"items": [{"caption": "obj5"}, {}]})
    assert status == 200 and len(body["images"]) == 2
    status, stats = _request(port, "GET", "/stats")
    assert stats["device_batches"] == stats["batches"] + 1
    assert stats["k1_launches"] == 0


def test_missing_weights_warn_and_serve_random(setup, tmp_path, capsys,
                                               monkeypatch):
    """NET_G and NET_E that do not exist: the JAX package's WARNINGs, and
    seeded random weights; --net_g wins over TRAIN.NET_G; --bf16 serves
    float32 images from a bf16 generator."""
    monkeypatch.setattr(port_serve, "MAX_BATCH", 2)
    yml = tmp_path / "missing.yml"
    yml.write_text(_YAML.format(data=setup["data"],
                                net_g=str(tmp_path / "no_g.pth"),
                                net_e=str(tmp_path / "no_e.pth")))
    args = port_serve.parse_args(["--variant", "coco-attngan", "--cfg",
                                  str(yml), "--device", "cpu", "--bf16"])
    svc = port_serve.build_service(args)
    out = capsys.readouterr().out
    assert "WARNING: TRAIN.NET_G=" in out and "WARNING: NET_E=" in out
    assert svc.mcfg.compute_dtype == torch.bfloat16
    assert "random init, seed 0" in svc.weights
    assert _rgb(svc.run([{"caption": "obj1 loc00"}])[0]).shape == (256, 256,
                                                                 3)
    args = port_serve.parse_args(["--variant", "coco-attngan", "--cfg",
                                  str(yml), "--device", "cpu", "--net_g",
                                  str(tmp_path / "other.pth")])
    port_serve.build_service(args)
    assert "other.pth" in capsys.readouterr().out


@pytest.mark.parametrize("which, kind", [
    ("net_g", "directory"), ("net_g", "not_a_pth"), ("net_e", "directory"),
    ("net_e", "not_a_pth")])
def test_existing_weights_that_are_no_pth_raise(setup, tmp_path, capsys,
                                               which, kind):
    """A NET_G or NET_E that exists but is no reference-format ``.pth``
    (a run directory, as the flagship's coco_attn_sampling.yml names, or
    a file torch cannot read) raises: only a missing path serves random
    weights."""
    bad = tmp_path / "out_e120"
    if kind == "directory":
        bad.mkdir()
    else:
        bad.write_bytes(b"not a checkpoint")
    paths = {"net_g": str(tmp_path / "no_g.pth"),
             "net_e": str(tmp_path / "no_e.pth"), which: str(bad)}
    yml = tmp_path / "bad.yml"
    yml.write_text(_YAML.format(data=setup["data"], **paths))
    args = port_serve.parse_args(["--variant", "coco-attngan", "--cfg",
                                  str(yml), "--device", "cpu"])
    name = "TRAIN.NET_G" if which == "net_g" else "NET_E"
    with pytest.raises(ValueError, match=f"{name}=.*out_e120.*\\.pth"):
        port_serve.build_service(args)
    assert f"WARNING: {name}=" not in capsys.readouterr().out


@pytest.mark.parametrize("bf16", [False, True])
def test_serve_turns_tf32_off_for_any_float32_card_service(monkeypatch,
                                                           bf16):
    """serve() sets the float32 policy for every variant in one place: a
    float32 service on the card turns TF32 off for matmuls and cuDNN, a
    bf16 one leaves both as they were; building a service changes
    neither."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)

    class CardService:       # a stand-in: serve() only reads these
        device, max_batch, weights = torch.device("cuda"), 2, "none"
        mcfg = dataclasses.replace(
            port_serve.MNIST,
            compute_dtype=torch.bfloat16 if bf16 else None)

        def run(self, items):
            raise AssertionError("no request is sent")

        def validate(self, item):
            pass

        def stats(self):
            return {}

    args = port_serve.parse_args(["--variant", "multi-mnist", "--port",
                                  "0"])
    httpd = port_serve.serve(args, CardService())
    try:
        assert torch.backends.cuda.matmul.allow_tf32 is bf16
        assert torch.backends.cudnn.allow_tf32 is bf16
    finally:
        httpd.server_close()
        httpd.batcher.close()


def test_attngan_config_matches_jax(setup):
    """The coco-attngan default tree, and the model config a cfg gives,
    against the JAX package's tree and build_all's; the port's config also
    carries the JAX package's global knobs, the compute dtype and the
    BatchNorm groups, here at their defaults."""
    assert default_config("coco-attngan") == jdefault_config("coco-attngan")
    for path in (setup["yml"], "cfg/coco_attn_eval.yml",
                 "cfg/coco_attn_train.yml"):
        mine = attngan_model_config(cfg_from_file(path, "coco-attngan"))
        theirs = build_all(jcfg_from_file(path, "coco-attngan"), 10)[0]
        got = dataclasses.asdict(mine)
        assert got.pop("compute_dtype") is None
        assert got.pop("bn_groups") == 1
        assert got == dataclasses.asdict(theirs), path
    assert attngan_model_config(cfg_from_file(
        "cfg/coco_attn_train.yml", "coco-attngan")).ngf == 768
