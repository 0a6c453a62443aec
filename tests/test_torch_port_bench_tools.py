"""The port's bench tools (``tools/bench_variants.py``,
``tools/bench_sampling.py``) on the CPU: their JSON keys against the JAX
tools' source, the FLOP count against an independent count from the
modules' shapes, the byte counter on one matmul of known size, every tool
function at GF 8, batch 4 and n 1 on ``--device cpu``, and each tool's
dtype rule (bench_variants reads ``MOG_COMPUTE_DTYPE``, bench_sampling
only ``--f32``). Times read here are the CPU's and are not checked.
"""

from __future__ import annotations

import ast
import dataclasses
import math
import os

import pytest
import torch

from multiple_objects_gan_tpu_torch.config.config import (
    cfg_from_file, stage1_model_config)
from multiple_objects_gan_tpu_torch.models.common import (
    CLEVR, COCO_S1, COCO_S2, MNIST)
from multiple_objects_gan_tpu_torch.models.stage1 import (
    build_stage1_d, build_stage1_g)
from multiple_objects_gan_tpu_torch.nn import pathways
from multiple_objects_gan_tpu_torch.ops import stn_place_cuda
from multiple_objects_gan_tpu_torch.tools import bench_sampling as bsm
from multiple_objects_gan_tpu_torch.tools import bench_variants as bv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_ATTN = dataclasses.replace(bv.ATTN_BENCH, gf_dim=8, df_dim=8,
                                 embedding_dim=16)


@pytest.fixture(autouse=True)
def _setting(monkeypatch):
    monkeypatch.delenv("MOG_COMPUTE_DTYPE", raising=False)
    monkeypatch.delenv("MOG_BN_GROUPS", raising=False)
    monkeypatch.delenv("MOG_ATTNGAN_BS", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _small(cfg):
    return dataclasses.replace(cfg, gf_dim=8, df_dim=8)


def _functions(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _jax_dict_keys(path, name) -> list:
    """The keys of the JAX tool's module-level dict ``name``."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    node = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == name)
    return [k.value for k in node.keys]


def _str_keys(node) -> set:
    return {k.value for k in node.keys if isinstance(k, ast.Constant)}


def _jax_variant_keys() -> set:
    """The JAX bench_variants line: the dict each bench hands ``_roofline``
    and the keys ``_roofline`` adds."""
    fns = _functions("tools/bench_variants.py")
    added = [_str_keys(c.args[0]) for c in ast.walk(fns["_roofline"])
             if isinstance(c, ast.Call) and getattr(c.func, "attr", "")
             == "update"]
    given = [_str_keys(c.args[0]) for name in ("_bench_stage1",
                                               "bench_stage2",
                                               "bench_attngan")
             for c in ast.walk(fns[name]) if isinstance(c, ast.Call)
             and getattr(c.func, "id", "") == "_roofline"]
    assert len(added) == 1 and len(given) == 3 and len(set(map(frozenset,
                                                               given))) == 1
    return added[0] | given[0]


def _jax_sampling_keys() -> list:
    fns = _functions("tools/bench_sampling.py")
    return [_str_keys(r.value) for name in ("bench_variant", "bench_attngan")
            for r in ast.walk(fns[name])
            if isinstance(r, ast.Return) and isinstance(r.value, ast.Dict)]


def test_key_sets_are_the_jax_tools():
    want = _jax_variant_keys()
    assert want == {"variant", "batch", "step_ms", "img_per_sec",
                    "tflops_per_step", "gbytes_per_step", "mfu", "hbm_util",
                    "bound"}
    line = bv.roofline({"variant": "v", "batch": 4, "step_ms": 1.0,
                        "img_per_sec": 4000.0}, 1e9, 1e8, 1e-3, None,
                       torch.device("cpu"))
    assert set(line) == want
    keys = _jax_sampling_keys()
    assert len(keys) == 2 and keys[0] == keys[1]
    assert set(bsm._line("mnist", 4, True, 0.01)) == keys[0]
    assert list(bv.BENCHES) == _jax_dict_keys("tools/bench_variants.py",
                                              "BENCHES")
    assert list(bsm.VARIANTS) == _jax_dict_keys("tools/bench_sampling.py",
                                                "VARIANTS")


def test_roofline_against_the_h100_peaks():
    """On the card mfu is FLOP/s over 989 TFLOP/s (bf16) or 67 TFLOP/s
    (float32), hbm_util bytes/s over 3.35 TB/s; the larger binds."""
    cuda = torch.device("cuda")
    line = bv.roofline({}, 989e9, 3.35e9, 1e-3, torch.bfloat16, cuda)
    assert (line["mfu"], line["hbm_util"]) == (1.0, 1.0)
    line = bv.roofline({}, 67e9, 1e9, 1e-3, None, cuda)
    assert line["mfu"] == 1.0 and line["bound"] == "mxu"
    line = bv.roofline({}, 1e9, 3.35e9, 1e-3, torch.bfloat16, cuda)
    assert line["bound"] == "hbm"
    assert (line["tflops_per_step"], line["gbytes_per_step"]) == (0.001,
                                                                  3.35)


def test_byte_counter_on_one_matmul():
    """(m, k) @ (k, n) in float32 reads and writes 4 (mk + kn + mn)
    bytes at the op's boundary; a view moves none."""
    a, b = torch.ones(32, 48), torch.ones(48, 16)
    with bv.ByteCounter() as c:
        torch.mm(a, b)
    assert c.bytes == 4 * (32 * 48 + 48 * 16 + 32 * 16)
    with bv.ByteCounter() as c:
        a.t()
        a.view(48, 32)
    assert c.bytes == 0


def _shape_flops(model, run, monkeypatch):
    """FLOPs of ``run()`` from the shapes its Conv2d and Linear modules
    see and from the shapes of the STN products (the plain K1, the object
    pathways' crop and constant paste): 2 for each multiply-add."""
    total = [0]

    def conv(m, inp, out):
        kh, kw = m.kernel_size
        total[0] += (2 * out.numel() * (m.in_channels // m.groups)
                     * kh * kw)

    def linear(m, inp, out):
        total[0] += 2 * out.numel() * m.in_features

    hooks = [m.register_forward_hook(conv) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    hooks += [m.register_forward_hook(linear) for m in model.modules()
              if isinstance(m, torch.nn.Linear)]

    def place(features, bbox, out_hw):
        # Wy (B,O,H,h) . f (B,O,C,h,w) -> (B,O,C,H,w); . Wx (B,O,W,w), sum O
        b, o, c, h, w = features.shape
        hh, ww = out_hw
        total[0] += 2 * b * o * c * hh * w * (h + ww)
        return plain_place(features, bbox, out_hw)

    def extract(image, bbox, out_hw):
        # Wy (B,O,H,h) . x (B,C,h,w) -> (B,O,C,H,w); . Wx (B,O,W,w)
        (b, c, h, w), o = image.shape, bbox.shape[1]
        hh, ww = out_hw
        total[0] += 2 * b * o * c * hh * w * (h + ww)
        return plain_extract(image, bbox, out_hw)

    def paste(labels, bbox, out_hw):
        # mask (B,O,H,W) . labels (B,O,C), summed over O
        b, o, c = labels.shape
        total[0] += 2 * b * o * c * out_hw[0] * out_hw[1]
        return plain_paste(labels, bbox, out_hw)

    plain_place = stn_place_cuda.stn_place_multi_plain
    plain_extract = pathways.stn_extract_multi_nchw
    plain_paste = pathways.stn_place_const_multi
    with monkeypatch.context() as m:
        m.setattr(stn_place_cuda, "stn_place_multi_plain", place)
        m.setattr(pathways, "stn_extract_multi_nchw", extract)
        m.setattr(pathways, "stn_place_const_multi", paste)
        try:
            run()
        finally:
            for h in hooks:
                h.remove()
    return total[0]


@pytest.mark.parametrize("cfg", [MNIST, CLEVR, COCO_S1],
                         ids=["mnist", "clevr", "coco-s1"])
def test_flop_count_against_the_shapes(cfg, monkeypatch):
    """The tool's FLOP count of a GF-8 G forward and a D forward at batch
    4 equals the count from the modules' conv and linear shapes and the
    STN products' shapes."""
    cfg = _small(cfg)
    g = build_stage1_g(cfg, seed=0, device="cpu").eval()
    d = build_stage1_d(cfg, seed=1, device="cpu").eval()
    gen = torch.Generator().manual_seed(0)
    z = torch.randn(4, cfg.z_dim, generator=gen)
    bbox = torch.rand(4, cfg.num_objects, 4, generator=gen) * 0.5
    labels = torch.eye(cfg.label_dim)[torch.randint(
        0, cfg.label_dim, (4, cfg.num_objects), generator=gen)]
    text = (torch.randn(4, cfg.text_dim, generator=gen) if cfg.use_ca
            else None)

    def forward():
        with torch.no_grad():
            img = g(z, bbox, labels, text)
            return d(img, labels, bbox)

    flops, nbytes = bv.count_step(forward)
    want = _shape_flops(torch.nn.ModuleList([g, d]), forward, monkeypatch)
    assert flops == want
    assert nbytes > 0


def _finite_line(line, keys, bs):
    assert set(line) == keys and line["batch"] == bs
    for k, v in line.items():
        if isinstance(v, float):
            assert math.isfinite(v) and v > 0, (k, v)


@pytest.mark.parametrize("name", ["mnist", "clevr", "stackgan1", "stage2",
                                  "attngan"])
def test_bench_variants_at_gf8_on_the_cpu(name):
    """Every variant's step at GF 8, batch 4, n 1: JAX's keys, finite
    positive numbers, the counts above zero and no device rate."""
    if name == "stage2":
        line = bv.bench_stage2("cpu", 1, _small(COCO_S1),
                               dataclasses.replace(COCO_S2, gf_dim=8,
                                                   df_dim=4), bs=4)
    elif name == "attngan":
        line = bv.bench_attngan("cpu", 1, SMALL_ATTN, bs=4)
    else:
        cfg = {"mnist": MNIST, "clevr": CLEVR, "stackgan1": COCO_S1}[name]
        line = bv._bench_stage1(_small(cfg), name, 4, "cpu", n=1)
    _finite_line(line, _jax_variant_keys(), 4)
    assert line["tflops_per_step"] > 0 and line["gbytes_per_step"] > 0
    assert (line["mfu"], line["hbm_util"], line["bound"]) == (None,) * 3
    # both rounded: img_per_sec to 0.1, step_ms to 0.01
    assert abs(line["img_per_sec"] - 4e3 / line["step_ms"]) <= (
        0.05 + 4e3 * 0.005 / line["step_ms"] ** 2 + 1e-9)


@pytest.mark.parametrize("name", ["mnist", "clevr", "stackgan1",
                                  "attngan"])
def test_bench_sampling_at_gf8_on_the_cpu(name):
    if name == "attngan":
        line = bsm.bench_attngan(True, 4, "cpu", 1, SMALL_ATTN)
        assert line["variant"] == "attngan256"
    else:
        cfg_file, variant, bs = bsm.VARIANTS[name]
        assert bs == 128
        mcfg = _small(stage1_model_config(cfg_from_file(cfg_file, variant),
                                          variant))
        line = bsm.bench_variant(name, True, "cpu", n=1, mcfg=mcfg, bs=4)
    _finite_line(line, _jax_sampling_keys()[0], 4)
    assert line["bf16"] is True


@pytest.mark.parametrize("value, bf16", [
    (None, True), ("", True), ("bf16", True), ("bfloat16", True),
    ("f32", False), ("FLOAT32", False), ("float32", False), ("fp16", True)])
def test_bench_variants_dtype_rule(monkeypatch, value, bf16):
    """bf16 unless MOG_COMPUTE_DTYPE is f32 or float32 (JAX
    tools/bench_variants.py:235)."""
    if value is not None:
        monkeypatch.setenv("MOG_COMPUTE_DTYPE", value)
    assert bv.compute_dtype() == (torch.bfloat16 if bf16 else None)


@pytest.mark.parametrize("value, want", [(None, torch.bfloat16),
                                         ("f32", None)])
def test_bench_variants_builds_the_step_so(monkeypatch, value, want):
    """The step is built in the tool's dtype, with MOG_BN_GROUPS' groups."""
    if value is not None:
        monkeypatch.setenv("MOG_COMPUTE_DTYPE", value)
    monkeypatch.setenv("MOG_BN_GROUPS", "2")
    built = []
    real = bv.make_train_step

    def spy(cfg, *a, **k):
        built.append(cfg)
        return real(cfg, *a, **k)

    monkeypatch.setattr(bv, "make_train_step", spy)
    bv._bench_stage1(_small(MNIST), "multi-mnist", 4, "cpu", n=1)
    assert [(c.compute_dtype, c.bn_groups) for c in built] == [(want, 2)]


@pytest.mark.parametrize("argv, env, bf16", [
    ([], None, True), (["--f32"], None, False),
    ([], "float32", True), (["--f32"], "bfloat16", False)])
def test_bench_sampling_dtype_rule(monkeypatch, argv, env, bf16):
    """bf16 unless --f32; MOG_COMPUTE_DTYPE is not read (JAX
    tools/bench_sampling.py:144). Without names it runs mnist."""
    if env is not None:
        monkeypatch.setenv("MOG_COMPUTE_DTYPE", env)
    calls = []
    monkeypatch.setattr(bsm, "bench_variant", lambda name, b, device:
                        calls.append((name, b)) or {"variant": name})
    monkeypatch.setattr(bsm, "bench_attngan", lambda b, device:
                        calls.append(("attngan", b)) or {"variant": "a"})
    bsm.main([*argv, "--device", "cpu"])
    bsm.main(["clevr", "attngan", *argv, "--device", "cpu"])
    assert calls == [("mnist", bf16), ("clevr", bf16), ("attngan", bf16)]
