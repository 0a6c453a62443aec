"""Per-variant training-step throughput on the card, with its roofline
(the port's counterpart of the JAX package's ``tools/bench_variants.py``).

    python -m multiple_objects_gan_tpu_torch.tools.bench_variants \\
        [mnist|clevr|stackgan1|stage2|attngan ...] [--device cuda|cpu]

Prints one JSON line per variant (all five without names) at the
reference batches, with the JAX tool's keys: {"variant", "batch",
"step_ms", "img_per_sec", "tflops_per_step", "gbytes_per_step", "mfu",
"hbm_util", "bound"}. The steps are the port's own: the stage-1 families
at batch 128 through ``train/step.py:make_train_step`` (the presets
``MNIST``, ``CLEVR``, ``COCO_S1``, seed 0, ``data/synthetic.py``'s batch),
stage 2 at batch 40 through ``make_stage2_train_step`` (a seeded frozen
stage-1 G; random 256px images, every box [0.2, 0.2, 0.3, 0.3], 81-class
labels and text embeddings from ``np.random.RandomState(0)``), and
AttnGAN through ``train/attngan_step.py:make_attngan_train_step`` at the
tool's own widths (GF 48, DF 96, 3 branches, R_NUM 2, a 100-word
vocabulary, captions of 12, batch 14 or ``MOG_ATTNGAN_BS``). The run is
bf16 unless ``MOG_COMPUTE_DTYPE`` is ``f32`` or ``float32``, as the JAX
tool decides; float32 runs with TF32 off (``float32_policy``).
``MOG_BN_GROUPS`` sets the BatchNorm groups, as it does the JAX package's.

Timing is the JAX tool's ``_sync_time``: 2 warm-up steps, a host sync,
then ``n`` steps and one host sync after the last (``.item()`` of a
loss), on the host clock.

The roofline is the card's: ``mfu`` is FLOP/s over the H100's dense peak
for the compute dtype (989 TFLOP/s bf16; 67 TFLOP/s float32 outside the
tensor cores, since TF32 is off), ``hbm_util`` bytes/s over 3.35 TB/s,
and ``bound`` "hbm" where ``hbm_util`` is the larger, else "mxu" (the JAX
tool's word for the compute roof). Both counts come from one extra step:
FLOPs from ``torch.utils.flop_counter.FlopCounterMode``, which counts
convolutions and matrix products only (XLA's ``cost_analysis`` counts
elementwise work too); bytes from :class:`ByteCounter`, the tensor inputs
and outputs of every ATen op that is not a view, summed: the eager
program's traffic at op boundaries, not XLA's "bytes accessed" of fused
code. The CUDA kernels K1 and K2 are not ATen ops and count in neither;
on the CPU their plain versions are einsums and count in both. With
``--device cpu`` the counts are printed and ``mfu``, ``hbm_util`` and
``bound`` are null: no device rate is measured there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from multiple_objects_gan_tpu_torch import float32_policy, resolve_device
from multiple_objects_gan_tpu_torch.data.synthetic import synthetic_batch
from multiple_objects_gan_tpu_torch.models.attngan import COCO_ATTN
from multiple_objects_gan_tpu_torch.models.common import (
    CLEVR, COCO_S1, COCO_S2, MNIST, Stage1Config)
from multiple_objects_gan_tpu_torch.models.stage1 import build_stage1_g
from multiple_objects_gan_tpu_torch.nn.blocks import env_bn_groups
from multiple_objects_gan_tpu_torch.nn.encoders import (
    build_image_encoder, build_text_encoder)
from multiple_objects_gan_tpu_torch.tools.spike_normconv import (
    BF16_OPS_PER_S, HBM_BYTES_PER_S)
from multiple_objects_gan_tpu_torch.train.attngan_step import (
    make_attngan_train_step)
from multiple_objects_gan_tpu_torch.train.state import (
    create_attngan_state, create_state, create_state_stage2)
from multiple_objects_gan_tpu_torch.train.step import (
    make_stage2_train_step, make_train_step)

F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
WARMUP = 2                  # untimed steps before the timed ones
STEPS = 20                  # timed steps (the JAX tool's n)
LR = 2e-4
STAGE1_BATCH = 128          # cfg/{mnist,clevr,coco_s1}_train.yml
STAGE2_BATCH = 40           # cfg/coco_s2_train.yml TRAIN.BATCH_SIZE
ATTN_BATCH = 14             # cfg/coco_attn_train.yml; MOG_ATTNGAN_BS
ATTN_SEQ = 12
ATTN_VOCAB = 100
# the JAX tool's AttnGAN: the flagship's widths with R_NUM 2
ATTN_BENCH = dataclasses.replace(COCO_ATTN, gf_dim=48, df_dim=96,
                                 branch_num=3, r_num=2)
ATTN_SMOOTH = {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0, "LAMBDA": 50.0}
BOX = [0.2, 0.2, 0.3, 0.3]  # every object's box in the stage-2/AttnGAN batch


def compute_dtype() -> Optional[torch.dtype]:
    """The JAX tool's rule (tools/bench_variants.py:235): bf16 unless
    ``MOG_COMPUTE_DTYPE`` is f32 or float32, in any case."""
    value = os.environ.get("MOG_COMPUTE_DTYPE", "").lower()
    return None if value in ("f32", "float32") else torch.bfloat16


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of the tensor inputs and outputs of every ATen op
    that runs inside it, views left out (module docstring)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def count_step(step: Callable) -> tuple[float, int]:
    """(FLOPs, bytes) of one call of ``step()``: FlopCounterMode's count
    and :class:`ByteCounter`'s."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
        step()
    return float(flops.get_total_flops()), nbytes.bytes


def _sync(out, key: Optional[str] = None) -> None:
    """The host waits for ``out``: a metrics dict (its ``key``, else its
    first key in order) or a tensor, read with ``.item()``."""
    if isinstance(out, dict):
        out = out[key or sorted(out)[0]]
    out.reshape(-1)[0].item()


def sync_time(step: Callable, n: int = STEPS, warmup: int = WARMUP,
              sync_key: Optional[str] = None) -> float:
    """Seconds a call of ``step()``: ``warmup`` calls and a sync, then
    ``n`` calls and one sync after the last, on the host clock (the JAX
    tool's ``_sync_time``)."""
    for _ in range(warmup):
        out = step()
    _sync(out, sync_key)
    t0 = time.perf_counter()
    for _ in range(n):
        out = step()
    _sync(out, sync_key)
    return (time.perf_counter() - t0) / n


def roofline(result: dict, flops: float, nbytes: float, dt: float,
             dtype: Optional[torch.dtype], device: torch.device) -> dict:
    """``result`` with the JAX tool's roofline keys for a step of ``dt``
    seconds: TFLOP and GB a step, and on the card ``mfu``, ``hbm_util``
    and ``bound`` against the H100's peaks (null elsewhere)."""
    result.update({"tflops_per_step": round(flops / 1e12, 4),
                   "gbytes_per_step": round(nbytes / 1e9, 3),
                   "mfu": None, "hbm_util": None, "bound": None})
    if device.type == "cuda":
        peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
        mfu = flops / dt / peak
        hbm = nbytes / dt / HBM_BYTES_PER_S
        result.update({"mfu": round(mfu, 4), "hbm_util": round(hbm, 4),
                       "bound": "hbm" if hbm > mfu else "mxu"})
    return result


def _measure(name: str, bs: int, step: Callable, n: int, dtype,
             device: torch.device, sync_key: Optional[str] = None) -> dict:
    """One counted step, then :func:`sync_time`; the JSON line."""
    flops, nbytes = count_step(step)
    dt = sync_time(step, n=n, sync_key=sync_key)
    return roofline({"variant": name, "batch": bs,
                     "step_ms": round(dt * 1000, 2),
                     "img_per_sec": round(bs / dt, 1)},
                    flops, nbytes, dt, dtype, device)


def _on(device, batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _knobs(cfg, dtype):
    return dataclasses.replace(cfg, compute_dtype=dtype,
                               bn_groups=env_bn_groups())


def _bench_stage1(cfg: Stage1Config, name: str, bs: int = STAGE1_BATCH,
                  device="cuda", n: int = STEPS) -> dict:
    """A stage-1 family's train step at batch ``bs`` (``cfg`` a preset)."""
    dev = resolve_device(device)
    dtype = compute_dtype()
    float32_policy(dev, dtype)
    cfg = _knobs(cfg, dtype)
    state = create_state(cfg, seed=0, device=dev)
    batch = _on(dev, synthetic_batch(cfg, bs))
    step = make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    return _measure(name, bs, lambda: step(state, batch, gen, LR, LR), n,
                    dtype, dev, sync_key="d_loss")


def bench_mnist(device="cuda", n: int = STEPS) -> dict:
    return _bench_stage1(MNIST, "multi-mnist", device=device, n=n)


def bench_clevr(device="cuda", n: int = STEPS) -> dict:
    # cfg/clevr_train.yml: batch 128, 4 objects, label embedding
    return _bench_stage1(CLEVR, "clevr", device=device, n=n)


def bench_stackgan1(device="cuda", n: int = STEPS) -> dict:
    # cfg/coco_s1_train.yml: batch 128, CA + 81-class labels
    return _bench_stage1(COCO_S1, "coco-stackgan-1", device=device, n=n)


def stage2_batch(s1_cfg: Stage1Config, bs: int, dev) -> dict:
    """The JAX tool's stage-2 batch from ``RandomState(0)``."""
    rs = np.random.RandomState(0)
    boxes = np.tile(BOX, (bs, 3, 1)).astype(np.float32)
    return _on(dev, {
        "image": rs.rand(bs, 256, 256, 3).astype(np.float32) * 2 - 1,
        "bbox": boxes, "bbox_s2": boxes,
        "label_onehot": np.eye(81, dtype=np.float32)[
            rs.randint(0, 81, (bs, 3))],
        "text_embedding": rs.randn(bs, s1_cfg.text_dim).astype(np.float32)})


def bench_stage2(device="cuda", n: int = STEPS, s1_cfg=COCO_S1,
                 s2_cfg=COCO_S2, bs: int = STAGE2_BATCH) -> dict:
    """The stage-2 step at batch ``bs`` with a seeded frozen stage-1 G."""
    dev = resolve_device(device)
    dtype = compute_dtype()
    float32_policy(dev, dtype)
    s1_cfg, s2_cfg = _knobs(s1_cfg, dtype), _knobs(s2_cfg, dtype)
    g1 = build_stage1_g(s1_cfg, seed=0, device=dev)
    state = create_state_stage2(s2_cfg, seed=0, device=dev)
    step = make_stage2_train_step(s2_cfg, s1_cfg, g1)
    batch = stage2_batch(s1_cfg, bs, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    return _measure("coco-stackgan-2", bs,
                    lambda: step(state, batch, gen, LR, LR), n, dtype, dev)


def attngan_batch(mcfg, bs: int, dev, seq: int = ATTN_SEQ) -> dict:
    """The JAX tool's AttnGAN batch from ``RandomState(0)``."""
    rs = np.random.RandomState(0)
    batch = {f"image{s}": rs.rand(bs, s, s, 3).astype(np.float32) * 2 - 1
             for s in (64, 128, 256)}
    batch.update({
        "bbox": np.tile(BOX, (bs, 3, 1)).astype(np.float32),
        "label_onehot": np.eye(mcfg.label_dim, dtype=np.float32)[
            rs.randint(0, mcfg.label_dim, (bs, 3))],
        "captions": rs.randint(1, ATTN_VOCAB, (bs, seq)).astype(np.int64),
        "cap_lens": np.full((bs,), seq, np.int64),
        "class_ids": np.arange(bs, dtype=np.int64)})
    return _on(dev, batch)


def bench_attngan(device="cuda", n: int = STEPS, mcfg=ATTN_BENCH,
                  bs: Optional[int] = None) -> dict:
    """The AttnGAN step at the tool's widths, seeded G, Ds and encoders."""
    dev = resolve_device(device)
    dtype = compute_dtype()
    float32_policy(dev, dtype)
    mcfg = _knobs(mcfg, dtype)
    bs = bs or int(os.environ.get("MOG_ATTNGAN_BS", ATTN_BATCH))
    state = create_attngan_state(mcfg, seed=0, device=dev)
    text = build_text_encoder(ATTN_VOCAB, mcfg.embedding_dim, seed=0,
                              device=dev)
    image = build_image_encoder(mcfg.embedding_dim, seed=0,
                                compute_dtype=dtype, device=dev)
    step = make_attngan_train_step(mcfg, text, image, smooth=ATTN_SMOOTH)
    batch = attngan_batch(mcfg, bs, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    return _measure("coco-attngan", bs,
                    lambda: step(state, batch, gen, LR, LR), n, dtype, dev,
                    sync_key="d_loss_d64")


BENCHES = {"mnist": bench_mnist, "clevr": bench_clevr,
           "stackgan1": bench_stackgan1, "stage2": bench_stage2,
           "attngan": bench_attngan}


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("names", nargs="*", metavar="VARIANT",
                   help=f"of {list(BENCHES)} (default: all)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    unknown = sorted(set(args.names) - set(BENCHES))
    if unknown:
        p.error(f"unknown variants {unknown}; of {list(BENCHES)}")
    dev = resolve_device(args.device)
    kind = "bf16" if compute_dtype() == torch.bfloat16 else "float32"
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the CPU")
    print(f"bench_variants: {kind} on {where}", file=sys.stderr, flush=True)
    lines = []
    for name in args.names or list(BENCHES):
        lines.append(BENCHES[name](device=args.device))
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
