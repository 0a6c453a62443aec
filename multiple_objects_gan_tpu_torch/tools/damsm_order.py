"""The DAMSM train step's time with its two encoders called in either order.

    python -m multiple_objects_gan_tpu_torch.tools.damsm_order [--rounds 4]

The step (``train/damsm_step.py``) runs the text encoder, whose
``pack_padded_sequence`` reads the caption lengths on the host (one sync a
step), and the image encoder's Inception-v3 backbone. Called first, the
text encoder's sync waits for the previous step only; called after the
image encoder, it waits for the queued backbone, and the device then idles
while the host queues the rest of the step. This script times the step
with the text encoder first (``text_first``) and with the image encoder
first (``image_first``), ``damsm_step.damsm_losses`` set to each order in
turn, at cfg/coco_damsm.yml's batch 48 and 256px, float32 (TF32 off) and
bf16. The orders alternate A B B A in every round, ``--steps`` steps a
turn, each step between CUDA events as ``chip_smoke.py`` phase 38 times
it; then ``torch.profiler`` traces 3 steps of each order for the device's
busy share. The encoders are random from seed 0 (the flagship's 140-word
vocabulary) and the inputs random from seed 38: the work does not depend
on the values. The last line is one JSON object of the readings. It needs
a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from multiple_objects_gan_tpu_torch import float32_policy, resolve_device
from multiple_objects_gan_tpu_torch.losses.damsm import sent_loss, words_loss
from multiple_objects_gan_tpu_torch.nn.encoders import (
    build_image_encoder, build_text_encoder)
from multiple_objects_gan_tpu_torch.tools.profile_step import kernel_times
from multiple_objects_gan_tpu_torch.train import damsm_step
from multiple_objects_gan_tpu_torch.train.state import create_damsm_state

BATCH = 48          # cfg/coco_damsm.yml TRAIN.BATCH_SIZE
SIZE = 256          # its BASE_SIZE, BRANCH_NUM 1
WORDS_NUM = 12      # its TEXT.WORDS_NUM
N_WORDS = 140       # the flagship text encoder's vocabulary
NEF = 256           # its TEXT.EMBEDDING_DIM
SMOOTH = {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0}
LR = 0.002          # its TRAIN.ENCODER_LR


def losses_in_order(text_first: bool):
    """``damsm_losses`` with the encoders called in the given order; the
    same numbers either way."""
    def losses(state, batch, sm, keep=None, generator=None):
        captions, cap_lens = batch["captions"], batch["cap_lens"]
        if not text_first:
            region, code = state.image(damsm_step.top_image(batch))
        words, sent = state.text(captions, cap_lens, keep=keep,
                                 generator=generator)
        if text_first:
            region, code = state.image(damsm_step.top_image(batch))
        class_ids = batch.get("class_ids")
        w0, w1, _ = words_loss(region, words, cap_lens, class_ids,
                               sm["GAMMA1"], sm["GAMMA2"], sm["GAMMA3"])
        s0, s1 = sent_loss(code, sent, class_ids, sm["GAMMA3"])
        return {"w_loss": w0 + w1, "s_loss": s0 + s1,
                "damsm_loss": w0 + w1 + s0 + s1}
    return losses


ORDERS = {"text_first": losses_in_order(True),
          "image_first": losses_in_order(False)}


def random_batch(dev) -> dict:
    rs = np.random.RandomState(38)
    lens = rs.randint(1, WORDS_NUM + 1, size=BATCH)
    caps = rs.randint(1, N_WORDS, size=(BATCH, WORDS_NUM))
    caps[np.arange(WORDS_NUM)[None] >= lens[:, None]] = 0
    batch = {"image256": rs.randint(0, 256, (BATCH, SIZE, SIZE, 3),
                                    dtype=np.uint8),
             "captions": caps.astype(np.int64),
             "cap_lens": lens.astype(np.int64),
             "class_ids": np.arange(BATCH, dtype=np.int64)}
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def timed_steps(one, n: int) -> list[float]:
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        one()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def busy_share(one, n: int = 3) -> tuple[float, float]:
    """(host ms a step, device-busy ms a step) over ``n`` traced steps."""
    one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            one()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    return wall, sum(kernel_times(prof).values()) / n


def measure(dev, dtype, rounds: int, steps: int) -> dict:
    state = create_damsm_state(
        build_text_encoder(N_WORDS, NEF, seed=0, device=dev),
        build_image_encoder(NEF, seed=0, compute_dtype=dtype, device=dev))
    step = damsm_step.make_damsm_train_step(SMOOTH, 0.25)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = random_batch(dev)
    shipped = damsm_step.damsm_losses
    times = {k: [] for k in ORDERS}
    traced = {}
    try:
        def one():
            return step(state, batch, gen, LR)

        for name in ORDERS:
            damsm_step.damsm_losses = ORDERS[name]
            for _ in range(3):
                one()
        for _ in range(rounds):
            for name in ("text_first", "image_first", "image_first",
                         "text_first"):
                damsm_step.damsm_losses = ORDERS[name]
                times[name] += timed_steps(one, steps)
        for name in ORDERS:
            damsm_step.damsm_losses = ORDERS[name]
            traced[name] = busy_share(one)
    finally:
        damsm_step.damsm_losses = shipped
    out = {}
    for name, ts in times.items():
        wall, busy = traced[name]
        out[name] = {"median_ms": statistics.median(ts), "min_ms": min(ts),
                     "max_ms": max(ts), "steps": len(ts),
                     "traced_wall_ms": wall, "traced_busy_ms": busy,
                     "busy_share": busy / wall}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--steps", type=int, default=10,
                   help="steps a turn of one order")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    result = {"card": card, "batch": BATCH, "rounds": args.rounds}
    for kind, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        float32_policy(dev, dtype)
        result[kind] = measure(dev, dtype, args.rounds, args.steps)
        for name, r in result[kind].items():
            print(f"DAMSM step, batch {BATCH}, {kind}, {name}: median "
                  f"{r['median_ms']:.2f} ms of {r['steps']} (min "
                  f"{r['min_ms']:.2f}, max {r['max_ms']:.2f}); traced "
                  f"{r['traced_wall_ms']:.2f} ms a step, the device busy "
                  f"{r['traced_busy_ms']:.2f} ms ({r['busy_share']:.1%})",
                  flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
