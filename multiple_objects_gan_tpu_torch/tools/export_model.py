"""Export a stage-1 generator's inference function as a ``torch.export``
program (``.pt2``): the port's counterpart of the JAX package's
``tools/export_model.py``, which writes a StableHLO artifact by
``jax.export``.

    python -m multiple_objects_gan_tpu_torch.tools.export_model \\
        [--variant mnist|clevr|coco-stackgan] [--batch N] \\
        [--net_g PATH.pth | RUN_DIR] [--out FILE] [--device cuda|cpu]

As the JAX tool: the eval-mode Stage1G of the variant (``models/common.py``
widths) at a fixed ``--batch``, over (z, bbox, labels) and, for
coco-stackgan, the text embedding, with no CA noise (c = mu, as JAX's
``ca_rng=None``); its weights from ``--net_g`` (a reference ``.pth``
through ``io/weights.py:load_reference_g``, or a port run directory's
latest checkpoint), the reference's random init from seed 0 without it,
and a ``--net_g`` that does not exist refused. The compute dtype is
``MOG_COMPUTE_DTYPE``'s (``nn/blocks.py:env_compute_dtype``), as in every
port entry. The tool writes ``<variant>_g.pt2`` (or ``--out``), loads it
back with ``torch.export.load``, calls it once on a seeded layout and
prints the output's shape and dtype beside the eager G's largest
difference. It runs on the card unless ``--device cpu``.

The place goes into the program as the operator ``mog::stn_place_multi``
(``ops/stn_place_cuda.py``), so a loaded program launches K1 on the card
and runs its plain version on the CPU. Load a program after importing
``multiple_objects_gan_tpu_torch.ops``, which registers ``mog::``::

    import torch
    import multiple_objects_gan_tpu_torch.ops  # noqa: F401
    g = torch.export.load("mnist_g.pt2").module()
    with torch.no_grad():
        img = g(z, bbox, labels)      # coco-stackgan: g(z, bbox, labels, text)
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional

import numpy as np
import torch

from multiple_objects_gan_tpu_torch import float32_policy, resolve_device
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.io.weights import load_reference_g
from multiple_objects_gan_tpu_torch.models.common import (
    CLEVR, COCO_S1, MNIST, Stage1Config)
from multiple_objects_gan_tpu_torch.models.stage1 import (
    Stage1G, build_stage1_g)
from multiple_objects_gan_tpu_torch.nn.blocks import env_compute_dtype
from multiple_objects_gan_tpu_torch.ops import stn_place_cuda
from multiple_objects_gan_tpu_torch.tools.export_checkpoint import (
    _models_dir)

# the JAX tool's variants (tools/export_model.py:45)
VARIANTS = {"mnist": MNIST, "clevr": CLEVR, "coco-stackgan": COCO_S1}


def model_config(variant: str,
                 compute_dtype: Optional[torch.dtype] = None) -> Stage1Config:
    return dataclasses.replace(VARIANTS[variant], compute_dtype=compute_dtype)


def load_weights(net_g: str) -> Optional[dict]:
    """G's state dict from ``net_g``: a reference ``.pth`` (or a bare state
    dict), or a port run directory (its ``models/`` directory or the run)
    whose latest checkpoint is read; None for ""."""
    if not net_g:
        return None
    if not os.path.exists(net_g):
        sys.exit(f"--net_g {net_g!r} not found; refusing to export "
                 "randomly initialized weights")
    if os.path.isfile(net_g):
        return load_reference_g(net_g)
    ckpt, _ = CheckpointManager(_models_dir(net_g)).load()
    return ckpt["g"]


def build_g(cfg: Stage1Config, state_dict: Optional[dict],
            device) -> Stage1G:
    """The eval-mode G on ``device``, its parameters frozen: a program
    exported from it computes no gradient."""
    return build_stage1_g(cfg, state_dict, seed=0,
                          device=device).requires_grad_(False)


def example_inputs(cfg: Stage1Config, batch: int, device,
                   seed: int = 0) -> tuple:
    """(z, bbox, labels[, text]) of a seeded layout: boxes 0.2-0.4 wide
    inside the canvas, one label an object, the last object of the last
    item padded (-1, no label)."""
    rs = np.random.RandomState(seed)
    o = cfg.num_objects
    z = rs.randn(batch, cfg.z_dim).astype(np.float32)
    wh = rs.uniform(0.2, 0.4, (batch, o, 2))
    xy = rs.uniform(0.0, 1.0, (batch, o, 2)) * (1.0 - wh)
    bbox = np.concatenate([xy, wh], -1).astype(np.float32)
    labels = np.zeros((batch, o, cfg.label_dim), np.float32)
    labels[np.arange(batch)[:, None], np.arange(o)[None, :],
           rs.randint(0, cfg.label_dim, (batch, o))] = 1.0
    bbox[-1, -1] = -1.0
    labels[-1, -1] = 0.0
    arrays = [z, bbox, labels]
    if cfg.use_ca:
        arrays.append(rs.randn(batch, cfg.text_dim).astype(np.float32))
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def place_nodes(program: torch.export.ExportedProgram) -> tuple[int, int]:
    """(calls of ``mog::stn_place_multi``, einsums of the plain K1's
    equations) in the program's graph."""
    calls = [n for n in program.graph.nodes if n.op == "call_function"]
    ops = sum(n.target == stn_place_cuda.PLACE_OP for n in calls)
    einsums = sum(n.target == torch.ops.aten.einsum.default
                  and n.args[0] in stn_place_cuda.PLACE_EQUATIONS
                  for n in calls)
    return ops, einsums


def call_program(module: torch.nn.Module, inputs: tuple) -> torch.Tensor:
    with torch.no_grad():
        return module(*inputs)


def export_model(variant: str = "mnist", batch: int = 8, net_g: str = "",
                 out: str = "", device="cuda") -> dict:
    """The tool's work: export, save, load and call once. Returns the
    loaded program, the eager G and its output on the program's inputs,
    the inputs, the graph's place counts (:func:`place_nodes`) and G's
    parameter count."""
    device = resolve_device(device)
    dtype = env_compute_dtype()
    float32_policy(device, dtype)
    cfg = model_config(variant, dtype)
    state_dict = load_weights(net_g)
    if state_dict is not None:
        print(f"loaded G weights from {net_g}", flush=True)
    g = build_g(cfg, state_dict, device)
    inputs = example_inputs(cfg, batch, device)
    program = torch.export.export(g, inputs, strict=False)
    path = out or f"{variant}_g.pt2"
    torch.export.save(program, path)
    n_params = sum(p.numel() for p in g.parameters())
    print(f"exported {variant} G ({n_params / 1e6:.1f}M params, batch "
          f"{batch}, {'bf16' if dtype else 'float32'}) -> {path} "
          f"({os.path.getsize(path) >> 10} KiB, device {device})",
          flush=True)
    module = torch.export.load(path).module()   # mog:: is registered
    img = call_program(module, inputs)
    want = call_program(g, inputs)
    err = (img.float() - want.float()).abs().max().item()
    print(f"round-trip call OK: {tuple(img.shape)} {img.dtype}; max "
          f"|program - eager G| {err:.3g}", flush=True)
    return {"module": module, "g": g, "eager": want, "inputs": inputs,
            "places": place_nodes(program), "n_params": n_params}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variant", default="mnist", choices=sorted(VARIANTS))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--net_g", default="",
                   help="reference .pth or a port run directory")
    p.add_argument("--out", default="",
                   help="output path (default <variant>_g.pt2)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    export_model(args.variant, args.batch, args.net_g, args.out, args.device)


if __name__ == "__main__":
    main()
