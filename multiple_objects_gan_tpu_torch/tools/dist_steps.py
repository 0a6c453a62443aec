"""Run train steps, or any function, as the ranks of a process group, and
write what each rank did: the check of the port's data-parallel layer
(``parallel/``) against one process running the same global batch.

    python -m multiple_objects_gan_tpu_torch.tools.dist_steps \\
        --cases CASES.pth --out DIR [--device cuda|cpu]

run as every rank of a group (``MOG_COORDINATOR`` ... or torchrun's
environment; :func:`spawn` starts them), or alone as world size 1.
``CASES.pth`` (``torch.save``) is a list of cases, run in order:

* a step case, ``{"name", "kind": "stage1" | "stage2" | "attngan" |
  "damsm", "state": a train state on the CPU (``train/state.py``),
  "batch": the GLOBAL batch (CPU tensors), "seed": the step generator's
  seed, "lr", ...}``: the state goes to the rank's device and is
  replicated from rank 0, the rank keeps its contiguous slice of the
  batch, and one step runs from the generator (or from a case's global
  noise, ``"z"``, ``"eps"``, ``"eps1"``, ``"eps2"``, of which the rank
  takes its rows). Per kind: ``"config"`` (``Stage1Config``, stage 2's
  for ``"stage2"``, ``AttnGanConfig``; its ``bn_groups`` any count that
  divides the global batch, a group spanning ranks where the world size
  does not divide it), ``"kl_coeff"``, ``"s1_config"`` and ``"g1"``
  (stage 2's frozen stage-1 G: its config and state dict, built on the
  rank's device), ``"encoders"`` (AttnGAN's frozen text and image
  encoders, modules), ``"smooth"``, ``"grad_clip"``. A float32
  case turns TF32 off on the card (``float32_policy``). With
  ``"time_runs"`` n the step then runs n more times, each between
  synchronisations, for its time and its gradient all-reduce's;
* a call case, ``{"name", "call": "package.module:function", "kwargs"}``:
  the function runs on every rank (its own collectives included); its
  return value (``value``), the rank's K1 and K2 launches in it and its
  host seconds are kept.

Each rank writes ``DIR/rank<r>.pth``: ``{"world", "rank", "backend",
"device", "results": {name: ...}}``; a step case's result holds the
summed losses (``metrics``), the state after the step
(``checkpoint_dict``, on the CPU), the rank's K1 and K2 launches in the
step, and, when timed, the step and all-reduce milliseconds. Cases are
unpickled whole (``torch.load(weights_only=False)``): write them only from
code you trust.
"""

from __future__ import annotations

import argparse
import importlib
import os
import socket
import subprocess
import sys
import time
from typing import Optional

import torch

from multiple_objects_gan_tpu_torch import float32_policy, resolve_device
from multiple_objects_gan_tpu_torch.ops import stn_place_cuda
from multiple_objects_gan_tpu_torch.parallel import mesh
from multiple_objects_gan_tpu_torch.parallel.multihost import (
    backend, destroy_distributed, maybe_initialize_distributed, rank,
    rank_device, world_size)
from multiple_objects_gan_tpu_torch.train.loop import to_device

ENV_KEYS = ("MOG_COORDINATOR", "MOG_NUM_PROCESSES", "MOG_PROCESS_ID")
NOISE_KEYS = ("z", "eps", "eps1", "eps2")   # a step case's global noise


def _to_device_(state, device: torch.device) -> None:
    """Every module of ``state`` on ``device``, and every optimizer's
    state with its parameters (Adam's ``load_state_dict`` moves it)."""
    for value in vars(state).values():
        for v in (value.values() if isinstance(value, dict) else [value]):
            if isinstance(v, torch.nn.Module):
                v.to(device)
            elif isinstance(v, torch.Tensor):
                v.data = v.data.to(device)
    for value in vars(state).values():
        for v in (value.values() if isinstance(value, dict) else [value]):
            if isinstance(v, torch.optim.Optimizer):
                v.load_state_dict(v.state_dict())


def _step_fn(case: dict, device: torch.device):
    kind = case["kind"]
    if kind == "stage1":
        from multiple_objects_gan_tpu_torch.train.step import make_train_step
        return make_train_step(case["config"], case.get("kl_coeff", 2.0))
    if kind == "stage2":
        from multiple_objects_gan_tpu_torch.models.stage1 import (
            build_stage1_g)
        from multiple_objects_gan_tpu_torch.train.step import (
            make_stage2_train_step)
        g1 = build_stage1_g(case["s1_config"], case["g1"], device=device)
        return make_stage2_train_step(case["config"], case["s1_config"],
                                      g1.requires_grad_(False),
                                      case.get("kl_coeff", 2.0))
    if kind == "attngan":
        from multiple_objects_gan_tpu_torch.train.attngan_step import (
            make_attngan_train_step)
        text, image = case["encoders"]
        return make_attngan_train_step(case["config"], text, image,
                                       smooth=case.get("smooth"))
    if kind == "damsm":
        from multiple_objects_gan_tpu_torch.train.damsm_step import (
            make_damsm_train_step)
        return make_damsm_train_step(case.get("smooth"),
                                     case.get("grad_clip", 0.25))
    raise ValueError(f"unknown step kind {kind!r}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cpu(x):
    """A copy of ``x`` on the CPU (the state goes on stepping)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu(v) for v in x)
    return x


def run_step_case(case: dict, device) -> dict:
    """One step case on this rank (module docstring)."""
    device = torch.device(device)
    # float32 computes in float32 on the card (TF32 off), as the train
    # entries set it
    float32_policy(device, getattr(case.get("config"), "compute_dtype",
                                   None))
    state = case["state"]
    _to_device_(state, device)
    for enc in case.get("encoders") or ():
        enc.to(device)
    mesh.replicate_state(state)
    step = _step_fn(case, device)
    batch = to_device(mesh.shard_batch(case["batch"]), device)
    gen = torch.Generator(device=device).manual_seed(int(case["seed"]))
    kwargs = {k: case[k][mesh.rank_rows(case[k].shape[0])].to(device)
              for k in NOISE_KEYS if case.get(k) is not None}
    lr = float(case["lr"])
    stn_place_cuda.reset_launch_count()
    metrics = step(state, batch, gen, lr, lr, **kwargs)
    _sync(device)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "launches": (stn_place_cuda.launch_count(),
                        stn_place_cuda.grad_launch_count()),
           "state": _cpu(state.checkpoint_dict())}
    runs = int(case.get("time_runs", 0))
    if runs:
        mesh.TIMING = True
        mesh.ALLREDUCE.update(calls=0, seconds=0.0)
        times = []
        try:
            for _ in range(runs):
                _sync(device)
                t0 = time.perf_counter()
                step(state, batch, gen, lr, lr)
                _sync(device)
                times.append((time.perf_counter() - t0) * 1e3)
        finally:
            mesh.TIMING = False
        out.update(step_ms=times,
                   allreduce_ms=mesh.ALLREDUCE["seconds"] * 1e3 / runs,
                   allreduce_calls=mesh.ALLREDUCE["calls"] / runs)
    return out


def run_call_case(case: dict, device) -> dict:
    """One call case on this rank: its return value, the rank's K1 and K2
    launches in it and its host seconds."""
    module, fn = case["call"].split(":")
    stn_place_cuda.reset_launch_count()
    t0 = time.perf_counter()
    value = getattr(importlib.import_module(module), fn)(
        **case.get("kwargs", {}))
    _sync(torch.device(device))
    return {"value": value, "seconds": time.perf_counter() - t0,
            "launches": (stn_place_cuda.launch_count(),
                         stn_place_cuda.grad_launch_count())}


def run_cases(cases: list, device) -> dict:
    """Every case on this rank, in order: {name: result}."""
    return {c["name"]: (run_call_case(c, device) if "call" in c
                        else run_step_case(c, device)) for c in cases}


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(cases_path: str, out_dir: str, world: int = 2, device="cuda",
          timeout: float = 600.0, extra_path: tuple = (),
          env: Optional[dict] = None) -> list[dict]:
    """Run ``cases_path`` as ``world`` ranks of one group on localhost and
    return each rank's record (``rank<r>.pth``), rank order. A rank that
    fails, or a run past ``timeout`` seconds, raises with every rank's
    output; every process is stopped before this returns."""
    port = free_port()
    base = {k: v for k, v in (env or os.environ).items()
            if k not in ENV_KEYS}
    base["PYTHONPATH"] = os.pathsep.join(
        [*extra_path, os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
         base.get("PYTHONPATH", "")])
    procs = []
    for r in range(world):
        env_r = dict(base, MOG_COORDINATOR=f"localhost:{port}",
                     MOG_NUM_PROCESSES=str(world), MOG_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", __name__, "--cases", cases_path,
             "--out", out_dir, "--device", str(device)],
            env=env_r, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, deadline = [], time.monotonic() + timeout
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 1.0)
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        logs = [p.communicate()[0] for p in procs]
        raise RuntimeError(f"the ranks ran past {timeout} s:\n"
                           + "\n".join(logs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks {failed} failed:\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode})\n{log}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pth"),
                       weights_only=False) for r in range(world)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cases", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    maybe_initialize_distributed(args.device)
    try:
        device = rank_device(resolve_device(args.device))
        cases = torch.load(args.cases, weights_only=False)
        results = run_cases(cases, device)
        os.makedirs(args.out, exist_ok=True)
        torch.save({"world": world_size(), "rank": rank(),
                    "backend": backend(), "device": str(device),
                    "results": results},
                   os.path.join(args.out, f"rank{rank()}.pth"))
    finally:
        destroy_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
