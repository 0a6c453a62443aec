"""Rematerialization of the train steps' regions (``MOG_REMAT``): the port
of the JAX package's ``train/step.py:maybe_remat``.

The JAX package reads ``MOG_REMAT`` when it traces a step and wraps a
differentiated region in ``jax.checkpoint``; here the step builders
(``make_train_step``, ``make_stage2_train_step``,
``make_attngan_train_step``) read it once, when they build the step
(:class:`Remat`), and wrap the same regions in
``torch.utils.checkpoint.checkpoint`` with ``use_reentrant=False``, which
the G update's ``torch.autograd.grad`` needs. The values and their
aliases are the JAX package's:

* ``0`` (also ``""``, ``false``, ``off``; the default): nothing is
  wrapped; every activation is saved;
* ``full`` (also ``1``, ``true``, ``on``): nothing of a region is saved;
  its whole forward runs again in the backward;
* ``convs``: the outputs of ``aten.convolution`` and of the matmul family
  (``mm``, ``addmm``, ``bmm``) are saved, everything else (BatchNorm,
  activations, the place) is recomputed: JAX's ``conv_general_dilated`` and
  ``dot_general`` policy;
* ``dots``: the matmul family alone is saved (JAX's ``dots_saveable``);
  convolutions are recomputed.

``convs`` and ``dots`` are selective checkpointing (``context_fn`` from
``create_selective_checkpoint_contexts``). Its cache refuses a saved
output that a later op changed in place, so under those two modes the
step runs its models with out-of-place activations (:meth:`Remat.step`):
the same values, one more tensor kept a layer.

A region's second run is its recompute in the backward. It runs under
``nn/blocks.py:running_stats_frozen``, so the BatchNorm running
statistics and ``num_batches_tracked`` take their updates once, as in
mode 0; its collectives (sync-BN's gather, the wrong pair's shift) run
again on every rank in the same order. The regions draw no random
numbers (the steps draw their noise outside them from explicit
generators, which a checkpoint would not replay anyway), so the RNG
state is not saved (``preserve_rng_state=False``). The place (K1, through
``ctypes``) is no aten op a policy can see: under every mode its forward
runs again in the recompute and launches K1 again, as the JAX package's
Pallas call is recomputed under its ``convs`` and ``dots`` policies.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Callable, Iterable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from multiple_objects_gan_tpu_torch.nn.blocks import running_stats_frozen

_ALIASES = {"": "0", "0": "0", "false": "0", "off": "0",
            "1": "full", "true": "full", "on": "full", "full": "full",
            "convs": "convs", "dots": "dots"}
_MATMULS = (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm)
_SAVED_OPS = {"convs": (torch.ops.aten.convolution,) + _MATMULS,
              "dots": _MATMULS}


def remat_mode(value: Optional[str] = None) -> str:
    """``value`` (default: ``$MOG_REMAT``, else ``0``) as ``0``, ``full``,
    ``convs`` or ``dots``; a ValueError names any other value."""
    raw = os.environ.get("MOG_REMAT", "0") if value is None else value
    mode = str(raw).lower()
    if mode not in _ALIASES:
        raise ValueError(f"MOG_REMAT={mode!r}: expected 0|full|convs|dots")
    return _ALIASES[mode]


def _policy(saved: tuple) -> Callable:
    def policy(ctx, op, *args, **kwargs):
        if getattr(op, "overloadpacket", op) in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


class Remat:
    """``MOG_REMAT`` for one step, read when the step is built: ``remat(fn)``
    wraps a region, ``remat.step(modules)`` is the context the whole step
    (forward and backward) runs in (module docstring)."""

    def __init__(self, mode: Optional[str] = None):
        self.mode = remat_mode(mode)
        self._saved = _SAVED_OPS.get(self.mode)

    def __call__(self, fn: Callable) -> Callable:
        """``fn`` at mode 0; else ``fn'(*args)``, which runs ``fn`` as a
        checkpointed region, its second and later runs with the running
        statistics frozen."""
        if self.mode == "0":
            return fn
        kwargs = {"use_reentrant": False, "preserve_rng_state": False}
        if self._saved is not None:
            kwargs["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _policy(self._saved))

        @functools.wraps(fn)
        def region(*args):
            runs = [0]

            def run(*a):
                runs[0] += 1
                if runs[0] == 1:
                    return fn(*a)
                with running_stats_frozen():
                    return fn(*a)

            return checkpoint(run, *args, **kwargs)
        return region

    @contextlib.contextmanager
    def step(self, modules: Iterable[nn.Module]):
        """Every ``nn.ReLU`` and ``nn.LeakyReLU`` of ``modules`` out of
        place while the context lasts, under ``convs`` and ``dots``; their
        settings come back after."""
        changed = []
        if self._saved is not None:
            changed = [m for root in modules for m in root.modules()
                       if isinstance(m, (nn.ReLU, nn.LeakyReLU))
                       and m.inplace]
        for m in changed:
            m.inplace = False
        try:
            yield
        finally:
            for m in changed:
                m.inplace = True
