"""``torch.load`` for checkpoints written by Python 2 (the port's copy of the
JAX package's ``io/pycompat.py:torch_load``).

The published ``.pth`` files were written by py2 torch-0.4. Their tensors
load as they are, but a py2 ``str`` in the container (a numpy scalar, a
path) raises ``UnicodeDecodeError`` unless it is decoded as latin1, which
round-trips every byte. Loads are ``weights_only``: a checkpoint is data,
and nothing in it may run code.
"""

from __future__ import annotations

import warnings
from typing import Any

import torch


def torch_load(path: str, map_location: str = "cpu") -> Any:
    """``torch.load(weights_only=True)`` with a py2-str (latin1) fallback."""
    try:
        return torch.load(path, map_location=map_location, weights_only=True)
    except UnicodeDecodeError:
        with warnings.catch_warnings():
            # torch warns that encoding= needs weights_only=False, yet its
            # weights-only unpickler does honor it
            warnings.filterwarnings("ignore", "pickle_load_args only works")
            return torch.load(path, map_location=map_location,
                              weights_only=True, encoding="latin1")
