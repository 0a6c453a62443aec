"""Pickles and ``torch.load`` for files written by Python 2 (the port's copy
of the JAX package's ``io/pycompat.py``).

The reference's datasets are Python-2 cPickle files. Python 3's
``pickle.load`` decodes a py2 ``str`` as ASCII, so the first non-ASCII byte
(there is one in every pickled py2 numpy array, whose buffer is a ``str``)
raises. :func:`load_pickle_diag` tries a plain load, then ``utf-8`` (py2
text such as file names), then ``latin1``, which round-trips every byte and
is what numpy's reconstructor expects.

The published ``.pth`` files were written by py2 torch-0.4. Their tensors
load as they are, but a py2 ``str`` in the container (a numpy scalar, a
path) raises ``UnicodeDecodeError`` unless it is decoded as latin1, which
round-trips every byte. Loads are ``weights_only``: a checkpoint is data,
and nothing in it may run code.
"""

from __future__ import annotations

import pickle
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


def load_pickle_diag(path: str) -> tuple[Any, str]:
    """:func:`load_pickle` and the decode that succeeded: ``"py3"``,
    ``"utf-8"`` or ``"latin1"``. ``ValueError`` (which
    ``UnicodeDecodeError`` is) falls through to the next attempt: a py2
    buffer that happens to decode as utf-8 fails later, in
    ``ndarray.__setstate__``, with a buffer-size ``ValueError``."""
    with open(path, "rb") as f:
        for encoding in (None, "utf-8"):
            try:
                if encoding is None:
                    return pickle.load(f), "py3"
                return pickle.load(f, encoding=encoding), encoding
            except ValueError:
                f.seek(0)
        return pickle.load(f, encoding="latin1"), "latin1"


def load_pickle(path: str) -> Any:
    """A pickle written by Python 2 or Python 3."""
    return load_pickle_diag(path)[0]
