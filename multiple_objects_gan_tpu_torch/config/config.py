"""YAML config, the reference's cfg/*.yml key schema (Multi-MNIST only).

The port's copy of the JAX package's ``config/config.py``: the default
tree of code/multi-mnist/miscc/config.py:9-47, the strict recursive merge
of ``_merge_a_into_b`` and ``cfg_from_file``. The cfg files are nested
mappings of plain scalars, which :func:`parse_yaml` reads with the
standard library, so the port needs no PyYAML (the card's machine has
none).
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Optional

import torch

from multiple_objects_gan_tpu_torch.models import common


class Config(dict):
    """Minimal attribute-access dict (edict replacement)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(d: dict) -> "Config":
        return Config({k: Config.wrap(v) if isinstance(v, dict) else v
                       for k, v in d.items()})


DEFAULTS: dict[str, dict] = {
    # code/multi-mnist/miscc/config.py:9-47
    "multi-mnist": {
        "DATASET_NAME": "multi-mnist",
        "CONFIG_NAME": "",
        "GPU_ID": "0",
        "CUDA": True,
        "WORKERS": 4,
        "NET_G": "",
        "NET_D": "",
        "DATA_DIR": "",
        "VIS_COUNT": 64,
        "Z_DIM": 100,
        "IMSIZE": 64,
        "USE_LOCAL_PATHWAY": True,
        "USE_BBOX_LAYOUT": True,
        "TRAIN": {
            "FLAG": True,
            "BATCH_SIZE": 64,
            "MAX_EPOCH": 600,
            "SNAPSHOT_INTERVAL": 50,
            "PRETRAINED_MODEL": "",
            "PRETRAINED_EPOCH": 600,
            "LR_DECAY_EPOCH": 600,
            "DISCRIMINATOR_LR": 2e-4,
            "GENERATOR_LR": 2e-4,
        },
        "GAN": {"CONDITION_DIM": 128, "DF_DIM": 64, "GF_DIM": 128,
                "R_NUM": 4},
    },
}


def _merge(a: dict, b: dict, path: str = "") -> None:
    """Strict recursive merge of a into b (parity: _merge_a_into_b)."""
    for k, v in a.items():
        if k not in b:
            raise KeyError(f"{path}{k} is not a valid config key")
        old = b[k]
        if isinstance(old, dict):
            if not isinstance(v, dict):
                raise ValueError(f"Type mismatch for config key {path}{k}")
            _merge(v, old, path=f"{path}{k}.")
        else:
            if old is not None and v is not None:
                ot, nt = type(old), type(v)
                if ot is not nt and not (ot in (int, float) and nt in (int, float)):
                    raise ValueError(
                        f"Type mismatch ({ot} vs {nt}) for config key {path}{k}")
            b[k] = v


def default_config(variant: str) -> Config:
    if variant not in DEFAULTS:
        raise KeyError(f"unknown variant {variant!r}; "
                       f"one of {sorted(DEFAULTS)}")
    return Config.wrap(copy.deepcopy(DEFAULTS[variant]))


_INT = re.compile(r"[-+]?[0-9]+$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9]*\.[0-9]*|\.[0-9]+)([eE][-+]?[0-9]+)?$")
_SCALARS = {"true": True, "false": False, "null": None, "~": None, "": None}


def _scalar(text: str):
    """A plain YAML scalar as PyYAML's safe loader types it."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text.lower() in _SCALARS:
        return _SCALARS[text.lower()]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str) -> dict:
    """Read the YAML the cfg files use: ``key: scalar`` lines nested by
    indentation, with comments, quoted strings, booleans, null, ints and
    floats. Anything else (lists, flow style, anchors) raises."""
    root: dict = {}
    stack = [(-1, root)]          # (indent, mapping) of the open blocks
    last_key = None
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        key, sep, value = line.strip().partition(":")
        if not sep or not key or key.startswith(("-", "[", "{")) \
                or value[:1] not in ("", " "):
            raise ValueError(f"line {n}: not a 'key: value' line: {raw!r}")
        if indent > stack[-1][0] and last_key is not None \
                and stack[-1][1][last_key] is None:
            child: dict = {}
            stack[-1][1][last_key] = child
            stack.append((indent, child))
        while indent < stack[-1][0]:
            stack.pop()
        if indent != max(stack[-1][0], 0):
            raise ValueError(f"line {n}: bad indentation: {raw!r}")
        value = value.strip()
        if value[:1] in ("[", "{", "&", "*", "|", ">"):
            raise ValueError(f"line {n}: unsupported YAML value {value!r}")
        stack[-1][1][key.strip()] = _scalar(value)
        last_key = key.strip()
    return root


def cfg_from_file(path: str, variant: str) -> Config:
    """Load a YAML file and merge it over the variant defaults."""
    cfg = default_config(variant)
    with open(path) as f:
        overrides = parse_yaml(f.read())
    _merge(overrides, cfg)
    return cfg


def stage1_model_config(cfg: Config, variant: str, *,
                        compute_dtype: Optional[torch.dtype] = None,
                        bn_groups: int = 1) -> common.Stage1Config:
    """Bridge a YAML Config to the model-family Stage1Config, with the
    compute dtype (None: float32; or torch.bfloat16) and BatchNorm groups
    the caller's flags give."""
    if variant != "multi-mnist":
        raise ValueError(f"variant {variant!r} is not ported yet; the port "
                         "serves 'multi-mnist'")
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute dtype None (float32) or bfloat16, got "
                         f"{compute_dtype}")
    if int(bn_groups) < 1:
        raise ValueError(f"bn_groups must be at least 1, got {bn_groups}")
    # the mnist reference fixes condition_dim at 128 whatever the YAML says
    return dataclasses.replace(
        common.MNIST, z_dim=cfg.Z_DIM, gf_dim=cfg.GAN.GF_DIM,
        df_dim=cfg.GAN.DF_DIM, use_bbox_layout=bool(cfg.USE_BBOX_LAYOUT),
        compute_dtype=compute_dtype, bn_groups=int(bn_groups))
