"""YAML config, the reference's cfg/*.yml key schema (the stage-1 families,
COCO StackGAN stage 2 and COCO AttnGAN).

The port's copy of the JAX package's ``config/config.py``: the default
trees of code/multi-mnist/miscc/config.py:9-47, code/clevr/miscc/
config.py:9-45 and code/coco/stackgan/miscc/config.py:9-57, the strict
recursive merge of ``_merge_a_into_b`` and ``cfg_from_file``, with code/coco/attngan/miscc/config.py:9-64's tree
for ``coco-attngan``. The cfg
files are nested mappings of plain scalars, which :func:`parse_yaml` reads
with the standard library, so the port needs no PyYAML (the card's machine
has none).

Variants are named as the CLIs name them (``multi-mnist``, ``clevr``,
``coco-stackgan-1``, ``coco-stackgan-2``, ``coco-attngan``, ``damsm``);
the default tree of both COCO stages is the stackgan one,
``coco-stackgan``, and DAMSM pretraining reads AttnGAN's, as in the JAX
package (``cli/main.py:196-201``).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import re
from typing import Optional

import torch

from multiple_objects_gan_tpu_torch.models import attngan, common


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


_COMMON_TRAIN = {
    "FLAG": True,
    "BATCH_SIZE": 64,
    "MAX_EPOCH": 600,
    "SNAPSHOT_INTERVAL": 50,
    "PRETRAINED_MODEL": "",
    "PRETRAINED_EPOCH": 600,
    "LR_DECAY_EPOCH": 600,
    "DISCRIMINATOR_LR": 2e-4,
    "GENERATOR_LR": 2e-4,
}

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
        "TRAIN": dict(_COMMON_TRAIN),
        "GAN": {"CONDITION_DIM": 128, "DF_DIM": 64, "GF_DIM": 128,
                "R_NUM": 4},
    },
    # code/clevr/miscc/config.py:9-45, with USE_BBOX_LAYOUT_S1 (read by
    # code/clevr/model.py:126, absent from the reference's defaults),
    # False, as the JAX package sets it
    "clevr": {
        "DATASET_NAME": "clevr",
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
        "USE_BBOX_LAYOUT_S1": False,
        "TRAIN": dict(_COMMON_TRAIN),
        "GAN": {"CONDITION_DIM": 128, "DF_DIM": 64, "GF_DIM": 128,
                "R_NUM": 4},
    },
    # code/coco/stackgan/miscc/config.py:9-57
    "coco-stackgan": {
        "DATASET_NAME": "coco",
        "EMBEDDING_TYPE": "cnn-rnn",
        "CONFIG_NAME": "",
        "GPU_ID": "0",
        "CUDA": True,
        "WORKERS": 6,
        "NET_G": "",
        "NET_D": "",
        "STAGE1_G": "",
        "DATA_DIR": "",
        "IMG_DIR": "",
        "VIS_COUNT": 64,
        "Z_DIM": 100,
        "IMSIZE": 64,
        "STAGE": 1,
        "USE_LOCAL_PATHWAY": True,
        "USE_BBOX_LAYOUT": True,
        "TRAIN": {**_COMMON_TRAIN, "COEFF": {"KL": 2.0}},
        "GAN": {"CONDITION_DIM": 128, "DF_DIM": 64, "GF_DIM": 128,
                "R_NUM": 4},
        "TEXT": {"DIMENSION": 1024},
    },
    # code/coco/attngan/miscc/config.py:9-64
    "coco-attngan": {
        "DATASET_NAME": "coco",
        "CONFIG_NAME": "",
        "DATA_DIR": "",
        "IMG_DIR": "",
        "GPU_ID": "0",
        "CUDA": True,
        "WORKERS": 6,
        "RNN_TYPE": "LSTM",
        "B_VALIDATION": False,
        "TREE": {"BRANCH_NUM": 3, "BASE_SIZE": 64},
        "TRAIN": {
            "BATCH_SIZE": 64,
            "MAX_EPOCH": 600,
            "SNAPSHOT_INTERVAL": 2000,
            "DISCRIMINATOR_LR": 2e-4,
            "GENERATOR_LR": 2e-4,
            "ENCODER_LR": 2e-4,
            "RNN_GRAD_CLIP": 0.25,
            "FLAG": True,
            "NET_E": "",
            "NET_G": "",
            "B_NET_D": True,
            "SMOOTH": {"GAMMA1": 5.0, "GAMMA3": 10.0, "GAMMA2": 5.0,
                       "LAMBDA": 1.0},
        },
        "GAN": {"DF_DIM": 64, "GF_DIM": 128, "Z_DIM": 100,
                "CONDITION_DIM": 100, "R_NUM": 2, "B_ATTENTION": True,
                "B_DCGAN": False},
        "TEXT": {"CAPTIONS_PER_IMAGE": 10, "EMBEDDING_DIM": 256,
                 "WORDS_NUM": 18},
    },
}

# the CLIs' variant names -> default trees and model presets
_TREES = {"multi-mnist": "multi-mnist", "clevr": "clevr",
          "coco-stackgan-1": "coco-stackgan",
          "coco-stackgan-2": "coco-stackgan", "coco-attngan": "coco-attngan",
          "damsm": "coco-attngan"}
_PRESETS = {"multi-mnist": common.MNIST, "clevr": common.CLEVR,
            "coco-stackgan-1": common.COCO_S1}


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
    if variant not in _TREES:
        raise KeyError(f"unknown variant {variant!r}; "
                       f"one of {sorted(_TREES)}")
    return Config.wrap(copy.deepcopy(DEFAULTS[_TREES[variant]]))


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


def _dump_scalar(key: str, value) -> str:
    """``value`` as :func:`_scalar` reads it back to the same value."""
    if value is None or isinstance(value, bool):
        return {None: "null", True: "True", False: "False"}[value]
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if not math.isfinite(value):
            raise ValueError(f"{key}: cannot write {value!r}")
        text = repr(value)
        # PyYAML and _FLOAT read a float only with a dot: 1e-05 -> 1.0e-05
        return text if "." in text else text.replace("e", ".0e", 1)
    if isinstance(value, str):
        if "'" in value or "\n" in value:
            raise ValueError(f"{key}: cannot write {value!r} (a quote or a "
                             "line break)")
        return f"'{value}'"
    raise ValueError(f"{key}: cannot write a {type(value).__name__}")


def dump_yaml(doc: dict, indent: int = 0) -> str:
    """Write a nested mapping of plain scalars as YAML that
    :func:`parse_yaml` (and PyYAML's safe loader) reads back to ``doc``:
    strings quoted, floats with a dot, nested mappings indented by 4."""
    lines = []
    for key, value in doc.items():
        if not isinstance(key, str) or not key or ":" in key \
                or key != key.strip():
            raise ValueError(f"cannot write the key {key!r}")
        if isinstance(value, dict):
            if not value:
                raise ValueError(f"{key}: cannot write an empty mapping")
            lines.append(" " * indent + f"{key}:")
            lines.append(dump_yaml(value, indent + 4).rstrip("\n"))
        else:
            lines.append(" " * indent + f"{key}: {_dump_scalar(key, value)}")
    return "\n".join(lines) + "\n"


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
    """Bridge a YAML Config to the model-family Stage1Config (JAX
    ``stage1_model_config``), with the compute dtype (None: float32; or
    torch.bfloat16) and BatchNorm groups the caller's flags give."""
    if variant not in _PRESETS:
        raise ValueError(f"variant {variant!r} is not a stage-1 family; one "
                         f"of {sorted(_PRESETS)}")
    _check_knobs(compute_dtype, bn_groups)
    kw = dict(z_dim=cfg.Z_DIM, gf_dim=cfg.GAN.GF_DIM, df_dim=cfg.GAN.DF_DIM,
              # the clevr reference also honours USE_BBOX_LAYOUT_S1
              # (code/clevr/model.py:126)
              use_bbox_layout=bool(cfg.USE_BBOX_LAYOUT
                                   or cfg.get("USE_BBOX_LAYOUT_S1", False)),
              compute_dtype=compute_dtype, bn_groups=int(bn_groups))
    # the mnist reference fixes condition_dim at 128 whatever the YAML says
    if variant != "multi-mnist":
        kw["condition_dim"] = cfg.GAN.CONDITION_DIM
    if variant == "coco-stackgan-1":
        kw["text_dim"] = cfg.TEXT.DIMENSION
        kw["d_cond_dim"] = cfg.GAN.CONDITION_DIM
    return dataclasses.replace(_PRESETS[variant], **kw)


def _check_knobs(compute_dtype, bn_groups) -> None:
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute dtype None (float32) or bfloat16, got "
                         f"{compute_dtype}")
    if int(bn_groups) < 1:
        raise ValueError(f"bn_groups must be at least 1, got {bn_groups}")


def stage2_model_config(cfg: Config, *,
                        compute_dtype: Optional[torch.dtype] = None,
                        bn_groups: int = 1
                        ) -> tuple[common.Stage1Config, common.Stage1Config]:
    """The two model configs of a COCO StackGAN stage-2 cfg (JAX
    ``cli/stage2_runner.py:36-43``): the frozen stage-1 G's, as
    :func:`stage1_model_config` reads the cfg for coco-stackgan-1 (G width
    GF_DIM * 8), and stage 2's, the ``COCO_S2`` preset with GF_DIM and
    DF_DIM taken directly, GAN.R_NUM ResBlocks, the CONDITION_DIM
    condition and both D heads.
    The compute dtype and BatchNorm groups reach both, as the JAX
    package's global knobs do."""
    _check_knobs(compute_dtype, bn_groups)
    s1 = stage1_model_config(cfg, "coco-stackgan-1",
                             compute_dtype=compute_dtype,
                             bn_groups=bn_groups)
    s2 = dataclasses.replace(
        common.COCO_S2, gf_dim=int(cfg.GAN.GF_DIM),
        df_dim=int(cfg.GAN.DF_DIM),
        condition_dim=int(cfg.GAN.CONDITION_DIM),
        d_cond_dim=int(cfg.GAN.CONDITION_DIM),
        text_dim=int(cfg.TEXT.DIMENSION), r_num=int(cfg.GAN.R_NUM),
        compute_dtype=compute_dtype, bn_groups=int(bn_groups))
    return s1, s2


def attngan_model_config(cfg: Config, *,
                         compute_dtype: Optional[torch.dtype] = None,
                         bn_groups: int = 1) -> attngan.AttnGanConfig:
    """The AttnGanConfig of a coco-attngan cfg (JAX
    ``cli/attngan_runner.py:39-62 build_all``): ``COCO_ATTN`` with the
    cfg's GAN widths, Z_DIM, CONDITION_DIM, R_NUM and B_DCGAN, its
    TEXT.EMBEDDING_DIM and TREE.BRANCH_NUM, and the caller's compute
    dtype and BatchNorm groups."""
    _check_knobs(compute_dtype, bn_groups)
    return dataclasses.replace(
        attngan.COCO_ATTN, gf_dim=int(cfg.GAN.GF_DIM),
        df_dim=int(cfg.GAN.DF_DIM), z_dim=int(cfg.GAN.Z_DIM),
        condition_dim=int(cfg.GAN.CONDITION_DIM),
        embedding_dim=int(cfg.TEXT.EMBEDDING_DIM),
        branch_num=int(cfg.TREE.BRANCH_NUM), r_num=int(cfg.GAN.R_NUM),
        b_dcgan=bool(cfg.GAN.B_DCGAN), compute_dtype=compute_dtype,
        bn_groups=int(bn_groups))


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    """The TRAIN block's scalars the train loop and step read."""
    batch_size: int
    max_epoch: int
    lr_decay_epoch: int
    generator_lr: float
    discriminator_lr: float
    kl_coeff: float          # TRAIN.COEFF.KL; the CA families' KL weight


def train_settings(cfg: Config) -> TrainSettings:
    """The TRAIN block of ``cfg``. ``kl_coeff`` is TRAIN.COEFF.KL where the
    tree has it (stackgan) and 0 elsewhere: the KL term exists only under
    the CA net."""
    t = cfg.TRAIN
    return TrainSettings(
        batch_size=int(t.BATCH_SIZE), max_epoch=int(t.MAX_EPOCH),
        lr_decay_epoch=int(t.LR_DECAY_EPOCH),
        generator_lr=float(t.GENERATOR_LR),
        discriminator_lr=float(t.DISCRIMINATOR_LR),
        kl_coeff=float(t.COEFF.KL) if "COEFF" in t else 0.0)


@dataclasses.dataclass(frozen=True)
class AttnGanTrainSettings:
    """What the AttnGAN train entry reads of a coco-attngan cfg (JAX
    ``cli/attngan_runner.py:185-331``): the TRAIN block's batch, epochs,
    learning rates (never decayed), snapshot interval, SMOOTH (the DAMSM
    gammas and LAMBDA), NET_G, NET_E and B_NET_D, and the data's TEXT and
    TREE settings. DAMSM pretraining (``cli/damsm_runner.py``; its cfg
    reads the coco-attngan tree) reads the same, and besides the encoders'
    learning rate ENCODER_LR (x0.98 an epoch, floored at a tenth), the
    text encoder's gradient clip RNN_GRAD_CLIP and EMBEDDING_DIM."""
    batch_size: int
    max_epoch: int
    generator_lr: float
    discriminator_lr: float
    snapshot_interval: int
    smooth: dict
    net_g: str
    net_e: str
    b_net_d: bool
    words_num: int
    captions_per_image: int
    base_size: int
    branch_num: int
    encoder_lr: float
    rnn_grad_clip: float
    embedding_dim: int


def attngan_train_settings(cfg: Config) -> AttnGanTrainSettings:
    t = cfg.TRAIN
    return AttnGanTrainSettings(
        batch_size=int(t.BATCH_SIZE), max_epoch=int(t.MAX_EPOCH),
        generator_lr=float(t.GENERATOR_LR),
        discriminator_lr=float(t.DISCRIMINATOR_LR),
        snapshot_interval=int(t.SNAPSHOT_INTERVAL),
        smooth={k: float(v) for k, v in t.SMOOTH.items()},
        net_g=str(t.NET_G), net_e=str(t.NET_E), b_net_d=bool(t.B_NET_D),
        words_num=int(cfg.TEXT.WORDS_NUM),
        captions_per_image=int(cfg.TEXT.CAPTIONS_PER_IMAGE),
        base_size=int(cfg.TREE.BASE_SIZE),
        branch_num=int(cfg.TREE.BRANCH_NUM),
        encoder_lr=float(t.ENCODER_LR), rnn_grad_clip=float(t.RNN_GRAD_CLIP),
        embedding_dim=int(cfg.TEXT.EMBEDDING_DIM))

