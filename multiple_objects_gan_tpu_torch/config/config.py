"""YAML config, the reference's cfg/*.yml key schema (Multi-MNIST only).

The port's copy of the JAX package's ``config/config.py``: the default
tree of code/multi-mnist/miscc/config.py:9-47, the strict recursive merge
of ``_merge_a_into_b`` and ``cfg_from_file``. ``yaml`` is imported only
inside :func:`cfg_from_file`, so the serving path runs where PyYAML is not
installed (it builds its config from the ``MNIST`` preset).
"""

from __future__ import annotations

import copy
import dataclasses

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


def cfg_from_file(path: str, variant: str) -> Config:
    """Load a YAML file and merge it over the variant defaults."""
    import yaml

    cfg = default_config(variant)
    with open(path) as f:
        overrides = yaml.safe_load(f) or {}
    _merge(overrides, cfg)
    return cfg


def stage1_model_config(cfg: Config, variant: str) -> common.Stage1Config:
    """Bridge a YAML Config to the model-family Stage1Config."""
    if variant != "multi-mnist":
        raise ValueError(f"variant {variant!r} is not ported yet; the port "
                         "serves 'multi-mnist'")
    # the mnist reference fixes condition_dim at 128 whatever the YAML says
    return dataclasses.replace(
        common.MNIST, z_dim=cfg.Z_DIM, gf_dim=cfg.GAN.GF_DIM,
        df_dim=cfg.GAN.DF_DIM, use_bbox_layout=bool(cfg.USE_BBOX_LAYOUT))
