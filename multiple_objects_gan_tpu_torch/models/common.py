"""Model-family configuration (the port's copy of the JAX package's
``models/common.py``).

Only the Multi-MNIST preset is served by this slice of the port: it needs
neither the conditioning-augmentation net nor a label embedding.

Two fields are the JAX package's trace-time knobs, made explicit:
``compute_dtype`` (``nn/blocks.py:set_compute_dtype``; the CLIs' ``--bf16``)
and ``bn_groups`` (``BN_GROUPS``; ``--bn_groups``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Stage1Config:
    variant: str
    img_channels: int
    num_objects: int
    label_dim: int
    z_dim: int = 100
    gf_dim: int = 128          # cfg.GAN.GF_DIM; G width is gf_dim * 8
    df_dim: int = 64           # cfg.GAN.DF_DIM
    condition_dim: int = 128   # cfg.GAN.CONDITION_DIM
    text_dim: int = 0          # cfg.TEXT.DIMENSION (stackgan: 1024)
    use_label_embed: bool = False
    use_ca: bool = False
    use_bbox_layout: bool = True
    d_cond_dim: int = 10       # dim of the condition fed to the D cond head
    use_uncond_head: bool = False
    # dtype of the convs, linears and activations; None: the parameters'
    # (float32), as the JAX package's COMPUTE_DTYPE None
    compute_dtype: Optional[torch.dtype] = None
    bn_groups: int = 1         # train-mode BatchNorm statistic groups

    @property
    def ngf(self) -> int:
        return self.gf_dim * 8

    @property
    def layout_code_dim(self) -> int:
        # (c_dim // 8) channels at 2x2 after three stride-2 convs from 16x16
        return (self.condition_dim // 8) * 2 * 2 if self.use_bbox_layout else 0


MNIST = Stage1Config(
    variant="mnist", img_channels=1, num_objects=3, label_dim=10,
    condition_dim=128, d_cond_dim=10)
