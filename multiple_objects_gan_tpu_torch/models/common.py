"""Model-family configuration (the port's copy of the JAX package's
``models/common.py``).

The three stage-1 families differ only in configuration:

  variant   img ch  objects  label  embed         CA-net  D condition
  mnist     1       3        10     no            no      sum(one-hots), dim 10
  clevr     3       4        13     13 -> 16      no      clamp(sum), dim 13
  coco-s1   3       3        81     (c||81)->128  yes     mu, dim 128

COCO StackGAN stage 2 (``COCO_S2``) shares coco-s1's fields; its G width
is GF_DIM itself, not GF_DIM * 8 (``Stage2G``), and its D has both heads.

Sources: code/multi-mnist/model.py, code/clevr/model.py,
code/coco/stackgan/model.py and the cfg/*.yml files. The presets keep the
JAX package's default widths; ``config/config.py:stage1_model_config``
sets the widths a cfg file gives.

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
    r_num: int = 2             # cfg.GAN.R_NUM: stage 2's ResBlocks

    @property
    def ngf(self) -> int:
        return self.gf_dim * 8

    @property
    def layout_code_dim(self) -> int:
        # (c_dim // 8) channels at 2x2 after three stride-2 convs from 16x16
        return (self.condition_dim // 8) * 2 * 2 if self.use_bbox_layout else 0


    @property
    def object_dim(self) -> int:
        """Channels of the per-object label vectors that feed the object
        pathway and the layout encoder: the embedding's width, or the raw
        one-hots' where there is no embedding (mnist)."""
        return self.condition_dim if self.use_label_embed else self.label_dim


MNIST = Stage1Config(
    variant="mnist", img_channels=1, num_objects=3, label_dim=10,
    condition_dim=128, d_cond_dim=10)

CLEVR = Stage1Config(
    variant="clevr", img_channels=3, num_objects=4, label_dim=13,
    condition_dim=16, use_label_embed=True, d_cond_dim=13)

COCO_S1 = Stage1Config(
    variant="coco-stackgan-1", img_channels=3, num_objects=3, label_dim=81,
    condition_dim=128, text_dim=1024, use_label_embed=True, use_ca=True,
    d_cond_dim=128)

# stage 2 (JAX models/stage2.py:52-58): gf_dim is the G width itself
# (code/coco/stackgan/model.py:314), and the D has the unconditional head
COCO_S2 = dataclasses.replace(
    COCO_S1, variant="coco-stackgan-2", gf_dim=192, df_dim=96,
    use_uncond_head=True)
