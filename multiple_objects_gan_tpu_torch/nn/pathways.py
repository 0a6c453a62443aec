"""Generator pathways of Stage-1, NCHW (port of the JAX ``nn/pathways.py``).

Reference: BBOX_NET (code/multi-mnist/model.py:80-110) and the G object
pathway (model.py:160-169). The reference loops over objects; here the
objects fold into the batch (eval-mode BatchNorm is per sample, so the
fold changes nothing) and one kernel launch places and sums them all.
"""

from __future__ import annotations

import torch
from torch import nn

from multiple_objects_gan_tpu_torch.nn.blocks import Conv3x3, UpBlock
from multiple_objects_gan_tpu_torch.ops.stn import stn_place_const_multi
from multiple_objects_gan_tpu_torch.ops.stn_place_cuda import (
    stn_place_multi_nchw)


class LayoutEncoder(nn.Module):
    """BBOX_NET: paste each object's label vector into its box on a 16x16
    canvas, encode with three stride-2 conv3x3 (the first without BN) and
    flatten in CHW order.

    labels (B, O, label_dim), bbox (B, O, 4) -> (B, (c_dim // 8) * 2 * 2).
    """

    def __init__(self, label_dim: int, c_dim: int):
        super().__init__()
        self.encode = nn.Sequential(
            Conv3x3(label_dim, c_dim // 2, stride=2),
            nn.LeakyReLU(0.2, inplace=True),
            Conv3x3(c_dim // 2, c_dim // 4, stride=2),
            nn.BatchNorm2d(c_dim // 4),
            nn.LeakyReLU(0.2, inplace=True),
            Conv3x3(c_dim // 4, c_dim // 8, stride=2),
            nn.BatchNorm2d(c_dim // 8),
            nn.LeakyReLU(0.2, inplace=True))

    def forward(self, labels: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
        layout = stn_place_const_multi(labels, bbox, (16, 16))
        x = self.encode(layout.permute(0, 3, 1, 2))
        return x.reshape(labels.shape[0], -1)


def object_pathway_g(labels: torch.Tensor, bbox: torch.Tensor,
                     local1: UpBlock, local2: UpBlock) -> torch.Tensor:
    """The JAX ``ObjectPathwayG``: per object, tile the label to 4x4, run two
    UpBlocks to 16x16, place into the box and sum over objects.

    labels (B, O, ef), bbox (B, O, 4) -> (B, ngf // 4, 16, 16). A function
    over the two blocks, because the reference keeps ``local1``/``local2``
    on STAGE1_G itself (model.py:135-136), and so do the state-dict keys.
    """
    b, o, ef = labels.shape
    x = labels.reshape(b * o, ef, 1, 1).expand(b * o, ef, 4, 4)
    x = local2(local1(x))
    x = x.reshape((b, o) + x.shape[1:])
    return stn_place_multi_nchw(x, bbox.contiguous(), (16, 16))
