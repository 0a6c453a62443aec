"""Stage-1 (64px) generator, eval only (port of the JAX ``models/stage1.py``).

Reference STAGE1_G: code/multi-mnist/model.py:113-190. Modules and
state-dict keys are the reference's, so a reference ``.pth`` and the JAX
package's export load with ``strict=True``.
"""

from __future__ import annotations

import torch
from torch import nn

from multiple_objects_gan_tpu_torch import resolve_device
from multiple_objects_gan_tpu_torch.io.weights import reference_init_
from multiple_objects_gan_tpu_torch.models.common import Stage1Config
from multiple_objects_gan_tpu_torch.nn.blocks import Conv3x3, UpBlock
from multiple_objects_gan_tpu_torch.nn.pathways import (
    LayoutEncoder, object_pathway_g)


class Stage1G(nn.Module):
    """64px generator: object pathway + layout encoding + global pathway.

    forward(z (B, z_dim), bbox (B, O, 4), label_onehot (B, O, L))
    -> image (B, img_channels, 64, 64) in [-1, 1].
    """

    def __init__(self, cfg: Stage1Config):
        super().__init__()
        if cfg.use_ca or cfg.use_label_embed:
            raise NotImplementedError(
                f"{cfg.variant}: CA and label embedding are not ported yet")
        self.cfg = cfg
        ngf = cfg.ngf
        nz = cfg.z_dim + cfg.layout_code_dim
        self.fc = nn.Sequential(nn.Linear(nz, ngf * 4 * 4, bias=False),
                                nn.BatchNorm1d(ngf * 4 * 4),
                                nn.ReLU(True))
        self.local1 = UpBlock(cfg.label_dim, ngf // 2)
        self.local2 = UpBlock(ngf // 2, ngf // 4)
        if cfg.use_bbox_layout:
            self.bbox_net = LayoutEncoder(cfg.label_dim, cfg.condition_dim)
        self.upsample1 = UpBlock(ngf, ngf // 2)
        self.upsample2 = UpBlock(ngf // 2, ngf // 4)
        self.upsample3 = UpBlock(ngf // 2, ngf // 8)
        self.upsample4 = UpBlock(ngf // 8, ngf // 16)
        self.img = nn.Sequential(Conv3x3(ngf // 16, cfg.img_channels),
                                 nn.Tanh())
        # The reference defines this label module and never calls it
        # (model.py:137-140). It stays, unused in forward, only so that
        # reference checkpoints load with strict=True.
        self.label = nn.Sequential(
            nn.Linear(cfg.label_dim, cfg.label_dim, bias=False),
            nn.BatchNorm1d(cfg.label_dim))

    def forward(self, z: torch.Tensor, bbox: torch.Tensor,
                label_onehot: torch.Tensor) -> torch.Tensor:
        h_local = object_pathway_g(label_onehot, bbox, self.local1,
                                   self.local2)
        code = z
        if self.cfg.use_bbox_layout:
            code = torch.cat([z, self.bbox_net(label_onehot, bbox)], dim=1)
        # reference .view(-1, ngf, 4, 4): the fc output is CHW-ordered
        h = self.fc(code).view(-1, self.cfg.ngf, 4, 4)
        h = self.upsample2(self.upsample1(h))                  # 16x16
        h = torch.cat([h, h_local], dim=1)
        h = self.upsample4(self.upsample3(h))                  # 64x64
        return self.img(h)


def build_stage1_g(cfg: Stage1Config, state_dict=None, *, seed: int = 0,
                   device="cuda") -> Stage1G:
    """An eval-mode Stage1G on ``device``: ``state_dict`` (reference keys)
    loaded with strict=True, or the reference's random init from ``seed``
    when there is none."""
    dev = resolve_device(device)
    g = Stage1G(cfg)
    if state_dict is None:
        reference_init_(g, seed)
    else:
        g.load_state_dict(state_dict, strict=True)
    return g.to(dev).eval()
