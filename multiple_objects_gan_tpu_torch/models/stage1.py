"""Stage-1 (64px) generator and discriminator (port of the JAX
``models/stage1.py``).

Reference STAGE1_G: code/multi-mnist/model.py:113-190; STAGE1_D:
model.py:193-257. Modules and state-dict keys are the reference's, so a
reference ``.pth`` and the JAX package's export load with ``strict=True``.
Both run in train and eval mode; in train mode the object pathways keep
the reference's per-object BatchNorm statistics (``ObjectBatchNorm2d``).
The config's ``compute_dtype`` is the dtype of every conv and linear (and
so of the activations: a bf16 ``Stage1G`` returns a bf16 image), and its
``bn_groups`` the statistic groups of every BatchNorm (``nn/blocks.py``).
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from multiple_objects_gan_tpu_torch import resolve_device
from multiple_objects_gan_tpu_torch.io.weights import reference_init_
from multiple_objects_gan_tpu_torch.models.common import Stage1Config
from multiple_objects_gan_tpu_torch.nn.blocks import (
    BatchNorm1d, BatchNorm2d, Conv2d, Conv3x3, Linear, ObjectBatchNorm2d,
    UpBlock)
from multiple_objects_gan_tpu_torch.nn.pathways import (
    DGetLogits, LayoutEncoder, ObjectPathwayD, object_pathway_g)


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
        dt, groups = cfg.compute_dtype, cfg.bn_groups
        self.fc = nn.Sequential(
            Linear(nz, ngf * 4 * 4, bias=False, compute_dtype=dt),
            BatchNorm1d(ngf * 4 * 4, groups=groups),
            nn.ReLU(True))
        object_bn = functools.partial(ObjectBatchNorm2d,
                                      n_objects=cfg.num_objects,
                                      groups=groups)
        bn = functools.partial(BatchNorm2d, groups=groups)
        self.local1 = UpBlock(cfg.label_dim, ngf // 2, object_bn, dt)
        self.local2 = UpBlock(ngf // 2, ngf // 4, object_bn, dt)
        if cfg.use_bbox_layout:
            self.bbox_net = LayoutEncoder(cfg.label_dim, cfg.condition_dim,
                                          dt, groups)
        self.upsample1 = UpBlock(ngf, ngf // 2, bn, dt)
        self.upsample2 = UpBlock(ngf // 2, ngf // 4, bn, dt)
        self.upsample3 = UpBlock(ngf // 2, ngf // 8, bn, dt)
        self.upsample4 = UpBlock(ngf // 8, ngf // 16, bn, dt)
        self.img = nn.Sequential(
            Conv3x3(ngf // 16, cfg.img_channels, compute_dtype=dt),
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


class Stage1D(nn.Module):
    """64px discriminator: object pathway + conv stack + logit heads.

    ``forward(image (B, C, 64, 64), labels (B, O, L), bbox (B, O, 4))``
    returns the (B, 8 * ndf, 4, 4) feature map; :meth:`cond_logits` and
    :meth:`uncond_logits` are the heads, as the reference splits netD and
    netD.get_cond_logits so that the matching-aware loss reuses features
    across the real, wrong and fake pairs.
    """

    def __init__(self, cfg: Stage1Config):
        super().__init__()
        self.cfg = cfg
        ndf = cfg.df_dim
        dt, groups = cfg.compute_dtype, cfg.bn_groups

        def down(cin, cout):
            return Conv2d(cin, cout, kernel_size=4, stride=2, padding=1,
                          bias=False, compute_dtype=dt)

        self.local = ObjectPathwayD(ndf, cfg.img_channels, cfg.label_dim,
                                    cfg.num_objects, dt, groups)
        self.conv1 = down(cfg.img_channels, ndf)                # 32x32
        self.conv2 = down(ndf, ndf * 2)                         # 16x16
        self.bn2 = BatchNorm2d(ndf * 2, groups=groups)
        self.conv3 = down(ndf * 4, ndf * 4)                     # 8x8
        self.bn3 = BatchNorm2d(ndf * 4, groups=groups)
        self.conv4 = down(ndf * 4, ndf * 8)                     # 4x4
        self.bn4 = BatchNorm2d(ndf * 8, groups=groups)
        self.act = nn.LeakyReLU(0.2, inplace=True)
        self.get_cond_logits = DGetLogits(ndf, cfg.d_cond_dim, dt, groups)
        if cfg.use_uncond_head:
            self.get_uncond_logits = DGetLogits(ndf, 0, dt, groups)

    def forward(self, image: torch.Tensor, labels: torch.Tensor,
                bbox: torch.Tensor) -> torch.Tensor:
        h_local = self.local(image, labels, bbox)
        h = self.act(self.conv1(image))
        h = self.act(self.bn2(self.conv2(h)))
        h = torch.cat([h, h_local], dim=1)
        h = self.act(self.bn3(self.conv3(h)))
        return self.act(self.bn4(self.conv4(h)))

    def cond_logits(self, h_code: torch.Tensor,
                    c_code: torch.Tensor) -> torch.Tensor:
        return self.get_cond_logits(h_code, c_code)

    def uncond_logits(self, h_code: torch.Tensor) -> torch.Tensor:
        return self.get_uncond_logits(h_code)


def _build(model: nn.Module, state_dict, seed: int, device) -> nn.Module:
    dev = resolve_device(device)
    if state_dict is None:
        reference_init_(model, seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.to(dev).eval()


def build_stage1_g(cfg: Stage1Config, state_dict=None, *, seed: int = 0,
                   device="cuda") -> Stage1G:
    """An eval-mode Stage1G on ``device``: ``state_dict`` (reference keys)
    loaded with strict=True, or the reference's random init from ``seed``
    when there is none."""
    return _build(Stage1G(cfg), state_dict, seed, device)


def build_stage1_d(cfg: Stage1Config, state_dict=None, *, seed: int = 0,
                   device="cuda") -> Stage1D:
    """An eval-mode Stage1D on ``device``, as :func:`build_stage1_g`."""
    return _build(Stage1D(cfg), state_dict, seed, device)
