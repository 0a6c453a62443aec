"""COCO StackGAN stage 2, 256px (port of the JAX ``models/stage2.py``).

Reference STAGE2_G: code/coco/stackgan/model.py:311-442; STAGE2_D:
model.py:445-537. The frozen stage-1 G is not a submodule here, as in the
JAX package: the caller runs it and passes its 64px image in, detached
(model.py:317-320,385), so its parameters never meet the stage-2
optimizer. Its state-dict keys are the reference's under ``STAGE1_G.``
(``io/weights.py:split_stage2_g``). The modules and keys are the
reference's otherwise, so a reference ``.pth`` and the JAX package's
export load with ``strict=True``.

The G width is ``cfg.gf_dim`` itself (model.py:314; 192 for
cfg/coco_s2_train.yml), not ``gf_dim * 8`` as in stage 1. Both object
pathways fold (B, O) into the batch with O minor and keep the reference's
per-object BatchNorm statistics in train mode (``ObjectBatchNorm2d``), and
each places all its objects with one K3 call (``ops/stn_place_cuda.py``):
G2's (B, O, gf, 64, 64) onto 64x64, D2's (B, O, 2 * df, 30, 30) onto
32x32. The config's ``compute_dtype`` and ``bn_groups`` act as in stage 1
(``nn/blocks.py``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn

from multiple_objects_gan_tpu_torch.models.common import Stage1Config
from multiple_objects_gan_tpu_torch.models.stage1 import (
    Stage1GOutput, _build)
from multiple_objects_gan_tpu_torch.nn.blocks import (
    BatchNorm2d, Conv2d, Conv3x3, ObjectBatchNorm2d, ResBlock, UpBlock)
from multiple_objects_gan_tpu_torch.nn.pathways import (
    CANet, DGetLogits, LabelEmbed)
from multiple_objects_gan_tpu_torch.ops.stn import (
    stn_extract_multi_nchw, stn_place_const_multi)
from multiple_objects_gan_tpu_torch.ops.stn_place_cuda import (
    stn_place_multi_nchw)


def _down(cin: int, cout: int, stride: int, dt) -> Conv2d:
    """conv4x4, pad 1, no bias: stride 2 halves a side, stride 1 takes one
    off it."""
    return Conv2d(cin, cout, kernel_size=4, stride=stride, padding=1,
                  bias=False, compute_dtype=dt)


class Stage2G(nn.Module):
    """256px generator on the frozen stage-1 G's 64px image.

    forward(stage1_img (B, 3, 64, 64), bbox_s1 (B, O, 4), bbox_s2
    (B, O, 4), label_onehot (B, O, L), text_embedding (B, text_dim), eps
    (B, c_dim) or None) -> image (B, 3, 256, 256) in [-1, 1];
    :meth:`outputs` returns the image with mu and logvar
    (:class:`Stage1GOutput`).

    The 64px image is encoded to 16x16 x 4gf (``encoder``); the CA net's c
    and the per-object label embedding of [c || one-hot], pasted into the
    stage-1 boxes on a 16x16 canvas, join it (``hr_joint``), then R_NUM
    ResBlocks (``residual``). The object pathway crops each stage-2 box of
    that map to 16x16, adds the label tiled, upsamples twice (``local1``,
    ``local2``) and places it into its box on a 64x64 canvas (K3); the
    global pathway upsamples to 64x64 (``upsample1``, ``upsample2``), takes
    the placed objects beside it and upsamples to 256x256 (``upsample3``,
    ``upsample4``, ``img``). ``eps`` None gives c = mu.
    """

    def __init__(self, cfg: Stage1Config):
        super().__init__()
        self.cfg = cfg
        ngf, ef = cfg.gf_dim, cfg.condition_dim
        dt, groups = cfg.compute_dtype, cfg.bn_groups
        bn = functools.partial(BatchNorm2d, groups=groups)
        object_bn = functools.partial(ObjectBatchNorm2d,
                                      n_objects=cfg.num_objects,
                                      groups=groups)
        self.encoder = nn.Sequential(
            Conv3x3(cfg.img_channels, ngf, compute_dtype=dt),
            nn.ReLU(True),
            _down(ngf, ngf * 2, 2, dt), bn(ngf * 2), nn.ReLU(True),
            _down(ngf * 2, ngf * 4, 2, dt), bn(ngf * 4), nn.ReLU(True))
        self.ca_net = CANet(cfg.text_dim, ef, dt)
        self.label = LabelEmbed(ef + cfg.label_dim, ef, cfg.num_objects, dt,
                                groups)
        joint_in = ngf * 4 + ef + (ef if cfg.use_bbox_layout else 0)
        self.hr_joint = nn.Sequential(
            Conv3x3(joint_in, ngf * 4, compute_dtype=dt), bn(ngf * 4),
            nn.ReLU(True))
        self.residual = nn.Sequential(*(ResBlock(ngf * 4, dt, groups)
                                        for _ in range(cfg.r_num)))
        self.local1 = UpBlock(ngf * 4 + ef, ngf * 2, object_bn, dt)
        self.local2 = UpBlock(ngf * 2, ngf, object_bn, dt)
        self.upsample1 = UpBlock(ngf * 4, ngf * 2, bn, dt)
        self.upsample2 = UpBlock(ngf * 2, ngf, bn, dt)
        self.upsample3 = UpBlock(ngf * 2, ngf // 2, bn, dt)
        self.upsample4 = UpBlock(ngf // 2, ngf // 4, bn, dt)
        self.img = nn.Sequential(
            Conv3x3(ngf // 4, cfg.img_channels, compute_dtype=dt), nn.Tanh())

    def outputs(self, stage1_img: torch.Tensor, bbox_s1: torch.Tensor,
                bbox_s2: torch.Tensor, label_onehot: torch.Tensor,
                text_embedding: torch.Tensor,
                eps: Optional[torch.Tensor] = None) -> Stage1GOutput:
        b, o, _ = label_onehot.shape
        encoded = self.encoder(stage1_img.detach())           # 16x16
        c_code, mu, logvar = self.ca_net(text_embedding, eps)
        ef = c_code.shape[1]
        labels = self.label(torch.cat(
            [c_code[:, None, :].expand(b, o, ef),
             label_onehot.to(c_code.dtype)], dim=2))          # (B, O, ef)
        parts = [encoded, c_code[:, :, None, None].expand(b, ef, 16, 16)]
        if self.cfg.use_bbox_layout:
            # the label layout on the stage-1 boxes (model.py:393-403)
            parts.append(stn_place_const_multi(labels, bbox_s1, (16, 16))
                         .permute(0, 3, 1, 2))
        h = self.residual(self.hr_joint(torch.cat(parts, dim=1)))

        # the object pathway on the stage-2 boxes (model.py:411-429)
        patches = stn_extract_multi_nchw(h, bbox_s2, (16, 16))
        patches = patches.reshape((b * o,) + patches.shape[2:])
        lab = labels.reshape(b * o, ef, 1, 1).expand(b * o, ef, 16, 16)
        x = self.local2(self.local1(torch.cat([patches, lab], dim=1)))
        x = x.reshape((b, o) + x.shape[1:])                   # 64x64
        h_locals = stn_place_multi_nchw(x, bbox_s2.contiguous(), (64, 64))

        h = self.upsample2(self.upsample1(h))                 # 64x64
        h = torch.cat([h, h_locals], dim=1)
        h = self.upsample4(self.upsample3(h))                 # 256x256
        return Stage1GOutput(self.img(h), mu, logvar)

    def forward(self, stage1_img: torch.Tensor, bbox_s1: torch.Tensor,
                bbox_s2: torch.Tensor, label_onehot: torch.Tensor,
                text_embedding: torch.Tensor,
                eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.outputs(stage1_img, bbox_s1, bbox_s2, label_onehot,
                            text_embedding, eps).img


class Stage2D(nn.Module):
    """256px discriminator: a 32x32 object pathway, conv1-8 to a
    (B, 8 * df, 4, 4) map, and the conditional and unconditional heads.

    ``forward(image (B, 3, 256, 256), labels (B, O, L), bbox (B, O, 4))``
    returns the feature map. The object pathway crops each box to 32x32,
    adds the label tiled, runs two conv4x4/s1/p1 + BN + LeakyReLU 0.2
    (``local.{0,1}``, ``local.{3,4}``; 32 -> 31 -> 30) and places the
    result into its box on a 32x32 canvas (K3), which joins the global
    pathway after ``conv3`` (6 * df channels).
    """

    def __init__(self, cfg: Stage1Config):
        super().__init__()
        self.cfg = cfg
        ndf = cfg.df_dim
        dt, groups = cfg.compute_dtype, cfg.bn_groups
        object_bn = functools.partial(ObjectBatchNorm2d,
                                      n_objects=cfg.num_objects,
                                      groups=groups)
        self.local = nn.Sequential(
            _down(cfg.img_channels + cfg.label_dim, ndf * 2, 1, dt),
            object_bn(ndf * 2), nn.LeakyReLU(0.2, inplace=True),
            _down(ndf * 2, ndf * 2, 1, dt), object_bn(ndf * 2),
            nn.LeakyReLU(0.2, inplace=True))
        self.conv1 = _down(cfg.img_channels, ndf, 2, dt)      # 128
        self.conv2 = _down(ndf, ndf * 2, 2, dt)               # 64
        self.conv3 = _down(ndf * 2, ndf * 4, 2, dt)           # 32
        self.conv4 = _down(ndf * 6, ndf * 8, 2, dt)           # 16
        self.conv5 = _down(ndf * 8, ndf * 16, 2, dt)          # 8
        self.conv6 = _down(ndf * 16, ndf * 32, 2, dt)         # 4
        self.conv7 = Conv3x3(ndf * 32, ndf * 16, compute_dtype=dt)
        self.conv8 = Conv3x3(ndf * 16, ndf * 8, compute_dtype=dt)
        for i, mult in zip(range(2, 9), (2, 4, 8, 16, 32, 16, 8)):
            setattr(self, f"bn{i}", BatchNorm2d(ndf * mult, groups=groups))
        self.act = nn.LeakyReLU(0.2, inplace=True)
        self.get_cond_logits = DGetLogits(ndf, cfg.d_cond_dim, dt, groups)
        self.get_uncond_logits = DGetLogits(ndf, 0, dt, groups)

    def forward(self, image: torch.Tensor, labels: torch.Tensor,
                bbox: torch.Tensor) -> torch.Tensor:
        b, o, n = labels.shape
        patches = stn_extract_multi_nchw(image, bbox, (32, 32))
        patches = patches.reshape((b * o,) + patches.shape[2:])
        lab = labels.reshape(b * o, n, 1, 1).expand(b * o, n, 32, 32)
        x = self.local(torch.cat([patches, lab], dim=1))      # 30x30
        x = x.reshape((b, o) + x.shape[1:])
        h_locals = stn_place_multi_nchw(x, bbox.contiguous(), (32, 32))

        h = self.act(self.conv1(image))
        h = self.act(self.bn2(self.conv2(h)))
        h = self.act(self.bn3(self.conv3(h)))
        h = torch.cat([h, h_locals], dim=1)
        for i in range(4, 9):
            h = self.act(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h)))
        return h

    def cond_logits(self, h_code: torch.Tensor,
                    c_code: torch.Tensor) -> torch.Tensor:
        return self.get_cond_logits(h_code, c_code)

    def uncond_logits(self, h_code: torch.Tensor) -> torch.Tensor:
        return self.get_uncond_logits(h_code)


def build_stage2_g(cfg: Stage1Config, state_dict=None, *, seed: int = 0,
                   device="cuda") -> Stage2G:
    """An eval-mode Stage2G on ``device``: ``state_dict`` (the reference's
    stage-2 keys, without ``STAGE1_G.``) loaded with strict=True, or the
    reference's random init from ``seed``."""
    return _build(Stage2G(cfg), state_dict, seed, device)


def build_stage2_d(cfg: Stage1Config, state_dict=None, *, seed: int = 0,
                   device="cuda") -> Stage2D:
    """An eval-mode Stage2D on ``device``, as :func:`build_stage2_g`."""
    return _build(Stage2D(cfg), state_dict, seed, device)
