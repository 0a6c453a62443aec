"""Stage-1 (64px) generator and discriminator (port of the JAX
``models/stage1.py``), one family for mnist, clevr and coco-stackgan-1.

Reference STAGE1_G: code/multi-mnist/model.py:113-190,
code/clevr/model.py:113-192, code/coco/stackgan/model.py:147-235;
STAGE1_D: code/multi-mnist/model.py:193-257, code/clevr/model.py:196-260,
code/coco/stackgan/model.py:238-307. Modules and state-dict keys are the
reference's, so a
reference ``.pth`` and the JAX package's export load with ``strict=True``.
Both run in train and eval mode; in train mode the object pathways keep
the reference's per-object BatchNorm statistics (``ObjectBatchNorm2d``).
The config's ``compute_dtype`` is the dtype of every conv and linear (and
so of the activations: a bf16 ``Stage1G`` returns a bf16 image), and its
``bn_groups`` the statistic groups of every BatchNorm (``nn/blocks.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch import nn

from multiple_objects_gan_tpu_torch import resolve_device
from multiple_objects_gan_tpu_torch.io.weights import reference_init_
from multiple_objects_gan_tpu_torch.models.common import Stage1Config
from multiple_objects_gan_tpu_torch.nn.blocks import (
    BatchNorm1d, BatchNorm2d, Conv2d, Conv3x3, Linear, ObjectBatchNorm2d,
    UpBlock)
from multiple_objects_gan_tpu_torch.nn.pathways import (
    CANet, DGetLogits, LabelEmbed, LayoutEncoder, ObjectPathwayD,
    object_pathway_g)


class Stage1GOutput(NamedTuple):
    """What one generator forward gives (the JAX ``Stage1G``'s dict):
    the image, and under the CA net mu and logvar for the KL and the D
    condition (None otherwise)."""
    img: torch.Tensor
    mu: Optional[torch.Tensor] = None
    logvar: Optional[torch.Tensor] = None


class Stage1G(nn.Module):
    """64px generator: object pathway + layout encoding + global pathway.

    forward(z (B, z_dim), bbox (B, O, 4), label_onehot (B, O, L),
    text_embedding (B, text_dim) or None, eps (B, c_dim) or None)
    -> image (B, img_channels, 64, 64) in [-1, 1]; :meth:`outputs` takes
    the same and returns :class:`Stage1GOutput`, with mu and logvar.

    clevr and coco-stackgan-1 embed each object's label (``label``,
    :class:`LabelEmbed`) before the object pathway and the layout encoder;
    coco-stackgan-1 first draws the condition c from the text embedding
    (``ca_net``, :class:`CANet`; ``eps`` None gives c = mu), embeds
    [c || one-hot] per object and feeds z || c || layout code to the global
    pathway (JAX ``models/stage1.py:53-105``).
    """

    def __init__(self, cfg: Stage1Config):
        super().__init__()
        self.cfg = cfg
        ngf = cfg.ngf
        nz = cfg.z_dim + cfg.layout_code_dim + (
            cfg.condition_dim if cfg.use_ca else 0)
        dt, groups = cfg.compute_dtype, cfg.bn_groups
        if cfg.use_ca:
            self.ca_net = CANet(cfg.text_dim, cfg.condition_dim, dt)
        self.fc = nn.Sequential(
            Linear(nz, ngf * 4 * 4, bias=False, compute_dtype=dt),
            BatchNorm1d(ngf * 4 * 4, groups=groups),
            nn.ReLU(True))
        object_bn = functools.partial(ObjectBatchNorm2d,
                                      n_objects=cfg.num_objects,
                                      groups=groups)
        bn = functools.partial(BatchNorm2d, groups=groups)
        self.local1 = UpBlock(cfg.object_dim, ngf // 2, object_bn, dt)
        self.local2 = UpBlock(ngf // 2, ngf // 4, object_bn, dt)
        if cfg.use_bbox_layout:
            self.bbox_net = LayoutEncoder(cfg.object_dim, cfg.condition_dim,
                                          dt, groups)
        self.upsample1 = UpBlock(ngf, ngf // 2, bn, dt)
        self.upsample2 = UpBlock(ngf // 2, ngf // 4, bn, dt)
        self.upsample3 = UpBlock(ngf // 2, ngf // 8, bn, dt)
        self.upsample4 = UpBlock(ngf // 8, ngf // 16, bn, dt)
        self.img = nn.Sequential(
            Conv3x3(ngf // 16, cfg.img_channels, compute_dtype=dt),
            nn.Tanh())
        if cfg.use_label_embed:
            lab_in = cfg.label_dim + (cfg.condition_dim if cfg.use_ca else 0)
            self.label = LabelEmbed(lab_in, cfg.condition_dim,
                                    cfg.num_objects, dt, groups)
        else:
            # The mnist reference defines this label module and never calls
            # it (model.py:137-140). It stays, unused in forward, only so
            # that reference checkpoints load with strict=True.
            self.label = nn.Sequential(
                nn.Linear(cfg.label_dim, cfg.label_dim, bias=False),
                nn.BatchNorm1d(cfg.label_dim))

    def outputs(self, z: torch.Tensor, bbox: torch.Tensor,
                label_onehot: torch.Tensor,
                text_embedding: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None) -> Stage1GOutput:
        cfg = self.cfg
        mu = logvar = c_code = None
        lab_in = label_onehot
        if cfg.use_ca:
            if text_embedding is None:
                raise ValueError(f"{cfg.variant}: the generator needs a "
                                 "text embedding")
            c_code, mu, logvar = self.ca_net(text_embedding, eps)
            b, o, _ = label_onehot.shape
            # stackgan model.py:203: [c || one-hot] per object
            lab_in = torch.cat([c_code[:, None, :].expand(b, o, -1),
                                label_onehot.to(c_code.dtype)], dim=2)
        local_labels = self.label(lab_in) if cfg.use_label_embed \
            else label_onehot
        h_local = object_pathway_g(local_labels, bbox, self.local1,
                                   self.local2)
        parts = [z] + ([c_code] if cfg.use_ca else [])
        if cfg.use_bbox_layout:
            parts.append(self.bbox_net(local_labels, bbox))
        # reference .view(-1, ngf, 4, 4): the fc output is CHW-ordered
        h = self.fc(torch.cat(parts, dim=1)).view(-1, cfg.ngf, 4, 4)
        h = self.upsample2(self.upsample1(h))                  # 16x16
        h = torch.cat([h, h_local], dim=1)
        h = self.upsample4(self.upsample3(h))                  # 64x64
        return Stage1GOutput(self.img(h), mu, logvar)

    def forward(self, z: torch.Tensor, bbox: torch.Tensor,
                label_onehot: torch.Tensor,
                text_embedding: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.outputs(z, bbox, label_onehot, text_embedding, eps).img


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
