"""The AttnGAN multi-stage generator, 64 -> 128 -> 256px, and its three
discriminators (port of the JAX ``models/attngan.py``: ``AttnGanConfig``,
``GNet`` and its stages, ``DNet64``, ``DNetScale``, ``AttnDGetLogits``).

Reference G_NET (code/coco/attngan/model.py:478-528):

* CA_NET (:317-345): fc to 4 * c_dim with a GLU, c = mu in eval;
* INIT_STAGE_G (:348-422), ``h_net1``: the per-object label embedding of
  [c || one-hot(81)] (``label``), the object pathway (``local1``,
  ``local2``: two GLU upBlocks from 4x4 to 16x16, each object placed into
  its box on a 16x16 canvas by K1 and summed), the layout code
  (``bbox_net``), fc(z || c || layout code) with a GLU, and four GLU
  upBlocks to 64x64, the object pathway joining the global one at 16x16;
* NEXT_STAGE_G (:425-461), ``h_net2`` and ``h_net3``: word attention
  (``att``), R_NUM GLU ResBlocks (``residual``) and an upBlock, 64 -> 128
  and 128 -> 256;
* GET_IMAGE_G (:464-475), ``img_net{1,2,3}``: conv3x3 to RGB and tanh.

Modules and state-dict keys are the reference's, so the reference's
``netG`` and the JAX package's export load with strict=True. The widths:
``ngf = gf_dim * 16`` at the init stage (768 at cfg/coco_attn_train.yml's
GF 48), ``gf_dim`` after it. The object pathway's BatchNorms and the label
embedding's keep the reference's per-object statistics in train mode
(``ObjectBatchNorm2d``, ``ObjectBatchNorm1d``).

Reference D_NET64 (:646-711): the global path, four conv4x4/s2 (64 ->
4), with the object pathway (``local``: each object's 16x16 patch of the
image and its one-hot label, conv4x4/s1/p1 to 15x15, per-object BatchNorm
and LeakyReLU, placed into its box on a 16x16 canvas by K1 and summed)
joining at 16x16; D_NET128 and D_NET256 (:715-760): encode_image_by_16times
and downBlocks to 4x4 and Block3x3_leakRelu back to 8 * ndf, no object
pathway. Each has the conditional head ``COND_DNET`` (the 4x4 features and
the sentence embedding tiled to 4x4, Block3x3_leakRelu ``jointConv``, then
conv4x4/s4 and a sigmoid) and the unconditional ``UNCOND_DNET`` (conv4x4/s4
and a sigmoid): the heads give probabilities (D_GET_LOGITS, :616-642), and
the train step takes a plain BCE of them.

``compute_dtype`` (the JAX package's ``set_compute_dtype``) reaches the
layers that honour it there: every conv (its ``conv_dt``, ``Conv3x3`` and
``UpConv3x3``) and the CA net's fc (its ``blocks.Dense``). The label
embedding's and the init stage's fc are plain ``nn.Dense`` in the JAX
package and the word attention is float32, so they run in float32 here
too; their inputs are promoted to float32 as JAX promotes them, and a
stage's residual stream, which adds a float32 context, is float32 between
its ResBlocks. ``bn_groups`` (the JAX package's ``set_bn_groups``, whose
knob reaches every ``TorchBatchNorm`` of G and the Ds) sets the statistic
groups of every BatchNorm of G and of each D (``nn/blocks.py:
set_bn_groups``); the DAMSM encoders keep theirs, as they run in eval
mode.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch
from torch import nn

from multiple_objects_gan_tpu_torch import resolve_device
from multiple_objects_gan_tpu_torch.nn.attention import GlobalAttention
from multiple_objects_gan_tpu_torch.nn.blocks import (
    GLU, BatchNorm1d, BatchNorm2d, Block3x3LeakReLU, Conv2d, Conv3x3,
    DownBlock, EncodeImageBy16Times, Linear, ObjectBatchNorm2d, ResBlockGLU,
    UpBlockGLU, set_bn_groups)
from multiple_objects_gan_tpu_torch.nn.pathways import (
    CANet, LabelEmbed, LayoutEncoder, ObjectPathwayD, object_pathway_g)


@dataclasses.dataclass(frozen=True)
class AttnGanConfig:
    gf_dim: int = 48           # cfg/coco_attn_train.yml GAN.GF_DIM
    df_dim: int = 96
    z_dim: int = 100
    condition_dim: int = 100   # GAN.CONDITION_DIM
    embedding_dim: int = 256   # TEXT.EMBEDDING_DIM (nef)
    label_dim: int = 81
    num_objects: int = 3       # MAX_OBJECTS (model.py:14)
    branch_num: int = 3        # TREE.BRANCH_NUM
    r_num: int = 3             # GAN.R_NUM
    b_dcgan: bool = False
    # the JAX package's COMPUTE_DTYPE knob, as in Stage1Config
    compute_dtype: Optional[torch.dtype] = None
    # the JAX package's BN_GROUPS knob: every BatchNorm of G and the Ds
    bn_groups: int = 1

    @property
    def ngf(self) -> int:
        """The init stage's width (model.py:354: GF_DIM * 16)."""
        return self.gf_dim * 16

    @property
    def layout_code_dim(self) -> int:
        return (self.condition_dim // 8) * 2 * 2


COCO_ATTN = AttnGanConfig()


class AttnGanGOutput(NamedTuple):
    """What one G_NET forward gives (the JAX ``GNet``'s dict): the image
    of every branch, 64px first; the attention maps of the next stages,
    each (B, H, W, L); and the CA net's mu and logvar."""
    imgs: list
    att_maps: list
    mu: torch.Tensor
    logvar: torch.Tensor


class InitStageG(nn.Module):
    """INIT_STAGE_G, ``h_net1``: (z, c, bbox, one-hots) -> (B, gf_dim, 64,
    64)."""

    def __init__(self, cfg: AttnGanConfig):
        super().__init__()
        self.cfg = cfg
        ngf, ef, dt = cfg.ngf, cfg.condition_dim, cfg.compute_dtype
        object_bn = functools.partial(ObjectBatchNorm2d,
                                      n_objects=cfg.num_objects)
        self.label = LabelEmbed(ef + cfg.label_dim, ef, cfg.num_objects)
        self.fc = nn.Sequential(
            Linear(cfg.z_dim + ef + cfg.layout_code_dim, ngf * 4 * 4 * 2,
                   bias=False),
            BatchNorm1d(ngf * 4 * 4 * 2),
            GLU())
        self.bbox_net = LayoutEncoder(ef, ef, dt)
        self.local1 = UpBlockGLU(ef, ngf // 2, object_bn, dt)
        self.local2 = UpBlockGLU(ngf // 2, ngf // 4, object_bn, dt)
        self.upsample1 = UpBlockGLU(ngf, ngf // 2, BatchNorm2d, dt)
        self.upsample2 = UpBlockGLU(ngf // 2, ngf // 4, BatchNorm2d, dt)
        self.upsample3 = UpBlockGLU(ngf // 2, ngf // 8, BatchNorm2d, dt)
        self.upsample4 = UpBlockGLU(ngf // 8, ngf // 16, BatchNorm2d, dt)

    def forward(self, z: torch.Tensor, c_code: torch.Tensor,
                bbox: torch.Tensor, label_onehot: torch.Tensor):
        b, o, _ = label_onehot.shape
        lab_in = torch.cat([c_code[:, None, :].expand(b, o, -1),
                            label_onehot], dim=2)
        local_labels = self.label(lab_in)
        h_local = object_pathway_g(local_labels, bbox, self.local1,
                                   self.local2)                # 16x16
        code = torch.cat([c_code, z, self.bbox_net(local_labels, bbox)],
                         dim=1)
        # reference .view(-1, ngf, 4, 4): the fc output is CHW-ordered
        h = self.fc(code).view(b, self.cfg.ngf, 4, 4)
        h = self.upsample2(self.upsample1(h))                  # 16x16
        h = torch.cat([h, h_local], dim=1)
        return self.upsample4(self.upsample3(h))               # 64x64


class NextStageG(nn.Module):
    """NEXT_STAGE_G, ``h_net2``/``h_net3``: word attention, R_NUM GLU
    ResBlocks and an upBlock; (B, gf, H, W) -> (B, gf, 2H, 2W) and the
    (B, H, W, L) attention maps."""

    def __init__(self, cfg: AttnGanConfig):
        super().__init__()
        ngf, dt = cfg.gf_dim, cfg.compute_dtype
        self.att = GlobalAttention(ngf, cfg.embedding_dim)
        self.residual = nn.Sequential(*[ResBlockGLU(ngf * 2, dt)
                                        for _ in range(cfg.r_num)])
        self.upsample = UpBlockGLU(ngf * 2, ngf, BatchNorm2d, dt)

    def forward(self, h_code: torch.Tensor, word_embs: torch.Tensor,
                mask: Optional[torch.Tensor]):
        context, att = self.att(h_code, word_embs, mask)
        h = self.residual(torch.cat([h_code, context], dim=1))
        return self.upsample(h), att


class GetImageG(nn.Module):
    """GET_IMAGE_G, ``img_net{1,2,3}``: conv3x3 to RGB, tanh."""

    def __init__(self, ngf: int, compute_dtype=None):
        super().__init__()
        self.img = nn.Sequential(Conv3x3(ngf, 3, compute_dtype=compute_dtype),
                                 nn.Tanh())

    def forward(self, h_code: torch.Tensor) -> torch.Tensor:
        return self.img(h_code)


class GNet(nn.Module):
    """G_NET at ``cfg.branch_num`` branches.

    ``outputs(z (B, z_dim), sent_emb (B, nef), word_embs (B, L, nef), mask
    (B, L) bool (True at padding) or None, bbox (B, O, 4), label_onehot
    (B, O, 81), eps (B, condition_dim) or None)`` returns
    :class:`AttnGanGOutput`; ``forward`` takes the same and returns the
    last branch's image, in the compute dtype. The condition is c = mu +
    eps * exp(logvar / 2) (the reference's CA_NET.reparametrize, which the
    train step draws), or c = mu without ``eps``, as the JAX service's
    ``ca_rng=None``.
    """

    def __init__(self, cfg: AttnGanConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.ca_net = CANet(cfg.embedding_dim, cfg.condition_dim, dt,
                            use_glu=True)
        self.h_net1 = InitStageG(cfg)
        self.img_net1 = GetImageG(cfg.gf_dim, dt)
        for i in range(2, cfg.branch_num + 1):
            setattr(self, f"h_net{i}", NextStageG(cfg))
            setattr(self, f"img_net{i}", GetImageG(cfg.gf_dim, dt))
        set_bn_groups(self, cfg.bn_groups)

    def outputs(self, z, sent_emb, word_embs, mask, bbox, label_onehot,
                eps: Optional[torch.Tensor] = None) -> AttnGanGOutput:
        c_code, mu, logvar = self.ca_net(sent_emb, eps)
        h = self.h_net1(z, c_code, bbox, label_onehot)
        imgs, att_maps = [self.img_net1(h)], []
        for i in range(2, self.cfg.branch_num + 1):
            h, att = getattr(self, f"h_net{i}")(h, word_embs, mask)
            imgs.append(getattr(self, f"img_net{i}")(h))
            att_maps.append(att)
        if self.cfg.b_dcgan:
            imgs = imgs[-1:]           # the single-head ablation (G_DCGAN)
        return AttnGanGOutput(imgs, att_maps, mu, logvar)

    def forward(self, z, sent_emb, word_embs, mask, bbox, label_onehot,
                eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.outputs(z, sent_emb, word_embs, mask, bbox,
                            label_onehot, eps).imgs[-1]


class AttnDGetLogits(nn.Module):
    """D_GET_LOGITS (model.py:616-642; JAX ``AttnDGetLogits``): one
    probability a sample from the (B, 8 * ndf, 4, 4) features. With
    ``bcondition`` the sentence embedding (B, nef) is tiled to 4x4 and
    concatenated first, then ``jointConv``. Keys ``jointConv.{0,1}`` and
    ``outlogits.0``. The sigmoid runs in the compute dtype, as in the JAX
    package; the loss takes the probabilities in float32."""

    def __init__(self, ndf: int, nef: int, bcondition: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.bcondition = bcondition
        if bcondition:
            self.jointConv = Block3x3LeakReLU(ndf * 8 + nef, ndf * 8,
                                              compute_dtype)
        self.outlogits = nn.Sequential(
            Conv2d(ndf * 8, 1, kernel_size=4, stride=4,
                   compute_dtype=compute_dtype),
            nn.Sigmoid())

    def forward(self, h_code: torch.Tensor,
                c_code: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = h_code
        if self.bcondition and c_code is not None:
            b, d = c_code.shape
            c = c_code.to(x.dtype).reshape(b, d, 1, 1).expand(b, d, 4, 4)
            x = self.jointConv(torch.cat([x, c], dim=1))
        return self.outlogits(x).reshape(-1)


class _AttnD(nn.Module):
    """The two heads every AttnGAN D has (``COND_DNET``, ``UNCOND_DNET``)
    and the train step's calls of them."""

    def _heads(self, cfg: AttnGanConfig):
        dt = cfg.compute_dtype
        self.COND_DNET = AttnDGetLogits(cfg.df_dim, cfg.embedding_dim, True,
                                        dt)
        self.UNCOND_DNET = AttnDGetLogits(cfg.df_dim, cfg.embedding_dim,
                                          False, dt)
        set_bn_groups(self, cfg.bn_groups)     # the D's last modules

    def cond_logits(self, h_code: torch.Tensor,
                    c_code: torch.Tensor) -> torch.Tensor:
        return self.COND_DNET(h_code, c_code)

    def uncond_logits(self, h_code: torch.Tensor) -> torch.Tensor:
        return self.UNCOND_DNET(h_code)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.leaky_relu(x, 0.2)


class DNet64(_AttnD):
    """D_NET64 with its object pathway: ``forward(image (B, 3, 64, 64),
    labels (B, O, 81), bbox (B, O, 4))`` -> (B, 8 * ndf, 4, 4). Keys
    ``local.{0,1}``, ``conv{1..4}``, ``bn{2,3,4}`` and the heads'."""

    def __init__(self, cfg: AttnGanConfig):
        super().__init__()
        ndf, dt = cfg.df_dim, cfg.compute_dtype

        def down(cin, cout):
            return Conv2d(cin, cout, kernel_size=4, stride=2, padding=1,
                          bias=False, compute_dtype=dt)

        self.local = ObjectPathwayD(ndf, 3, cfg.label_dim, cfg.num_objects,
                                    dt)
        self.conv1 = down(3, ndf)
        self.conv2 = down(ndf, ndf * 2)
        self.bn2 = BatchNorm2d(ndf * 2)
        self.conv3 = down(ndf * 4, ndf * 4)
        self.bn3 = BatchNorm2d(ndf * 4)
        self.conv4 = down(ndf * 4, ndf * 8)
        self.bn4 = BatchNorm2d(ndf * 8)
        self._heads(cfg)

    def forward(self, image: torch.Tensor, labels: torch.Tensor,
                bbox: torch.Tensor) -> torch.Tensor:
        h_local = self.local(image, labels, bbox)             # 16x16, K1
        h = _lrelu(self.conv1(image))                         # 32x32
        h = _lrelu(self.bn2(self.conv2(h)))                   # 16x16
        h = torch.cat([h, h_local], dim=1)
        h = _lrelu(self.bn3(self.conv3(h)))                   # 8x8
        return _lrelu(self.bn4(self.conv4(h)))                # 4x4


class DNetScale(_AttnD):
    """D_NET128 (``scale`` 128) or D_NET256 (256), without an object
    pathway: ``forward(image (B, 3, scale, scale), labels=None,
    bbox=None)`` -> (B, 8 * ndf, 4, 4). Keys ``img_code_s16``,
    ``img_code_s32``, then ``img_code_s32_1`` (128) or ``img_code_s64``,
    ``img_code_s64_1``, ``img_code_s64_2`` (256), and the heads'."""

    def __init__(self, cfg: AttnGanConfig, scale: int = 128):
        super().__init__()
        if scale not in (128, 256):
            raise ValueError(f"DNetScale takes 128 or 256, got {scale}")
        self.scale = scale
        ndf, dt = cfg.df_dim, cfg.compute_dtype
        self.img_code_s16 = EncodeImageBy16Times(ndf, dt)
        self.img_code_s32 = DownBlock(ndf * 8, ndf * 16, dt)
        if scale == 128:
            self.img_code_s32_1 = Block3x3LeakReLU(ndf * 16, ndf * 8, dt)
        else:
            self.img_code_s64 = DownBlock(ndf * 16, ndf * 32, dt)
            self.img_code_s64_1 = Block3x3LeakReLU(ndf * 32, ndf * 16, dt)
            self.img_code_s64_2 = Block3x3LeakReLU(ndf * 16, ndf * 8, dt)
        self._heads(cfg)

    def forward(self, image: torch.Tensor, labels=None,
                bbox=None) -> torch.Tensor:
        h = self.img_code_s32(self.img_code_s16(image))
        if self.scale == 128:
            return self.img_code_s32_1(h)
        return self.img_code_s64_2(self.img_code_s64_1(self.img_code_s64(h)))


D_NAMES = ("d64", "d128", "d256")    # a D a branch, the JAX state's keys


def _orthogonal_(weight: torch.Tensor, gen: torch.Generator,
                 qr_device) -> None:
    """``nn.init.orthogonal_(weight, 1.0, generator=gen)``, with its QR
    factorization on ``qr_device``: the normal draw stays on the CPU
    generator, so the card gets the CPU's matrix up to the
    QR's rounding, and D256's 3072 x 24576 factorization takes a fraction
    of a second there instead of seconds on the host."""
    rows = weight.shape[0]
    flat = weight.new_empty((rows, weight.numel() // rows)).normal_(
        0, 1, generator=gen)
    if rows < flat.shape[1]:
        flat.t_()
    q, r = torch.linalg.qr(flat.to(qr_device))
    q *= torch.diag(r, 0).sign()
    if rows < weight.numel() // rows:
        q.t_()
    weight.view_as(q).copy_(q.to(weight.device))


def attngan_init_(model: nn.Module, seed: int, qr_device) -> None:
    """AttnGAN's weights_init (code/coco/attngan/miscc/utils.py:321-331)
    from ``seed``: conv and linear weights orthogonal (gain 1; the QR on
    ``qr_device``, :func:`_orthogonal_`), linear biases 0, BatchNorm weight
    N(1, 0.02) and bias 0, running statistics mean 0, var 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                _orthogonal_(m.weight, gen, qr_device)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                m.weight.normal_(1.0, 0.02, generator=gen)
                m.bias.zero_()
                m.reset_running_stats()


def build_attngan_g(cfg: AttnGanConfig = COCO_ATTN, state_dict=None, *,
                    seed: int = 0, device="cuda") -> GNet:
    """An eval-mode GNet on ``device``: ``state_dict`` (reference keys)
    loaded with strict=True, or :func:`attngan_init_` from ``seed`` (its
    QR on ``device``) when there is none."""
    dev = resolve_device(device)
    model = GNet(cfg)
    if state_dict is None:
        attngan_init_(model, seed, dev)
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.to(dev).eval()


def build_attngan_d(cfg: AttnGanConfig, scale: int, state_dict=None, *,
                    seed: int = 0, device="cuda") -> nn.Module:
    """``DNet64`` (``scale`` 64) or ``DNetScale`` on ``device``:
    ``state_dict`` (the reference's ``netD{i}.pth`` keys) loaded with
    strict=True, or :func:`attngan_init_` from ``seed``."""
    dev = resolve_device(device)
    model = DNet64(cfg) if scale == 64 else DNetScale(cfg, scale)
    if state_dict is None:
        attngan_init_(model, seed, dev)
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.to(dev)
