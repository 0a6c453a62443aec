"""Stage-1 pathways and the D logit head, NCHW (port of the JAX
``nn/pathways.py``).

Reference: BBOX_NET (code/multi-mnist/model.py:80-110), the G object
pathway (model.py:160-169), the D object pathway (model.py:225-234),
D_GET_LOGITS (model.py:43-70), the label embedding (code/clevr/
model.py:138-141, code/coco/stackgan/model.py:200-203) and CA_NET
(code/coco/stackgan/model.py:44-72; AttnGAN's GLU form,
code/coco/attngan/model.py:317-345). The reference loops over objects; here the
objects fold into the batch, (B, O) with O minor, and one kernel launch
places and sums them all. The fold keeps the reference's statistics:
eval-mode BatchNorm is per sample, and in train mode the object pathways'
BatchNorms (and the label embedding's) keep per-object statistics
(:class:`~multiple_objects_gan_tpu_torch.nn.blocks.ObjectBatchNorm2d`,
:class:`~multiple_objects_gan_tpu_torch.nn.blocks.ObjectBatchNorm1d`).
Every module takes the model config's ``compute_dtype`` for its convs and
``bn_groups`` for its BatchNorms (``nn/blocks.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multiple_objects_gan_tpu_torch.nn.blocks import (
    BatchNorm2d, Conv2d, Conv3x3, Linear, ObjectBatchNorm1d,
    ObjectBatchNorm2d, UpBlock, glu)
from multiple_objects_gan_tpu_torch.ops.stn import (
    stn_extract_multi_nchw, stn_place_const_multi)
from multiple_objects_gan_tpu_torch.ops.stn_place_cuda import (
    stn_place_multi_nchw)


class LabelEmbed(nn.Sequential):
    """The per-object label embedding (JAX ``LabelEmbed``): Linear without
    bias, BatchNorm1d, ReLU; keys ``label.0`` and ``label.1``.

    labels (B, O, in_dim) -> (B, O, features). In train mode its BatchNorm
    takes per-object statistics with O running updates a forward
    (:class:`ObjectBatchNorm1d`), as the reference's per-object loop does
    (code/coco/stackgan/model.py:201-214) and as the JAX body computes
    under ``object_fold``; its docstring's "BN pools stats over B*O"
    (nn/pathways.py:53-54 of the JAX package) is not what its code does.
    """

    def __init__(self, in_dim: int, features: int, n_objects: int,
                 compute_dtype: Optional[torch.dtype] = None,
                 bn_groups: int = 1):
        super().__init__(
            Linear(in_dim, features, bias=False, compute_dtype=compute_dtype),
            ObjectBatchNorm1d(features, n_objects, groups=bn_groups),
            nn.ReLU(True))

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        b, o, d = labels.shape
        x = super().forward(labels.reshape(b * o, d))
        return x.reshape(b, o, -1)


class CANet(nn.Module):
    """Conditioning augmentation (JAX ``CANet``): ``fc`` (text_dim ->
    2 * c_dim, with bias) + ReLU, as StackGAN's (code/coco/stackgan/
    model.py:44-72), or with ``use_glu`` AttnGAN's ``fc`` (text_dim ->
    4 * c_dim) + GLU (code/coco/attngan/model.py:317-345); then split into
    mu and logvar, c = mu + eps * exp(logvar / 2). Key ``ca_net.fc``.

    ``forward(text (B, text_dim), eps (B, c_dim) or None)`` returns
    (c, mu, logvar). Without ``eps`` (eval) c = mu, as the JAX package's
    sampling without a CA rng. The caller draws ``eps`` (the train step
    from its generator, or replays it); it is cast to mu's dtype, so under
    a bf16 compute dtype c is bf16, as in the JAX package, while the KL
    takes mu and logvar in float32 (``losses/gan.py:kl_loss``).
    """

    def __init__(self, text_dim: int, c_dim: int,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_glu: bool = False):
        super().__init__()
        self.c_dim, self.use_glu = c_dim, use_glu
        self.fc = Linear(text_dim, (4 if use_glu else 2) * c_dim,
                         compute_dtype=compute_dtype)

    def forward(self, text: torch.Tensor, eps: Optional[torch.Tensor] = None):
        x = glu(self.fc(text)) if self.use_glu else torch.relu(self.fc(text))
        mu, logvar = x[:, :self.c_dim], x[:, self.c_dim:]
        if eps is None:
            return mu, mu, logvar
        return mu + eps.to(mu.dtype) * torch.exp(0.5 * logvar), mu, logvar


class LayoutEncoder(nn.Module):
    """BBOX_NET: paste each object's label vector into its box on a 16x16
    canvas, encode with three stride-2 conv3x3 (the first without BN) and
    flatten in CHW order.

    labels (B, O, label_dim), bbox (B, O, 4) -> (B, (c_dim // 8) * 2 * 2);
    ``label_dim`` is the width of the vectors pasted: the one-hots for
    mnist, the embedded labels (CONDITION_DIM) for clevr and stackgan.
    """

    def __init__(self, label_dim: int, c_dim: int,
                 compute_dtype: Optional[torch.dtype] = None,
                 bn_groups: int = 1):
        super().__init__()
        dt = compute_dtype
        self.encode = nn.Sequential(
            Conv3x3(label_dim, c_dim // 2, stride=2, compute_dtype=dt),
            nn.LeakyReLU(0.2, inplace=True),
            Conv3x3(c_dim // 2, c_dim // 4, stride=2, compute_dtype=dt),
            BatchNorm2d(c_dim // 4, groups=bn_groups),
            nn.LeakyReLU(0.2, inplace=True),
            Conv3x3(c_dim // 4, c_dim // 8, stride=2, compute_dtype=dt),
            BatchNorm2d(c_dim // 8, groups=bn_groups),
            nn.LeakyReLU(0.2, inplace=True))

    def forward(self, labels: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
        layout = stn_place_const_multi(labels, bbox, (16, 16))
        x = self.encode(layout.permute(0, 3, 1, 2))
        return x.reshape(labels.shape[0], -1)


def object_pathway_g(labels: torch.Tensor, bbox: torch.Tensor,
                     local1: nn.Module, local2: nn.Module) -> torch.Tensor:
    """The JAX ``ObjectPathwayG``: per object, tile the label to 4x4, run two
    UpBlocks to 16x16, place into the box and sum over objects.

    labels (B, O, ef), bbox (B, O, 4) -> (B, ngf // 4, 16, 16). A function
    over the two blocks, because the reference keeps ``local1``/``local2``
    on STAGE1_G itself (model.py:135-136), and so do the state-dict keys.
    AttnGAN's (JAX ``ObjectPathwayGLU``, code/coco/attngan/
    model.py:399-410) is this function over two ``UpBlockGLU``s.
    """
    b, o, ef = labels.shape
    x = labels.reshape(b * o, ef, 1, 1).expand(b * o, ef, 4, 4)
    x = local2(local1(x))
    x = x.reshape((b, o) + x.shape[1:])
    return stn_place_multi_nchw(x, bbox.contiguous(), (16, 16))


class ObjectPathwayD(nn.Sequential):
    """The D object pathway (JAX ``ObjectPathwayD``, model.py:225-234): per
    object, extract a 16x16 patch of the image at its box, concatenate the
    label tiled to 16x16, conv4x4/s1/p1 (16 -> 15) + BN + LeakyReLU 0.2,
    place back into the box on a 16x16 canvas through K3 and sum over
    objects.

    image (B, C, H, W), labels (B, O, L), bbox (B, O, 4) ->
    (B, 2 * ndf, 16, 16). The children are the reference's ``local.0``
    (conv) and ``local.1`` (BN) of STAGE1_D.
    """

    def __init__(self, ndf: int, img_channels: int, label_dim: int,
                 n_objects: int, compute_dtype: Optional[torch.dtype] = None,
                 bn_groups: int = 1):
        super().__init__(
            Conv2d(img_channels + label_dim, ndf * 2, kernel_size=4,
                   stride=1, padding=1, bias=False,
                   compute_dtype=compute_dtype),
            ObjectBatchNorm2d(ndf * 2, n_objects, groups=bn_groups),
            nn.LeakyReLU(0.2, inplace=True))

    def forward(self, image: torch.Tensor, labels: torch.Tensor,
                bbox: torch.Tensor) -> torch.Tensor:
        b, o, n = labels.shape
        patches = stn_extract_multi_nchw(image, bbox, (16, 16))
        patches = patches.reshape((b * o,) + patches.shape[2:])
        lab = labels.reshape(b * o, n, 1, 1).expand(b * o, n, 16, 16)
        x = super().forward(torch.cat([patches, lab], dim=1))   # 15x15
        x = x.reshape((b, o) + x.shape[1:])
        return stn_place_multi_nchw(x, bbox.contiguous(), (16, 16))


class DGetLogits(nn.Module):
    """D_GET_LOGITS (JAX ``DGetLogits``, model.py:43-70): one logit per
    sample from the (B, 8 * ndf, 4, 4) feature map.

    Conditional (``cond_dim`` > 0): tile the condition to 4x4, concatenate,
    conv3x3 + BN + LeakyReLU 0.2, then conv4x4/s4 with bias; keys
    ``outlogits.{0,1,3}``. Unconditional (``cond_dim`` 0): the conv4x4/s4
    alone; key ``outlogits.0``.
    """

    def __init__(self, ndf: int, cond_dim: int = 0,
                 compute_dtype: Optional[torch.dtype] = None,
                 bn_groups: int = 1):
        super().__init__()
        self.cond_dim = cond_dim
        final = Conv2d(ndf * 8, 1, kernel_size=4, stride=4,
                       compute_dtype=compute_dtype)
        if cond_dim:
            self.outlogits = nn.Sequential(
                Conv3x3(ndf * 8 + cond_dim, ndf * 8,
                        compute_dtype=compute_dtype),
                BatchNorm2d(ndf * 8, groups=bn_groups),
                nn.LeakyReLU(0.2, inplace=True), final)
        else:
            self.outlogits = nn.Sequential(final)

    def forward(self, h_code: torch.Tensor,
                c_code: torch.Tensor | None = None) -> torch.Tensor:
        x = h_code
        if self.cond_dim:
            b, d = c_code.shape
            c = c_code.reshape(b, d, 1, 1).expand(b, d, 4, 4)
            x = torch.cat([h_code, c], dim=1)
        return self.outlogits(x).reshape(-1)
