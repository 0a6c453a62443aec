"""The DAMSM text and image encoders of AttnGAN (port of the JAX
``nn/encoders.py``: ``RNNEncoder`` and ``CNNEncoder``).

Reference RNN_ENCODER (code/coco/attngan/model.py:120-204): a word
embedding of ``ninput`` (300) and a one-layer bidirectional LSTM with
``nhidden // 2`` (128) units a direction, and ``nn.Dropout(0.5)`` on the
word embedding, which acts in ``train()`` mode only (DAMSM pretraining;
every other path keeps the encoder in ``eval()``). The words' embeddings
are the LSTM's outputs at every step, the sentence's the two directions'
final states side by side.

Lengths are per sentence and the batch needs no sorting: the LSTM runs
over ``pack_padded_sequence(enforce_sorted=False)``, so the forward state
is taken at step len - 1, the backward one at step 0 of the reversed valid
prefix, and the outputs at padded steps are zeros, as the JAX package's
length-masked ``lax.scan`` computes them. Module and key names are the
reference's (``encoder.weight``, ``rnn.{weight,bias}_{ih,hh}_l0`` and
``..._reverse``), so a DAMSM ``text_encoder*.pth`` loads with strict=True.
The encoder runs in float32 whatever the generator's compute dtype, as in
the JAX package.

Reference CNN_ENCODER (code/coco/attngan/model.py:207-313): the
Inception-v3 backbone up to ``Mixed_7c``, written out here (the card's
machine has no torchvision) with torchvision's module names
(``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.running_var``, ...),
which are the keys of a DAMSM ``image_encoder*.pth``; ``emb_features``, a
1x1 conv of ``Mixed_6e``'s 17x17 map to ``nef`` channels, gives the
regions, and ``emb_cnn_code``, a linear map of the pooled 2048 features,
the image code. Each ``BasicConv2d`` is conv (no bias) + BatchNorm (eps
1e-3) + ReLU. The input is resized to 299x299 bilinearly with half-pixel
centres, as ``jax.image.resize`` does from 64 and from 256 (both
upsamples, so no antialiasing; tests/test_torch_port_attngan_d.py holds
``F.interpolate(align_corners=False)`` to it). The backbone's convs compute
in ``compute_dtype``, as the JAX ``BasicConv2d`` follows the global one
(nn/encoders.py:176-186 of the JAX package); the two embeddings and the
outputs are float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from multiple_objects_gan_tpu_torch import resolve_device
from multiple_objects_gan_tpu_torch.nn.blocks import BatchNorm2d, Conv2d

# The embedding dropout's probability: upstream RNN_ENCODER's
# nn.Dropout(0.5), JAX ``RNNEncoder``'s 0.5.
DROP_PROB = 0.5


class RNNEncoder(nn.Module):
    """Bi-LSTM text encoder.

    ``forward(captions (B, T) int64, cap_lens (B,))`` returns (words_emb
    (B, T, nhidden), sent_emb (B, nhidden)); padded word positions are
    zero. Every length must be in 1..T.

    In ``train()`` mode the embedding goes through dropout with
    ``DROP_PROB``: a keep mask of the embedding's shape (B, T, ninput),
    drawn from ``generator`` on the embedding's device, or the ``keep``
    given (the tests pass the JAX mask, ``jax.random.bernoulli(rng, 1 -
    DROP_PROB, shape)``); the kept values are scaled by 1 / (1 -
    DROP_PROB), as JAX ``RNNEncoder(train=True)`` and ``nn.Dropout`` do.
    The LSTM has one layer and so no dropout of its own.
    """

    def __init__(self, ntoken: int, ninput: int = 300, nhidden: int = 256):
        super().__init__()
        self.encoder = nn.Embedding(ntoken, ninput)
        self.rnn = nn.LSTM(ninput, nhidden // 2, num_layers=1,
                           batch_first=True, bidirectional=True)

    def forward(self, captions: torch.Tensor, cap_lens: torch.Tensor, *,
                keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        t = captions.shape[1]
        lens = cap_lens.to("cpu", torch.int64)
        if int(lens.min()) < 1 or int(lens.max()) > t:
            raise ValueError(f"caption lengths must be in 1..{t}, got "
                             f"{lens.tolist()}")
        emb = self.encoder(captions.long())
        if self.training:
            if keep is None:
                keep = torch.rand(emb.shape, generator=generator,
                                  device=emb.device) < 1.0 - DROP_PROB
            emb = torch.where(keep.to(emb.device),
                              emb / (1.0 - DROP_PROB), 0.0)
        packed = pack_padded_sequence(emb, lens, batch_first=True,
                                      enforce_sorted=False)
        out, (h_n, _) = self.rnn(packed)
        words, _ = pad_packed_sequence(out, batch_first=True,
                                       total_length=t)
        sent = torch.cat([h_n[0], h_n[1]], dim=1)
        return words, sent


def text_encoder_init_(model: RNNEncoder, seed: int) -> None:
    """RNN_ENCODER's init from ``seed``: the embedding uniform in
    [-0.1, 0.1] (init_weights, model.py:152-157), the LSTM's weights and
    biases uniform in [-1/sqrt(h), 1/sqrt(h)], torch's LSTM default."""
    gen = torch.Generator().manual_seed(seed)
    k = 1.0 / math.sqrt(model.rnn.hidden_size)
    with torch.no_grad():
        model.encoder.weight.uniform_(-0.1, 0.1, generator=gen)
        for w in model.rnn.parameters():
            w.uniform_(-k, k, generator=gen)


def build_text_encoder(ntoken: int, nhidden: int = 256, state_dict=None, *,
                       seed: int = 0, device="cuda") -> RNNEncoder:
    """An eval-mode RNNEncoder on ``device``: ``state_dict`` (a DAMSM
    ``text_encoder*.pth``'s keys) loaded with strict=True, or
    :func:`text_encoder_init_` from ``seed`` when there is none."""
    dev = resolve_device(device)
    model = RNNEncoder(ntoken, nhidden=nhidden)
    if state_dict is None:
        text_encoder_init_(model, seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.to(dev).eval()


# ------------------------------------------------------------ image encoder


class BasicConv2d(nn.Module):
    """torchvision's BasicConv2d: conv without bias, BatchNorm (eps 1e-3),
    ReLU; keys ``conv.weight`` and ``bn.*``."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=0, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                           bias=False, compute_dtype=compute_dtype)
        self.bn = BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1)


def _max_pool3_s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, dt=None):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1, compute_dtype=dt)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1, compute_dtype=dt)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2,
                                       compute_dtype=dt)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, compute_dtype=dt)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1,
                                          compute_dtype=dt)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1,
                                          compute_dtype=dt)
        self.branch_pool = BasicConv2d(cin, pool_features, 1,
                                       compute_dtype=dt)

    pool = staticmethod(_avg_pool3)    # the pool branch's pooling

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(self.pool(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, dt=None):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2, compute_dtype=dt)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, compute_dtype=dt)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1,
                                          compute_dtype=dt)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2,
                                          compute_dtype=dt)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool3_s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, dt=None):
        super().__init__()
        conv = BasicConv2d
        self.branch1x1 = conv(cin, 192, 1, compute_dtype=dt)
        self.branch7x7_1 = conv(cin, c7, 1, compute_dtype=dt)
        self.branch7x7_2 = conv(c7, c7, (1, 7), padding=(0, 3),
                                compute_dtype=dt)
        self.branch7x7_3 = conv(c7, 192, (7, 1), padding=(3, 0),
                                compute_dtype=dt)
        self.branch7x7dbl_1 = conv(cin, c7, 1, compute_dtype=dt)
        self.branch7x7dbl_2 = conv(c7, c7, (7, 1), padding=(3, 0),
                                   compute_dtype=dt)
        self.branch7x7dbl_3 = conv(c7, c7, (1, 7), padding=(0, 3),
                                   compute_dtype=dt)
        self.branch7x7dbl_4 = conv(c7, c7, (7, 1), padding=(3, 0),
                                   compute_dtype=dt)
        self.branch7x7dbl_5 = conv(c7, 192, (1, 7), padding=(0, 3),
                                   compute_dtype=dt)
        self.branch_pool = conv(cin, 192, 1, compute_dtype=dt)

    pool = staticmethod(_avg_pool3)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(self.pool(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int, dt=None):
        super().__init__()
        conv = BasicConv2d
        self.branch3x3_1 = conv(cin, 192, 1, compute_dtype=dt)
        self.branch3x3_2 = conv(192, 320, 3, stride=2, compute_dtype=dt)
        self.branch7x7x3_1 = conv(cin, 192, 1, compute_dtype=dt)
        self.branch7x7x3_2 = conv(192, 192, (1, 7), padding=(0, 3),
                                  compute_dtype=dt)
        self.branch7x7x3_3 = conv(192, 192, (7, 1), padding=(3, 0),
                                  compute_dtype=dt)
        self.branch7x7x3_4 = conv(192, 192, 3, stride=2, compute_dtype=dt)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool3_s2(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, dt=None):
        super().__init__()
        conv = BasicConv2d
        self.branch1x1 = conv(cin, 320, 1, compute_dtype=dt)
        self.branch3x3_1 = conv(cin, 384, 1, compute_dtype=dt)
        self.branch3x3_2a = conv(384, 384, (1, 3), padding=(0, 1),
                                 compute_dtype=dt)
        self.branch3x3_2b = conv(384, 384, (3, 1), padding=(1, 0),
                                 compute_dtype=dt)
        self.branch3x3dbl_1 = conv(cin, 448, 1, compute_dtype=dt)
        self.branch3x3dbl_2 = conv(448, 384, 3, padding=1, compute_dtype=dt)
        self.branch3x3dbl_3a = conv(384, 384, (1, 3), padding=(0, 1),
                                    compute_dtype=dt)
        self.branch3x3dbl_3b = conv(384, 384, (3, 1), padding=(1, 0),
                                    compute_dtype=dt)
        self.branch_pool = conv(cin, 192, 1, compute_dtype=dt)

    pool = staticmethod(_avg_pool3)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(self.pool(x))], dim=1)


class CNNEncoder(nn.Module):
    """CNN_ENCODER, the DAMSM image encoder.

    ``forward(x (B, 3, H, W) in [-1, 1])`` returns (regions (B, nef, 17,
    17), image code (B, nef)), both float32; with ``return_pool`` also the
    raw 2048 pooled features (B, 2048) float32 as a third output, which
    FID and IS read (JAX ``CNNEncoder(return_pool=True)``).
    """

    def __init__(self, nef: int = 256,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dt = compute_dtype
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2, compute_dtype=dt)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, compute_dtype=dt)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1,
                                         compute_dtype=dt)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1, compute_dtype=dt)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, compute_dtype=dt)
        self.Mixed_5b = InceptionA(192, 32, dt)
        self.Mixed_5c = InceptionA(256, 64, dt)
        self.Mixed_5d = InceptionA(288, 64, dt)
        self.Mixed_6a = InceptionB(288, dt)
        self.Mixed_6b = InceptionC(768, 128, dt)
        self.Mixed_6c = InceptionC(768, 160, dt)
        self.Mixed_6d = InceptionC(768, 160, dt)
        self.Mixed_6e = InceptionC(768, 192, dt)
        self.Mixed_7a = InceptionD(768, dt)
        self.Mixed_7b = InceptionE(1280, dt)
        self.Mixed_7c = InceptionE(2048, dt)
        self.emb_features = nn.Conv2d(768, nef, 1, bias=False)
        self.emb_cnn_code = nn.Linear(2048, nef)

    def forward(self, x: torch.Tensor, return_pool: bool = False):
        x = F.interpolate(x, size=(299, 299), mode="bilinear",
                          align_corners=False)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool3_s2(x)))
        x = _max_pool3_s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        features = x                                      # (B, 768, 17, 17)
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        code = F.avg_pool2d(x, 8).flatten(1).float()      # (B, 2048)
        out = self.emb_features(features.float()), self.emb_cnn_code(code)
        return (*out, code) if return_pool else out


def image_encoder_init_(model: CNNEncoder, seed: int) -> None:
    """Random weights from ``seed`` where no DAMSM file is given: convs
    N(0, 2 / fan_in), BatchNorm weight 1, bias 0 and running statistics
    mean 0, var 1, and the two embeddings uniform in [-0.1, 0.1], the
    reference's init_trainable_weights (model.py:237-240)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if name in ("emb_features", "emb_cnn_code"):
                m.weight.uniform_(-0.1, 0.1, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, math.sqrt(2.0 / m.weight[0].numel()),
                                 generator=gen)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


def build_image_encoder(nef: int = 256, state_dict=None, *, seed: int = 0,
                        compute_dtype: Optional[torch.dtype] = None,
                        device="cuda") -> CNNEncoder:
    """An eval-mode CNNEncoder on ``device`` without gradients for its
    parameters: ``state_dict`` (a DAMSM ``image_encoder*.pth``'s keys)
    loaded with strict=True, or :func:`image_encoder_init_` from ``seed``
    when there is none."""
    dev = resolve_device(device)
    model = CNNEncoder(nef, compute_dtype)
    if state_dict is None:
        image_encoder_init_(model, seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.to(dev).eval().requires_grad_(False)
