"""The DAMSM text encoder of AttnGAN (port of the JAX
``nn/encoders.py:RNNEncoder``).

Reference RNN_ENCODER (code/coco/attngan/model.py:120-204): a word
embedding of ``ninput`` (300) and a one-layer bidirectional LSTM with
``nhidden // 2`` (128) units a direction. Its dropout acts in training
only, which waits for the train slice. The words' embeddings
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
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from multiple_objects_gan_tpu_torch import resolve_device


class RNNEncoder(nn.Module):
    """Bi-LSTM text encoder.

    ``forward(captions (B, T) int64, cap_lens (B,))`` returns (words_emb
    (B, T, nhidden), sent_emb (B, nhidden)); padded word positions are
    zero. Every length must be in 1..T.
    """

    def __init__(self, ntoken: int, ninput: int = 300, nhidden: int = 256):
        super().__init__()
        self.encoder = nn.Embedding(ntoken, ninput)
        self.rnn = nn.LSTM(ninput, nhidden // 2, num_layers=1,
                           batch_first=True, bidirectional=True)

    def forward(self, captions: torch.Tensor, cap_lens: torch.Tensor):
        t = captions.shape[1]
        lens = cap_lens.to("cpu", torch.int64)
        if int(lens.min()) < 1 or int(lens.max()) > t:
            raise ValueError(f"caption lengths must be in 1..{t}, got "
                             f"{lens.tolist()}")
        emb = self.encoder(captions.long())
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
