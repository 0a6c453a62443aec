"""Word attention of the AttnGAN generator and of the DAMSM word loss
(port of the JAX ``nn/attention.py``: ``GlobalAttention`` and
``func_attention``).

Reference: GlobalAttentionGeneral, ATT_NET (code/coco/attngan/
GlobalAttention.py:72-123): the word embeddings are projected to the
image's channels by a 1x1 conv, each pixel's features are dotted with
every word, a softmax over the words weights the projected words into a
per-pixel context.

The mask is per sample: each sample's padded words are filled with -1e9
before the softmax. The reference indexes its mask with
``mask.repeat(queryL, 1)`` against a batch-major attention matrix
(GlobalAttention.py:105-107), which misaligns the masks of a batch larger
than 1 with ragged lengths; the JAX package fixed that, and so does the
port (PARITY.md, known deviation 3).

:func:`func_attention` is the DAMSM attention (GlobalAttention.py:31-69)
that ``losses/damsm.py:words_loss`` runs between a caption's words and an
image's 17x17 regions.

The attention runs in float32 whatever the compute dtype, as the JAX
package's does (its ``conv_context`` is a plain ``nn.Dense`` and its
einsums run at ``Precision.HIGHEST`` on the float32 words): bf16 pixel
features are cast up, and the context comes back float32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

NEG_INF = -1e9


class GlobalAttention(nn.Module):
    """ATT_NET: the word context of every pixel, and the attention maps.

    ``forward(h_code (B, idf, H, W), word_embs (B, L, cdf), mask (B, L)
    bool or None, True at padding)`` returns (context (B, idf, H, W)
    float32, attn (B, H, W, L)). Key ``conv_context.weight`` (idf, cdf,
    1, 1), the reference's conv1x1.
    """

    def __init__(self, idf: int, cdf: int):
        super().__init__()
        self.conv_context = nn.Conv2d(cdf, idf, kernel_size=1, bias=False)

    def forward(self, h_code: torch.Tensor, word_embs: torch.Tensor,
                mask: Optional[torch.Tensor] = None):
        b, idf, h, w = h_code.shape
        weight = self.conv_context.weight
        source = torch.matmul(word_embs.to(weight.dtype),
                              weight[:, :, 0, 0].t())         # (B, L, idf)
        query = h_code.to(source.dtype).reshape(b, idf, h * w)
        attn = torch.bmm(query.transpose(1, 2),
                         source.transpose(1, 2))            # (B, HW, L)
        if mask is not None:
            attn = attn.masked_fill(mask[:, None, :], NEG_INF)
        attn = torch.softmax(attn, dim=-1)
        context = torch.bmm(source.transpose(1, 2),
                            attn.transpose(1, 2))           # (B, idf, HW)
        return (context.reshape(b, idf, h, w),
                attn.reshape(b, h, w, attn.shape[-1]))


def func_attention(query: torch.Tensor, context: torch.Tensor,
                   gamma1: float, query_mask: Optional[torch.Tensor] = None):
    """DAMSM attention (GlobalAttention.py:31-69; JAX ``func_attention``).

    ``query`` (B, Lq, D) words, ``context`` (B, D, H, W) image regions,
    ``query_mask`` (B, Lq) bool, True at a padded word. Returns the
    region context of every word (B, Lq, D) and the attention (B, H, W,
    Lq), in float32. A softmax over the words (the padded ones filled
    with -1e9), then a ``gamma1``-sharpened softmax over the regions. The
    reference slices each caption to its length instead of masking; a
    padded word's column is then zero before the second softmax and
    uniform after it, and ``words_loss`` leaves it out.
    """
    b, d, h, w = context.shape
    src = context.float().reshape(b, d, h * w).transpose(1, 2)  # (B, HW, D)
    attn = torch.bmm(src, query.float().transpose(1, 2))       # (B, HW, Lq)
    if query_mask is not None:
        attn = attn.masked_fill(query_mask[:, None, :], NEG_INF)
    attn = torch.softmax(attn, dim=-1)
    attn = torch.softmax(attn * gamma1, dim=1)
    weighted = torch.bmm(attn.transpose(1, 2), src)            # (B, Lq, D)
    return weighted, attn.reshape(b, h, w, attn.shape[-1])
