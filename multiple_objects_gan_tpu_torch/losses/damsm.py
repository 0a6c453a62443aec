"""DAMSM word and sentence matching losses of the AttnGAN generator (port of
the JAX ``losses/damsm.py``).

Reference (code/coco/attngan/miscc/losses.py):

* ``sent_loss`` (:20-59): the cosine of every image's code with every
  caption's sentence embedding, times gamma3, as logits of a cross-entropy
  over the batch in both directions;
* ``words_loss`` (:62-132): each caption's words attend over each image's
  17x17 regions (``func_attention``, gamma1), the cosine of every word with
  its region context, pooled over the caption's real words by a gamma2
  log-sum-exp, times gamma3, as logits of the same two cross-entropies.

Both leave out pairs of different items that share a class id (filled with
-1e9; the diagonal is kept). The reference loops over the captions and
slices each to its length; here every caption is padded to the batch's
length and its padded words are masked out of the attention's word softmax
and out of the log-sum-exp, which gives the same values. The scores are
image-major (row i: image i against every caption), as the reference builds
them. Everything runs in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from multiple_objects_gan_tpu_torch.nn.attention import func_attention

NEG_INF = -1e9
EPS = 1e-8


def _class_mask(class_ids: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, B) bool: True where two different items share a class."""
    eq = class_ids[:, None] == class_ids[None, :]
    return eq & ~torch.eye(class_ids.shape[0], dtype=torch.bool,
                           device=class_ids.device)


def _ce_both_ways(scores: torch.Tensor):
    """Cross-entropy against labels arange(B) over the rows, and over the
    columns."""
    labels = torch.arange(scores.shape[0], device=scores.device)
    return F.cross_entropy(scores, labels), F.cross_entropy(scores.t(), labels)


def _masked(scores: torch.Tensor, class_ids: Optional[torch.Tensor]):
    if class_ids is None:
        return scores
    return scores.masked_fill(_class_mask(class_ids), NEG_INF)


def sent_loss(cnn_code: torch.Tensor, rnn_code: torch.Tensor,
              class_ids: Optional[torch.Tensor], gamma3: float = 10.0):
    """``cnn_code`` (B, nef) image codes, ``rnn_code`` (B, nef) sentence
    embeddings -> (loss0, loss1)."""
    cnn_code, rnn_code = cnn_code.float(), rnn_code.float()
    cn = torch.linalg.vector_norm(cnn_code, dim=-1, keepdim=True)
    rn = torch.linalg.vector_norm(rnn_code, dim=-1, keepdim=True)
    scores = (cnn_code @ rnn_code.t()) / (cn @ rn.t()).clamp(min=EPS) * gamma3
    return _ce_both_ways(_masked(scores, class_ids))


def words_loss(img_features: torch.Tensor, words_emb: torch.Tensor,
               cap_lens: torch.Tensor, class_ids: Optional[torch.Tensor],
               gamma1: float = 4.0, gamma2: float = 5.0,
               gamma3: float = 10.0):
    """``img_features`` (B, nef, 17, 17) regions, ``words_emb`` (B, T, nef),
    ``cap_lens`` (B,) -> (loss0, loss1, the attention of each caption over
    its own image (B, 17, 17, T)).

    Every caption against every image in one batched attention: pair
    (i, j) is caption i's words over image j's regions."""
    b, t, d = words_emb.shape
    _, _, h, w = img_features.shape
    words = words_emb.float()
    pad = (torch.arange(t, device=words.device)[None, :]
           >= cap_lens.to(words.device)[:, None])                # (B, T)
    query = words[:, None].expand(b, b, t, d).reshape(b * b, t, d)
    context = img_features[None].expand(b, b, d, h, w).reshape(
        b * b, d, h, w)
    mask = pad[:, None].expand(b, b, t).reshape(b * b, t)
    wei, attn = func_attention(query, context, gamma1, mask)
    num = (query * wei).sum(dim=-1)
    den = (torch.linalg.vector_norm(query, dim=-1)
           * torch.linalg.vector_norm(wei, dim=-1))
    row_sim = num / den.clamp(min=EPS)                         # (B*B, T)
    e = torch.exp(row_sim * gamma2) * (~mask).float()
    sims = torch.log(e.sum(dim=1).clamp(min=EPS)).reshape(b, b)
    # sims[i, j]: caption i against image j; the reference's scores are
    # image-major
    scores = _masked(sims.t() * gamma3, class_ids)
    loss0, loss1 = _ce_both_ways(scores)
    own = attn.reshape(b, b, h, w, t)[torch.arange(b), torch.arange(b)]
    return loss0, loss1, own
