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

Under a process group of more than one rank (``parallel/``) the scores and
class masks are those of the global batch: the image codes, region
features, sentence embeddings, similarities and class ids are gathered
with autograd (``parallel/mesh.py:gather_rows``), and each rank's losses
are its rows' share, a sum over its rows of the cross-entropies over the
global B, so that the ranks' losses sum to the global loss and no rank
counts another's rows.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from multiple_objects_gan_tpu_torch.nn.attention import func_attention
from multiple_objects_gan_tpu_torch.parallel import mesh
from multiple_objects_gan_tpu_torch.parallel.multihost import world_size

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


def _cosines(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, d), (m, d) -> (n, m): the cosine of every row of ``a`` with
    every row of ``b``."""
    an = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    bn = torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    return (a @ b.t()) / (an @ bn.t()).clamp(min=EPS)


def _ce_rows(scores: torch.Tensor, class_ids: Optional[torch.Tensor]):
    """This rank's share of a global cross-entropy: ``scores`` are its
    rows (n, B) of the global (B, B) scores, whose labels are the rows'
    global indices; the sum over them over B."""
    rows = mesh.rank_rows(scores.shape[1])
    if class_ids is not None:
        scores = scores.masked_fill(
            _class_mask(mesh.gather_rows(class_ids))[rows], NEG_INF)
    labels = torch.arange(rows.start, rows.stop, device=scores.device)
    return (F.cross_entropy(scores, labels, reduction="sum")
            / scores.shape[1])


def sent_loss(cnn_code: torch.Tensor, rnn_code: torch.Tensor,
              class_ids: Optional[torch.Tensor], gamma3: float = 10.0):
    """``cnn_code`` (B, nef) image codes, ``rnn_code`` (B, nef) sentence
    embeddings -> (loss0, loss1). Under a process group, the rank's
    share of the losses of the global batch (module docstring)."""
    cnn_code, rnn_code = cnn_code.float(), rnn_code.float()
    if world_size() == 1:
        return _ce_both_ways(_masked(_cosines(cnn_code, rnn_code) * gamma3,
                                     class_ids))
    # this rank's images against every caption, its captions against
    # every image: its rows of the scores and of their transpose
    return (_ce_rows(_cosines(cnn_code, mesh.gather_rows(rnn_code))
                     * gamma3, class_ids),
            _ce_rows(_cosines(rnn_code, mesh.gather_rows(cnn_code))
                     * gamma3, class_ids))


def _caption_image_sims(words: torch.Tensor, cap_lens: torch.Tensor,
                        img_features: torch.Tensor, gamma1: float,
                        gamma2: float):
    """Every caption of ``words`` (n, T, d) against every image of
    ``img_features`` (m, d, h, w) in one batched attention: (sims (n, m),
    attention (n, m, h, w, T)); pair (i, j) is caption i's words over
    image j's regions."""
    n, t, d = words.shape
    m, _, h, w = img_features.shape
    pad = (torch.arange(t, device=words.device)[None, :]
           >= cap_lens.to(words.device)[:, None])                # (n, T)
    query = words[:, None].expand(n, m, t, d).reshape(n * m, t, d)
    context = img_features[None].expand(n, m, d, h, w).reshape(
        n * m, d, h, w)
    mask = pad[:, None].expand(n, m, t).reshape(n * m, t)
    wei, attn = func_attention(query, context, gamma1, mask)
    num = (query * wei).sum(dim=-1)
    den = (torch.linalg.vector_norm(query, dim=-1)
           * torch.linalg.vector_norm(wei, dim=-1))
    row_sim = num / den.clamp(min=EPS)                         # (n*m, T)
    e = torch.exp(row_sim * gamma2) * (~mask).float()
    sims = torch.log(e.sum(dim=1).clamp(min=EPS)).reshape(n, m)
    return sims, attn.reshape(n, m, h, w, t)


def words_loss(img_features: torch.Tensor, words_emb: torch.Tensor,
               cap_lens: torch.Tensor, class_ids: Optional[torch.Tensor],
               gamma1: float = 4.0, gamma2: float = 5.0,
               gamma3: float = 10.0):
    """``img_features`` (B, nef, 17, 17) regions, ``words_emb`` (B, T, nef),
    ``cap_lens`` (B,) -> (loss0, loss1, the attention of each caption over
    its own image (B, 17, 17, T)).

    Under a process group, the rank's captions attend over every rank's
    images, the (B, B) similarities are gathered, and the losses are the
    rank's share: the cross-entropy rows of its images and of its
    captions (module docstring)."""
    b = words_emb.shape[0]
    if world_size() == 1:
        sims, attn = _caption_image_sims(words_emb.float(), cap_lens,
                                         img_features, gamma1, gamma2)
        # sims[i, j]: caption i against image j; the reference's scores
        # are image-major
        loss0, loss1 = _ce_both_ways(_masked(sims.t() * gamma3, class_ids))
        return loss0, loss1, attn[torch.arange(b), torch.arange(b)]
    sims, attn = _caption_image_sims(
        words_emb.float(), cap_lens, mesh.gather_rows(img_features), gamma1,
        gamma2)
    rows = mesh.rank_rows(sims.shape[1])
    sims_all = mesh.gather_rows(sims)                      # (B, B)
    loss0 = _ce_rows(sims_all.t()[rows] * gamma3, class_ids)
    loss1 = _ce_rows(sims * gamma3, class_ids)
    own = attn[torch.arange(b), torch.arange(rows.start, rows.stop)]
    return loss0, loss1, own
