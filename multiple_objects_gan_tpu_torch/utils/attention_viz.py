"""Attention-map montages of AttnGAN training (port of the JAX
``utils/attention_viz.py``).

Parity target: build_super_images and drawCaption (code/coco/attngan/
miscc/utils.py:65-317), as the JAX package simplifies them: for each
sample a row of its image, then one tile a word with the word's attention
map blended over the image, the word written on top; the tiles of padded
words are dimmed. The resizes are PIL's bilinear (``data/png.py``), the
words are drawn with the port's 5x7 bitmap font (``utils/images.py``), so
only the text pixels differ from the JAX montage.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from multiple_objects_gan_tpu_torch.data.png import resize_bilinear
from multiple_objects_gan_tpu_torch.utils.images import (
    draw_text, png_bytes, to_uint8)


def _colorize(att: np.ndarray) -> np.ndarray:
    """(h, w) in [0, 1] -> a red heat map (h, w, 3) uint8."""
    att = np.clip(att, 0.0, 1.0)
    heat = np.zeros(att.shape + (3,), np.float32)
    heat[..., 0] = att * 255.0
    heat[..., 2] = (1.0 - att) * 96.0
    return heat.astype(np.uint8)


def build_attention_images(images: np.ndarray, att_maps: np.ndarray,
                           captions: np.ndarray,
                           ixtoword: Optional[dict] = None,
                           cap_lens: Optional[np.ndarray] = None,
                           max_words: int = 8, tile: int = 64) -> np.ndarray:
    """``images`` (B, H, W, 3) in [-1, 1], ``att_maps`` (B, h, w, T),
    ``captions`` (B, T) word ids -> one uint8 montage, a row a sample of
    1 + min(T, max_words) tiles of ``tile`` pixels."""
    b, _, _, t = att_maps.shape
    n_words = min(t, max_words)
    rows = []
    for i in range(b):
        img = resize_bilinear(to_uint8(images[i]), (tile, tile))
        row = [img]
        length = int(cap_lens[i]) if cap_lens is not None else n_words
        for w in range(n_words):
            att = att_maps[i, :, :, w]
            att = att / max(float(att.max()), 1e-8)
            att_img = resize_bilinear(_colorize(att), (tile, tile))
            cell = (0.4 * img + 0.6 * att_img).astype(np.uint8)
            if ixtoword is not None and w < length:
                draw_text(cell, (2, 2), ixtoword.get(int(captions[i, w]),
                                                     "?")[:10],
                          fill=(255, 255, 0))
            if w >= length:
                cell = cell // 3
            row.append(cell)
        rows.append(np.concatenate(row, axis=1))
    return np.concatenate(rows, axis=0)


def save_attention_montage(path: str, images, att_maps, captions,
                           ixtoword=None, cap_lens=None) -> None:
    """:func:`build_attention_images` written as a PNG at ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    montage = build_attention_images(
        np.asarray(images), np.asarray(att_maps), np.asarray(captions),
        ixtoword, None if cap_lens is None else np.asarray(cap_lens))
    with open(path, "wb") as f:
        f.write(png_bytes(montage))
