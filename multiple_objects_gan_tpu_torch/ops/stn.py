"""Spatial-transformer ops in plain PyTorch (port of the JAX ``ops/stn.py``).

Every matrix the models build is axis-aligned (scale + translation), so the
bilinear resample of ``F.affine_grid`` + ``F.grid_sample`` with PyTorch-0.4
semantics (align_corners=True, zero padding) is separable:

    out[i, j] = sum_{p, q}  Wy[i, p] * img[p, q] * Wx[j, q]

with the 1-D hat weights ``W[i, j] = max(0, 1 - |src_i - j|)``. Sources
outside the input give all-zero rows, which is how a padded object
(bbox = -1) places nothing.

Public functions keep the JAX package's layout, (B, H, W, C) and
(B, O, h, w, C), so the tests compare like with like. The model runs NCHW:
it calls :func:`stn_extract_multi_nchw` and the kernel wrapper in
``ops/stn_place_cuda.py`` directly. :func:`affine_grid`,
:func:`grid_sample` and :func:`stn` are the general (any affine matrix)
path of the JAX package's ``ops/stn.py:240-294``; no model calls them.
"""

from __future__ import annotations

import torch


def transformation_matrix(bbox: torch.Tensor) -> torch.Tensor:
    """bbox (..., 4) of (x, y, w, h) in [0, 1] -> (..., 2, 3) EXTRACT matrix."""
    x, y, w, h = bbox.unbind(-1)
    t_x = 2.0 * ((x + 0.5 * w) - 0.5)
    t_y = 2.0 * ((y + 0.5 * h) - 0.5)
    zeros = torch.zeros_like(x)
    row0 = torch.stack([w, zeros, t_x], dim=-1)
    row1 = torch.stack([zeros, h, t_y], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def transformation_matrix_inverse(bbox: torch.Tensor) -> torch.Tensor:
    """bbox (..., 4) -> (..., 2, 3) PLACE matrix (inverse of the above)."""
    x, y, w, h = bbox.unbind(-1)
    scale_x = 1.0 / w
    scale_y = 1.0 / h
    t_x = 2.0 * scale_x * (0.5 - (x + 0.5 * w))
    t_y = 2.0 * scale_y * (0.5 - (y + 0.5 * h))
    zeros = torch.zeros_like(x)
    row0 = torch.stack([scale_x, zeros, t_x], dim=-1)
    row1 = torch.stack([zeros, scale_y, t_y], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _axis_weights(scale: torch.Tensor, trans: torch.Tensor, out_size: int,
                  in_size: int) -> torch.Tensor:
    """(N,) affine coefficients of one axis -> (N, out_size, in_size) f32
    weights ``max(0, 1 - |src_i - j|)`` with
    ``src = ((scale * g_i + trans) + 1) / 2 * (in_size - 1)`` and
    ``g = linspace(-1, 1, out_size)`` (align_corners=True).

    ``g`` and ``src`` are computed operation by operation as the Pallas
    kernel (stn_pallas.py:37-38) and the CUDA kernel compute them, so the
    kernel and this plain version round alike."""
    dev = scale.device
    i = torch.arange(out_size, dtype=torch.float32, device=dev)
    g = (-1.0 + i * (2.0 / (out_size - 1)) if out_size > 1
         else torch.full((1,), -1.0, device=dev))
    src = ((scale.float()[:, None] * g[None, :] + trans.float()[:, None] + 1.0)
           * 0.5 * (in_size - 1))
    j = torch.arange(in_size, dtype=torch.float32, device=dev)
    return torch.clamp(1.0 - (src[:, :, None] - j[None, None, :]).abs(),
                       min=0.0)


def _theta_weights(theta: torch.Tensor, out_hw: tuple[int, int],
                   in_hw: tuple[int, int]
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Wy (N, Ho, h) and Wx (N, Wo, w) of axis-aligned matrices (N, 2, 3)."""
    wy = _axis_weights(theta[:, 1, 1], theta[:, 1, 2], out_hw[0], in_hw[0])
    wx = _axis_weights(theta[:, 0, 0], theta[:, 0, 2], out_hw[1], in_hw[1])
    return wy, wx


def place_weights(bbox: torch.Tensor, out_hw: tuple[int, int],
                  in_hw: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Hat weights of the place (inverse) affine of bbox (N, 4):
    Wy (N, Ho, h) and Wx (N, Wo, w)."""
    return _theta_weights(transformation_matrix_inverse(bbox.float()),
                          out_hw, in_hw)


def stn_separable(image: torch.Tensor, theta: torch.Tensor,
                  out_hw: tuple[int, int]) -> torch.Tensor:
    """Axis-aligned STN: (B, H, W, C), theta (B, 2, 3) -> (B, Ho, Wo, C).

    Requires theta[:, 0, 1] == theta[:, 1, 0] == 0. Two matrix products,
    rows first, then columns: in f32, or for a bf16 image in bf16 with the
    weights rounded to bf16, as the JAX package's bf16 branch computes it
    (``multiple_objects_gan_tpu/ops/stn.py:130-138``).
    """
    wy, wx = _theta_weights(theta, out_hw, image.shape[1:3])
    if image.dtype == torch.bfloat16:
        tmp = torch.einsum("bip,bpqc->biqc", wy.to(image.dtype), image)
        return torch.einsum("biqc,bjq->bijc", tmp, wx.to(image.dtype))
    tmp = torch.einsum("bip,bpqc->biqc", wy, image.float())
    out = torch.einsum("biqc,bjq->bijc", tmp, wx)
    return out.to(image.dtype)


def stn_place(features: torch.Tensor, bbox: torch.Tensor,
              out_hw: tuple[int, int]) -> torch.Tensor:
    """Paste (B, h, w, C) features into bbox (B, 4) on an out_hw canvas."""
    return stn_separable(features, transformation_matrix_inverse(bbox),
                         out_hw)


def stn_extract(image: torch.Tensor, bbox: torch.Tensor,
                out_hw: tuple[int, int]) -> torch.Tensor:
    """Crop the bbox (B, 4) region of (B, H, W, C) to an out_hw grid."""
    return stn_separable(image, transformation_matrix(bbox), out_hw)


def stn_extract_multi_nchw(image: torch.Tensor, bbox: torch.Tensor,
                           out_hw: tuple[int, int]) -> torch.Tensor:
    """Crop every box: image (B, C, H, W), bbox (B, O, 4) ->
    (B, O, C, Ho, Wo), the layout the D object pathway folds.

    Plain torch with autograd to the image (the JAX package runs it in XLA;
    no Pallas kernel stood behind it). The boxes are data: detached, as
    the JAX package's ``ops/stn.py:179`` stops their gradient.
    """
    b, o = bbox.shape[:2]
    theta = transformation_matrix(bbox.detach().reshape(b * o, 4).float())
    wy, wx = _theta_weights(theta, out_hw, image.shape[-2:])
    wy = wy.reshape(b, o, out_hw[0], -1).to(image.dtype)
    wx = wx.reshape(b, o, out_hw[1], -1).to(image.dtype)
    tmp = torch.einsum("boip,bcpq->bociq", wy, image)
    return torch.einsum("bociq,bojq->bocij", tmp, wx)


def stn_extract_multi(image: torch.Tensor, bbox: torch.Tensor,
                      out_hw: tuple[int, int]) -> torch.Tensor:
    """:func:`stn_extract_multi_nchw` in the JAX layout: image (B, H, W, C),
    bbox (B, O, 4) -> (B, O, Ho, Wo, C)."""
    out = stn_extract_multi_nchw(image.permute(0, 3, 1, 2), bbox, out_hw)
    return out.permute(0, 1, 3, 4, 2)


def stn_place_multi(features: torch.Tensor, bbox: torch.Tensor,
                    out_hw: tuple[int, int]) -> torch.Tensor:
    """Place-and-accumulate in the JAX layout.

    features (B, O, h, w, C) f32, bbox (B, O, 4) -> (B, Ho, Wo, C): the sum
    of each object's placed map. A thin wrapper over
    :func:`~multiple_objects_gan_tpu_torch.ops.stn_place_cuda.stn_place_multi_nchw`,
    which launches the CUDA kernel for a CUDA tensor and runs the plain
    version for a CPU tensor. The model calls that wrapper directly in its
    own NCHW layout, so it pays no permute.
    """
    # imported here: stn_place_cuda builds its plain version from this module
    from multiple_objects_gan_tpu_torch.ops.stn_place_cuda import (
        stn_place_multi_nchw)

    nchw = features.permute(0, 1, 4, 2, 3).contiguous()
    return stn_place_multi_nchw(nchw, bbox, out_hw).permute(0, 2, 3, 1)


def stn_place_const_multi(labels: torch.Tensor, bbox: torch.Tensor,
                          out_hw: tuple[int, int]) -> torch.Tensor:
    """Paste spatially constant label vectors into their boxes and sum.

    labels (B, O, C), bbox (B, O, 4) -> (B, Ho, Wo, C). For a constant map
    the bilinear result is an outer product of the weight row sums:
    ``placed[i, j, c] = label[c] * sum_p Wy[i, p] * sum_q Wx[j, q]``.
    No Pallas kernel stood behind this op, so it stays plain torch. Bf16
    labels are pasted in bf16 with the mask rounded to bf16, as the JAX
    package does (``multiple_objects_gan_tpu/ops/stn.py:219-222``).
    """
    b, o, c = labels.shape
    ho, wo = out_hw
    # in_size=16 matches the reference's 16x16 tiled constant map
    wy, wx = place_weights(bbox.reshape(b * o, 4), out_hw, (16, 16))
    mask = wy.sum(-1)[:, :, None] * wx.sum(-1)[:, None, :]  # (B*O, Ho, Wo)
    mask = mask.reshape(b, o, ho, wo)
    if labels.dtype == torch.bfloat16:
        return torch.einsum("bohw,boc->bhwc", mask.to(labels.dtype), labels)
    out = torch.einsum("bohw,boc->bhwc", mask, labels.float())
    return out.to(labels.dtype)


# ---------------------------------------------------------------------------
# General affine grid + gather-based sampling (the JAX package's parity path)
# ---------------------------------------------------------------------------

def affine_grid(theta: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """theta (B, 2, 3) -> sampling grid (B, Ho, Wo, 2) of (x, y) in [-1, 1].

    PyTorch-0.4 ``F.affine_grid`` semantics (align_corners=True): the grid
    coordinates are linspace(-1, 1, size), both ends included. Computed
    element by element in theta's dtype, as the JAX package does.
    """
    ho, wo = out_hw
    ys = torch.linspace(-1.0, 1.0, ho, dtype=theta.dtype, device=theta.device)
    xs = torch.linspace(-1.0, 1.0, wo, dtype=theta.dtype, device=theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    t = theta[:, :, :, None, None]                       # (B, 2, 3, 1, 1)
    out_x = t[:, 0, 0] * gx + t[:, 0, 1] * gy + t[:, 0, 2]
    out_y = t[:, 1, 0] * gx + t[:, 1, 1] * gy + t[:, 1, 2]
    return torch.stack([out_x, out_y], dim=-1)           # (B, Ho, Wo, 2)


def grid_sample(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (B, H, W, C) at grid (B, Ho, Wo, 2); zero padding.

    PyTorch-0.4 ``F.grid_sample`` semantics: pixel coordinates
    ix = (x + 1) / 2 * (W - 1) (align_corners=True), zeros outside. Float32
    arithmetic; the result comes back in the image's dtype.
    """
    b, hi, wi, c = image.shape
    flat = image.float().reshape(b, hi * wi, c)
    gx = (grid[..., 0].float() + 1.0) * 0.5 * (wi - 1)
    gy = (grid[..., 1].float() + 1.0) * 0.5 * (hi - 1)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    x1, y1 = x0 + 1.0, y0 + 1.0
    wx1, wy1 = gx - x0, gy - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1

    def fetch(xi, yi):
        inside = (xi >= 0) & (xi <= wi - 1) & (yi >= 0) & (yi <= hi - 1)
        xc = xi.clamp(0, wi - 1).long()
        yc = yi.clamp(0, hi - 1).long()
        idx = (yc * wi + xc).reshape(b, -1, 1).expand(-1, -1, c)
        val = torch.gather(flat, 1, idx).reshape(*xi.shape, c)
        return val * inside[..., None].float()

    out = (fetch(x0, y0) * (wx0 * wy0)[..., None]
           + fetch(x1, y0) * (wx1 * wy0)[..., None]
           + fetch(x0, y1) * (wx0 * wy1)[..., None]
           + fetch(x1, y1) * (wx1 * wy1)[..., None])
    return out.to(image.dtype)


def stn(image: torch.Tensor, theta: torch.Tensor,
        out_hw: tuple[int, int]) -> torch.Tensor:
    """The general STN (reference model.py:73-77): :func:`affine_grid` then
    :func:`grid_sample`, for any affine ``theta`` (B, 2, 3)."""
    return grid_sample(image, affine_grid(theta, out_hw))
