"""Weights for the port's Stage1G and Stage1D: carried across from the JAX
package's Flax trees, loaded from reference ``.pth`` files, or drawn at
random.

:func:`stage1_g_state_dict_from_jax` and :func:`stage1_d_state_dict_from_jax`
take the JAX ``Stage1G``/``Stage1D`` params and batch_stats as numpy arrays
and return state dicts with the reference's key names
(code/multi-mnist/model.py:113-257). Their mapping mirrors the JAX
package's ``io/torch_export.py:export_stage1_g/export_stage1_d`` and
``io/torch_import.py``, written out again here:

  * conv kernel HWIO -> OIHW, dense kernel (in, out) -> (out, in);
  * BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
    running_mean/running_var;
  * the Flax module names -> the reference's Sequential indices.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from multiple_objects_gan_tpu_torch.io.pycompat import torch_load


def _t(a) -> torch.Tensor:
    """A float32 tensor owning a contiguous copy of ``a``."""
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(kernel) -> torch.Tensor:  # HWIO -> OIHW
    return _t(np.transpose(kernel, (3, 2, 0, 1)))


def _linear(kernel) -> torch.Tensor:  # (in, out) -> (out, in)
    return _t(np.transpose(kernel))


def _bn(sd: dict, prefix: str, p: Mapping, s: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def _upblock(sd: dict, prefix: str, p: Mapping, s: Mapping) -> None:
    """UpBlock {Conv3x3_0: {Conv_0}, TorchBatchNorm_0} -> Sequential
    [Upsample, conv3x3, BN, ReLU]."""
    sd[f"{prefix}.1.weight"] = _conv(p["Conv3x3_0"]["Conv_0"]["kernel"])
    _bn(sd, f"{prefix}.2", p["TorchBatchNorm_0"], s["TorchBatchNorm_0"])


def stage1_g_state_dict_from_jax(params: Mapping[str, Any],
                                 stats: Mapping[str, Any],
                                 mcfg) -> dict[str, torch.Tensor]:
    """JAX ``Stage1G`` (params, batch_stats) -> the port's state dict, with
    the reference's key names. The reference's dead Multi-MNIST ``label``
    module (model.py:137-140) has no JAX counterpart; it gets inert values
    (zero weight, identity BatchNorm), as the JAX export writes it."""
    if mcfg.use_ca or mcfg.use_label_embed:
        raise NotImplementedError(
            f"{mcfg.variant}: CA and label embedding are not ported yet")
    sd: dict[str, torch.Tensor] = {}
    sd["fc.0.weight"] = _linear(params["fc"]["Dense_0"]["kernel"])
    _bn(sd, "fc.1", params["fc_bn"], stats["fc_bn"])
    _upblock(sd, "local1", params["local"]["UpBlock_0"],
             stats["local"]["UpBlock_0"])
    _upblock(sd, "local2", params["local"]["UpBlock_1"],
             stats["local"]["UpBlock_1"])
    for i in range(1, 5):
        _upblock(sd, f"upsample{i}", params[f"upsample{i}"],
                 stats[f"upsample{i}"])
    sd["img.0.weight"] = _conv(params["img"]["Conv_0"]["kernel"])
    if mcfg.use_bbox_layout:
        p, s = params["bbox_net"], stats["bbox_net"]
        sd["bbox_net.encode.0.weight"] = _conv(p["Conv3x3_0"]["Conv_0"]["kernel"])
        sd["bbox_net.encode.2.weight"] = _conv(p["Conv3x3_1"]["Conv_0"]["kernel"])
        _bn(sd, "bbox_net.encode.3", p["TorchBatchNorm_0"],
            s["TorchBatchNorm_0"])
        sd["bbox_net.encode.5.weight"] = _conv(p["Conv3x3_2"]["Conv_0"]["kernel"])
        _bn(sd, "bbox_net.encode.6", p["TorchBatchNorm_1"],
            s["TorchBatchNorm_1"])
    e = mcfg.label_dim
    sd["label.0.weight"] = torch.zeros((e, e))
    _bn(sd, "label.1", {"scale": np.ones(e), "bias": np.zeros(e)},
        {"mean": np.zeros(e), "var": np.ones(e)})
    return sd


def stage1_d_state_dict_from_jax(params: Mapping[str, Any],
                                 stats: Mapping[str, Any]
                                 ) -> dict[str, torch.Tensor]:
    """JAX ``Stage1D`` (params, batch_stats) -> the port's state dict, with
    the reference's key names (STAGE1_D + D_GET_LOGITS)."""
    sd: dict[str, torch.Tensor] = {}
    sd["local.0.weight"] = _conv(params["local"]["Conv_0"]["kernel"])
    _bn(sd, "local.1", params["local"]["TorchBatchNorm_0"],
        stats["local"]["TorchBatchNorm_0"])
    for i in range(1, 5):
        sd[f"conv{i}.weight"] = _conv(params[f"conv{i}"]["kernel"])
    for i in (2, 3, 4):
        _bn(sd, f"bn{i}", params[f"bn{i}"], stats[f"bn{i}"])
    h = params["get_cond_logits"]
    sd["get_cond_logits.outlogits.0.weight"] = _conv(
        h["Conv3x3_0"]["Conv_0"]["kernel"])
    _bn(sd, "get_cond_logits.outlogits.1", h["TorchBatchNorm_0"],
        stats["get_cond_logits"]["TorchBatchNorm_0"])
    sd["get_cond_logits.outlogits.3.weight"] = _conv(h["Conv_0"]["kernel"])
    sd["get_cond_logits.outlogits.3.bias"] = _t(h["Conv_0"]["bias"])
    if "get_uncond_logits" in params:
        u = params["get_uncond_logits"]["Conv_0"]
        sd["get_uncond_logits.outlogits.0.weight"] = _conv(u["kernel"])
        sd["get_uncond_logits.outlogits.0.bias"] = _t(u["bias"])
    return sd


def load_reference_g(path: str) -> dict[str, torch.Tensor]:
    """The generator state dict of a reference-format ``.pth``: either
    ``{'epoch', 'netG', ...}`` as the reference's save_model writes it
    (code/multi-mnist/miscc/utils.py:160-174) or a bare state dict."""
    ckpt = torch_load(path)
    sd = ckpt["netG"] if "netG" in ckpt else ckpt
    return {k: v for k, v in sd.items()}


def reference_init_(model: nn.Module, seed: int) -> None:
    """The reference's weights_init (code/multi-mnist/miscc/utils.py) from
    ``seed``: conv and linear weights N(0, 0.02), BatchNorm
    weight N(1, 0.02) and bias 0, running statistics mean 0, var 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.normal_(0.0, 0.02, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                m.weight.normal_(1.0, 0.02, generator=gen)
                m.bias.zero_()
                m.reset_running_stats()
