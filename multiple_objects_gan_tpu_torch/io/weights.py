"""Weights for the port's Stage1G/Stage1D, Stage2G/Stage2D and the AttnGAN
GNet, discriminators and DAMSM encoders: carried across from the JAX
package's Flax trees, loaded from reference ``.pth`` files, or drawn at
random.

:func:`stage1_g_state_dict_from_jax`, :func:`stage1_d_state_dict_from_jax`,
:func:`stage2_g_state_dict_from_jax`, :func:`stage2_d_state_dict_from_jax`,
:func:`attngan_g_state_dict_from_jax`, :func:`attngan_d_state_dict_from_jax`,
:func:`text_encoder_state_dict_from_jax` and
:func:`image_encoder_state_dict_from_jax` take the JAX modules' params and
batch_stats as numpy arrays and return state dicts with the reference's
key names (code/multi-mnist/model.py:113-257, code/coco/stackgan/
model.py:311-537, code/coco/attngan/model.py:120-204,478-528). Their mapping
mirrors the JAX package's ``io/torch_export.py`` and
``io/torch_import.py``, written out again here:

  * conv kernel HWIO -> OIHW, dense kernel (in, out) -> (out, in);
  * BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
    running_mean/running_var;
  * the Flax module names -> the reference's Sequential indices.
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Optional

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


def _bbox_net(sd: dict, prefix: str, p: Mapping, s: Mapping) -> None:
    """LayoutEncoder {Conv3x3_0..2, TorchBatchNorm_0..1} -> ``encode``
    Sequential [conv, LReLU, conv, BN, LReLU, conv, BN, LReLU]."""
    for i, idx in enumerate((0, 2, 5)):
        sd[f"{prefix}.encode.{idx}.weight"] = _conv(
            p[f"Conv3x3_{i}"]["Conv_0"]["kernel"])
    for i, idx in enumerate((3, 6)):
        _bn(sd, f"{prefix}.encode.{idx}", p[f"TorchBatchNorm_{i}"],
            s[f"TorchBatchNorm_{i}"])


def stage1_g_state_dict_from_jax(params: Mapping[str, Any],
                                 stats: Mapping[str, Any],
                                 mcfg) -> dict[str, torch.Tensor]:
    """JAX ``Stage1G`` (params, batch_stats) -> the port's state dict, with
    the reference's key names. The label embedding and the CA net map to
    ``label.{0,1}`` and ``ca_net.fc`` (JAX ``io/torch_export.py:99-118``).
    The reference's dead Multi-MNIST ``label`` module (model.py:137-140)
    has no JAX counterpart; it gets inert values (zero weight, identity
    BatchNorm), as the JAX export writes it."""
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
        _bbox_net(sd, "bbox_net", params["bbox_net"], stats["bbox_net"])
    if mcfg.use_label_embed:
        sd["label.0.weight"] = _linear(
            params["label"]["Dense_0"]["Dense_0"]["kernel"])
        _bn(sd, "label.1", params["label"]["TorchBatchNorm_0"],
            stats["label"]["TorchBatchNorm_0"])
    else:
        e = mcfg.label_dim
        sd["label.0.weight"] = torch.zeros((e, e))
        _bn(sd, "label.1", {"scale": np.ones(e), "bias": np.zeros(e)},
            {"mean": np.zeros(e), "var": np.ones(e)})
    if mcfg.use_ca:
        fc = params["ca_net"]["Dense_0"]["Dense_0"]
        sd["ca_net.fc.weight"] = _linear(fc["kernel"])
        sd["ca_net.fc.bias"] = _t(fc["bias"])
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
    _d_heads(sd, params, stats)
    return sd


def _d_heads(sd: dict, params: Mapping, stats: Mapping) -> None:
    """D_GET_LOGITS: the conditional head, and the unconditional one where
    the D has it."""
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


def _resblock(sd: dict, prefix: str, p: Mapping, s: Mapping) -> None:
    """ResBlock {Conv3x3_0, TorchBatchNorm_0, Conv3x3_1, TorchBatchNorm_1}
    -> ``block`` Sequential [conv3x3, BN, ReLU, conv3x3, BN]."""
    for i, (conv, bn) in enumerate(((0, 1), (3, 4))):
        sd[f"{prefix}.block.{conv}.weight"] = _conv(
            p[f"Conv3x3_{i}"]["Conv_0"]["kernel"])
        _bn(sd, f"{prefix}.block.{bn}", p[f"TorchBatchNorm_{i}"],
            s[f"TorchBatchNorm_{i}"])


def stage2_g_state_dict_from_jax(params: Mapping[str, Any],
                                 stats: Mapping[str, Any],
                                 r_num: int) -> dict[str, torch.Tensor]:
    """JAX ``Stage2G`` (params, batch_stats) -> the port's Stage2G state
    dict, the reference STAGE2_G's keys without the ``STAGE1_G.`` part
    (JAX ``io/torch_export.py:export_stage2_g``)."""
    sd: dict[str, torch.Tensor] = {}
    sd["encoder.0.weight"] = _conv(params["enc_conv0"]["Conv_0"]["kernel"])
    sd["encoder.2.weight"] = _conv(params["enc_conv1"]["kernel"])
    _bn(sd, "encoder.3", params["enc_bn1"], stats["enc_bn1"])
    sd["encoder.5.weight"] = _conv(params["enc_conv2"]["kernel"])
    _bn(sd, "encoder.6", params["enc_bn2"], stats["enc_bn2"])
    fc = params["ca_net"]["Dense_0"]["Dense_0"]
    sd["ca_net.fc.weight"] = _linear(fc["kernel"])
    sd["ca_net.fc.bias"] = _t(fc["bias"])
    sd["label.0.weight"] = _linear(
        params["label"]["Dense_0"]["Dense_0"]["kernel"])
    _bn(sd, "label.1", params["label"]["TorchBatchNorm_0"],
        stats["label"]["TorchBatchNorm_0"])
    sd["hr_joint.0.weight"] = _conv(
        params["hr_joint_conv"]["Conv_0"]["kernel"])
    _bn(sd, "hr_joint.1", params["hr_joint_bn"], stats["hr_joint_bn"])
    for i in range(r_num):
        _resblock(sd, f"residual.{i}", params[f"residual{i}"],
                  stats[f"residual{i}"])
    for name in ("local1", "local2", "upsample1", "upsample2", "upsample3",
                 "upsample4"):
        _upblock(sd, name, params[name], stats[name])
    sd["img.0.weight"] = _conv(params["img"]["Conv_0"]["kernel"])
    return sd


def stage2_d_state_dict_from_jax(params: Mapping[str, Any],
                                 stats: Mapping[str, Any]
                                 ) -> dict[str, torch.Tensor]:
    """JAX ``Stage2D`` (params, batch_stats) -> the port's Stage2D state
    dict, STAGE2_D's keys with both heads (JAX
    ``io/torch_export.py:export_stage2_d``)."""
    sd: dict[str, torch.Tensor] = {}
    for i, (conv, bn) in enumerate(((0, 1), (3, 4)), start=1):
        sd[f"local.{conv}.weight"] = _conv(params[f"local_conv{i}"]["kernel"])
        _bn(sd, f"local.{bn}", params[f"local_bn{i}"], stats[f"local_bn{i}"])
    for i in range(1, 7):
        sd[f"conv{i}.weight"] = _conv(params[f"conv{i}"]["kernel"])
    for i in (7, 8):
        sd[f"conv{i}.weight"] = _conv(params[f"conv{i}"]["Conv_0"]["kernel"])
    for i in range(2, 9):
        _bn(sd, f"bn{i}", params[f"bn{i}"], stats[f"bn{i}"])
    _d_heads(sd, params, stats)
    return sd


def attngan_g_state_dict_from_jax(params: Mapping[str, Any],
                                  stats: Mapping[str, Any],
                                  branch_num: int = 3,
                                  r_num: int = 3) -> dict[str, torch.Tensor]:
    """JAX ``GNet`` (params, batch_stats) -> the port's GNet state dict,
    G_NET's keys (code/coco/attngan/model.py:478-528; JAX
    ``io/torch_export.py:export_attngan_g``). ``conv_context``, a Dense
    (cdf, idf) there, is the reference's conv1x1 (idf, cdf, 1, 1)."""
    sd: dict[str, torch.Tensor] = {}
    fc = params["ca_net"]["Dense_0"]["Dense_0"]
    sd["ca_net.fc.weight"] = _linear(fc["kernel"])
    sd["ca_net.fc.bias"] = _t(fc["bias"])
    p, s = params["h_net1"], stats["h_net1"]
    sd["h_net1.label.0.weight"] = _linear(p["label_fc"]["kernel"])
    _bn(sd, "h_net1.label.1", p["label_bn"], s["label_bn"])
    sd["h_net1.fc.0.weight"] = _linear(p["fc"]["kernel"])
    _bn(sd, "h_net1.fc.1", p["fc_bn"], s["fc_bn"])
    _bbox_net(sd, "h_net1.bbox_net", p["bbox_net"], s["bbox_net"])
    for name in ("local1", "local2"):
        _upblock(sd, f"h_net1.{name}", p["local"][name], s["local"][name])
    for i in range(1, 5):
        _upblock(sd, f"h_net1.upsample{i}", p[f"upsample{i}"],
                 s[f"upsample{i}"])
    for b in range(2, branch_num + 1):
        p, s = params[f"h_net{b}"], stats[f"h_net{b}"]
        sd[f"h_net{b}.att.conv_context.weight"] = _linear(
            p["att"]["conv_context"]["kernel"])[:, :, None, None]
        for i in range(r_num):
            _resblock(sd, f"h_net{b}.residual.{i}", p[f"residual{i}"],
                      s[f"residual{i}"])
        _upblock(sd, f"h_net{b}.upsample", p["upsample"], s["upsample"])
    for b in range(1, branch_num + 1):
        sd[f"img_net{b}.img.0.weight"] = _conv(
            params[f"img_net{b}"]["img"]["Conv_0"]["kernel"])
    return sd


def text_encoder_state_dict_from_jax(variables: Mapping[str, Any]
                                     ) -> dict[str, torch.Tensor]:
    """JAX ``RNNEncoder`` variables -> the port's RNNEncoder state dict,
    RNN_ENCODER's keys (code/coco/attngan/model.py:120-204): the
    embedding, and each direction's LSTM weights and biases under
    nn.LSTM's names, the gates in the same [i, f, g, o] order (JAX
    ``io/damsm_import.py:import_text_encoder``, inverted)."""
    params = variables["params"]
    sd = {"encoder.weight": _t(params["encoder"])}
    for suffix, name in (("", "rnn_fwd"), ("_reverse", "rnn_bwd")):
        for key in ("w_ih", "w_hh", "b_ih", "b_hh"):
            kind = "weight" if key[0] == "w" else "bias"
            sd[f"rnn.{kind}_{key[2:]}_l0{suffix}"] = _t(params[name][key])
    return sd


def _block3x3(sd: dict, prefix: str, p: Mapping, s: Mapping) -> None:
    """Block3x3LeakReLU {Conv3x3_0: {Conv_0}, TorchBatchNorm_0} ->
    Sequential [conv3x3, BN, LeakyReLU]."""
    sd[f"{prefix}.0.weight"] = _conv(p["Conv3x3_0"]["Conv_0"]["kernel"])
    _bn(sd, f"{prefix}.1", p["TorchBatchNorm_0"], s["TorchBatchNorm_0"])


def attngan_d_state_dict_from_jax(params: Mapping[str, Any],
                                  stats: Mapping[str, Any],
                                  scale: int) -> dict[str, torch.Tensor]:
    """JAX ``DNet64`` (``scale`` 64) or ``DNetScale`` (128, 256) (params,
    batch_stats) -> the port's state dict, D_NET64/128/256's keys
    (code/coco/attngan/model.py:616-760; JAX
    ``io/torch_export.py:export_attngan_d``): the heads ``COND_DNET`` and
    ``UNCOND_DNET``, then ``local``/``conv{i}``/``bn{i}`` (64) or the
    ``img_code_*`` Sequentials."""
    sd: dict[str, torch.Tensor] = {}
    h = params["cond_head"]
    _block3x3(sd, "COND_DNET.jointConv", h["jointConv"],
              stats["cond_head"]["jointConv"])
    sd["COND_DNET.outlogits.0.weight"] = _conv(h["outlogits"]["kernel"])
    sd["COND_DNET.outlogits.0.bias"] = _t(h["outlogits"]["bias"])
    u = params["uncond_head"]["outlogits"]
    sd["UNCOND_DNET.outlogits.0.weight"] = _conv(u["kernel"])
    sd["UNCOND_DNET.outlogits.0.bias"] = _t(u["bias"])
    if scale == 64:
        sd["local.0.weight"] = _conv(params["local_conv"]["kernel"])
        _bn(sd, "local.1", params["local_bn"], stats["local_bn"])
        for i in range(1, 5):
            sd[f"conv{i}.weight"] = _conv(params[f"conv{i}"]["kernel"])
        for i in (2, 3, 4):
            _bn(sd, f"bn{i}", params[f"bn{i}"], stats[f"bn{i}"])
        return sd
    p, s = params["img_code_s16"], stats["img_code_s16"]
    for j, idx in enumerate((0, 2, 5, 8)):
        sd[f"img_code_s16.{idx}.weight"] = _conv(p[f"Conv_{j}"]["kernel"])
    for j, idx in enumerate((3, 6, 9)):
        _bn(sd, f"img_code_s16.{idx}", p[f"TorchBatchNorm_{j}"],
            s[f"TorchBatchNorm_{j}"])
    for name in ("img_code_s32",) + (("img_code_s64",) if scale == 256
                                     else ()):
        sd[f"{name}.0.weight"] = _conv(params[name]["Conv_0"]["kernel"])
        _bn(sd, f"{name}.1", params[name]["TorchBatchNorm_0"],
            stats[name]["TorchBatchNorm_0"])
    for name in (("img_code_s32_1",) if scale == 128
                 else ("img_code_s64_1", "img_code_s64_2")):
        _block3x3(sd, name, params[name], stats[name])
    return sd


def image_encoder_state_dict_from_jax(variables: Mapping[str, Any]
                                      ) -> dict[str, torch.Tensor]:
    """JAX ``CNNEncoder`` variables -> the port's CNNEncoder state dict,
    torchvision's Inception-v3 keys plus ``emb_features`` (a 1x1 conv) and
    ``emb_cnn_code`` (JAX ``io/damsm_import.py:import_image_encoder``,
    inverted; every BatchNorm's ``num_batches_tracked`` 0)."""
    sd: dict[str, torch.Tensor] = {}
    params, stats = variables["params"], variables["batch_stats"]
    sd["emb_features.weight"] = _linear(
        params["emb_features"]["kernel"])[:, :, None, None]
    sd["emb_cnn_code.weight"] = _linear(params["emb_cnn_code"]["kernel"])
    sd["emb_cnn_code.bias"] = _t(params["emb_cnn_code"]["bias"])

    def walk(p: Mapping, s: Mapping, prefix: str) -> None:
        if "conv" in p and "bn" in p:         # a BasicConv2d
            sd[f"{prefix}.conv.weight"] = _conv(p["conv"]["kernel"])
            _bn(sd, f"{prefix}.bn", p["bn"], s["bn"])
            return
        for name, child in p.items():
            walk(child, s[name], f"{prefix}.{name}" if prefix else name)

    walk({k: v for k, v in params.items() if not k.startswith("emb_")},
         stats, "")
    return sd


def load_image_encoder(path: str) -> dict[str, torch.Tensor]:
    """A DAMSM ``image_encoder*.pth``: a bare CNN_ENCODER state dict (or a
    pickled module), for the port's CNNEncoder to load with strict=True."""
    return load_text_encoder(path)


# a torchvision inception_v3 state dict's modules the image encoder lacks
INCEPTION_EXTRA_PREFIXES = ("AuxLogits.", "fc.")
DAMSM_HEADS = ("emb_features.", "emb_cnn_code.")


def load_inception_backbone(image_encoder: nn.Module, path: str) -> None:
    """Load a torchvision ``inception_v3`` state dict (ImageNet weights,
    ``$INCEPTION_V3_WEIGHTS``) into the CNNEncoder's backbone, in place:
    its ``AuxLogits.`` and ``fc.`` keys are dropped and the two heads keep
    their values (JAX ``io/damsm_import.py:import_image_encoder`` with
    ``skip_prefixes``). Any other key the two do not share raises."""
    sd = {k: v for k, v in load_text_encoder(path).items()
          if not k.startswith(INCEPTION_EXTRA_PREFIXES)}
    missing, unexpected = image_encoder.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.startswith(DAMSM_HEADS)]
    if missing or unexpected:
        raise KeyError(f"{path}: not an inception_v3 backbone (missing "
                       f"{missing[:5]}, unexpected {unexpected[:5]})")


def export_damsm_encoders(text_encoder: nn.Module, image_encoder: nn.Module,
                          directory: str, epoch: int) -> tuple[str, str]:
    """Write ``<directory>/text_encoder<epoch>.pth`` and
    ``image_encoder<epoch>.pth``: each encoder's state dict on the CPU
    (the reference's keys, ``num_batches_tracked`` kept), the format of the
    published DAMSM files, which :func:`load_text_encoder` and
    :func:`load_image_encoder` read for ``build_text_encoder`` and
    ``build_image_encoder`` with strict=True, and JAX ``io/damsm_import``
    reads too. Returns the two paths."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for name, module in (("text_encoder", text_encoder),
                         ("image_encoder", image_encoder)):
        path = os.path.join(directory, f"{name}{epoch}.pth")
        torch.save({k: v.detach().cpu().clone()
                    for k, v in module.state_dict().items()}, path)
        paths.append(path)
    return paths[0], paths[1]


def load_reference_attngan_d(path: str) -> dict[str, torch.Tensor]:
    """A reference ``netD{i}.pth`` (a bare D_NET64/128/256 state dict, as
    code/coco/attngan/trainer.py:119-126 reads it, or ``{'netD': ...}``),
    for :func:`build_attngan_d` to load with strict=True."""
    return _reference_state_dict(path, "netD")


def load_reference_attngan_g(path: str) -> dict[str, torch.Tensor]:
    """The G_NET state dict of a reference-format ``.pth`` (its ``netG``,
    as the reference saves it, code/coco/attngan/trainer.py:497-504, or a
    bare state dict), for :func:`build_attngan_g` to load with
    strict=True."""
    return _reference_state_dict(path, "netG")


def load_text_encoder(path: str) -> dict[str, torch.Tensor]:
    """A DAMSM ``text_encoder*.pth`` (NET_E): a bare RNN_ENCODER state dict
    (or a pickled module), for the port's RNNEncoder to load with
    strict=True. Also reads an ``image_encoder*.pth``, which has the same
    form (:func:`load_image_encoder`)."""
    sd = torch_load(path)
    return dict(sd.state_dict() if hasattr(sd, "state_dict") else sd)


def _reference_state_dict(path: str, key: str) -> dict[str, torch.Tensor]:
    """``ckpt[key]`` of a reference-format ``.pth``, or the file itself
    when it is a bare state dict."""
    ckpt = torch_load(path)
    return dict(ckpt[key] if key in ckpt else ckpt)


def load_reference_g(path: str) -> dict[str, torch.Tensor]:
    """The generator state dict of a reference-format ``.pth``: either
    ``{'epoch', 'netG', ...}`` as the reference's save_model writes it
    (code/multi-mnist/miscc/utils.py:160-174) or a bare state dict. The
    keys are the reference STAGE1_G's for every stage-1 family (JAX
    ``io/torch_import.py:96-110``: ``label.*`` is the live embedding of
    clevr and stackgan and mnist's dead module, ``ca_net.fc.*`` the CA
    net), so :func:`build_stage1_g` loads the result with strict=True. A
    STAGE2_G's holds its frozen STAGE1_G under ``STAGE1_G.``
    (:func:`split_stage2_g`)."""
    return _reference_state_dict(path, "netG")


def load_reference_d(path: str) -> dict[str, torch.Tensor]:
    """The discriminator state dict of a reference-format ``.pth``: a bare
    state dict, as the reference saves netD (code/multi-mnist/miscc/
    utils.py:165-168), or ``{'netD': ...}``. The keys are STAGE1_D's and
    D_GET_LOGITS's (JAX ``io/torch_import.py:import_stage1_d``), or
    STAGE2_D's, so :func:`build_stage1_d` or :func:`build_stage2_d` loads
    the result with strict=True."""
    return _reference_state_dict(path, "netD")


STAGE1_PREFIX = "STAGE1_G."   # the frozen stage-1 G inside a STAGE2_G


def split_stage2_g(sd: Mapping[str, torch.Tensor]
                   ) -> tuple[Optional[dict], dict]:
    """A reference STAGE2_G state dict -> (the wrapped frozen STAGE1_G's
    state dict, its prefix taken off, or None when it has none; the rest,
    Stage2G's), as JAX ``io/torch_import.py:import_stage2_g`` splits it."""
    s1 = {k[len(STAGE1_PREFIX):]: v for k, v in sd.items()
          if k.startswith(STAGE1_PREFIX)}
    s2 = {k: v for k, v in sd.items() if not k.startswith(STAGE1_PREFIX)}
    return s1 or None, s2


def _is_pth(path: str) -> bool:
    return bool(path) and str(path).endswith(".pth") and os.path.exists(path)


def warm_start(state, net_g: str = "", net_d: str = "",
               frozen_g: Optional[nn.Module] = None) -> list[str]:
    """The reference's NET_G/NET_D warm start (load_network_stageI,
    code/multi-mnist/trainer.py:59-68; JAX ``train/loop.py:150-160``):
    each path that ends in ``.pth`` and exists is loaded into ``state.g``
    or ``state.d`` with strict=True. With ``frozen_g``, stage 2's frozen
    stage-1 G (load_network_stageII, code/coco/stackgan/trainer.py:117-151;
    JAX ``cli/stage2_runner.py:80-98``), NET_G is a STAGE2_G: its
    ``STAGE1_G.`` part, when it has one, goes to ``frozen_g``. Returns the
    paths loaded."""
    loaded = []
    if _is_pth(net_g):
        sd = load_reference_g(net_g)
        if frozen_g is not None:
            s1, sd = split_stage2_g(sd)
            if s1 is not None:
                frozen_g.load_state_dict(s1, strict=True)
        state.g.load_state_dict(sd, strict=True)
        loaded.append(net_g)
    if _is_pth(net_d):
        state.d.load_state_dict(load_reference_d(net_d), strict=True)
        loaded.append(net_d)
    return loaded


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
