"""Lineage ``.pth`` names -> the port's state-dict names. Port of
``objgan_tpu/core/name_maps.py``, onto the port's modules.

The lineage (the public AttnGAN/Obj-GAN code) saves raw PyTorch state dicts:
``text_encoder.pth``, ``image_encoder.pth``, ``netG_epoch_N.pth`` and
``netD*.pth``. These tables map their module names onto the port's
(``ca_net.fc.weight``, ``attn_stage1.word_proj.weight``, ...), which are the
JAX package's param paths with ``.`` for ``/`` and ``weight`` for
``kernel``, so a map here lands where the JAX package's lands.
``core/checkpoint.py``'s ``convert_torch_state_dict`` and ``apply_converted``
load them in one call; the layouts are the port's (torch layouts, the LSTM
in the JAX layout).

Two kinds of entries:

* mapped: the DAMSM encoders transfer exactly, every parameter;
* skipped: the lineage's BatchNorm layers are GroupNorm here (see
  ``models/common.py``), so G_NET / D_NET BatchNorm weights, biases and
  running statistics have no counterpart and are reported, not loaded
  (``load_lineage_partial``, ``split_convertible``). Conv and Linear weights,
  most of the parameters, transfer exactly where the widths agree.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

import torch
import torch.nn as nn

from objgan_tpu_torch.core.checkpoint import (apply_converted,
                                              convert_torch_state_dict,
                                              export_torch_state_dict,
                                              to_port_layout)


def bilstm_name_map(torch_prefix: str, port_prefix: str) -> Dict[str, str]:
    """Single-layer bidirectional ``nn.LSTM`` -> ``ops/lstm.py::BiLSTM``: the
    weights transpose to (in, 4H) / (H, 4H); each direction's two bias
    vectors share the port's one ``b`` and are summed by the converter."""
    m: Dict[str, str] = {}
    for tdir, pdir in (("", "fwd"), ("_reverse", "bwd")):
        m[f"{torch_prefix}weight_ih_l0{tdir}"] = f"{port_prefix}{pdir}_w_ih"
        m[f"{torch_prefix}weight_hh_l0{tdir}"] = f"{port_prefix}{pdir}_w_hh"
        m[f"{torch_prefix}bias_ih_l0{tdir}"] = f"{port_prefix}{pdir}_b"
        m[f"{torch_prefix}bias_hh_l0{tdir}"] = f"{port_prefix}{pdir}_b"
    return m


def rnn_encoder_name_map() -> Dict[str, str]:
    """Lineage ``RNN_ENCODER`` (``text_encoder.pth``): ``encoder``
    (nn.Embedding) + ``rnn`` (bi-LSTM) -> ``models/damsm.py::RNNEncoder``."""
    m = {"encoder.weight": "embedding.weight"}
    m.update(bilstm_name_map("rnn.", "bilstm."))
    return m


def cnn_encoder_name_map(torch_names: Iterable[str]) -> Dict[str, str]:
    """Lineage ``CNN_ENCODER`` (``image_encoder.pth``) ->
    ``models/inception_v3.py::InceptionEncoder``.

    The lineage sets torchvision Inception-v3's submodules on itself
    (``Conv2d_1a_3x3`` ... ``Mixed_7c``) and adds ``emb_features`` (a
    bias-free 1x1 conv of Mixed_6e) and ``emb_cnn_code`` (nn.Linear of the
    2048 pool). The backbone's names go through the port's torchvision map
    (``inception_v3.torch_name_map``) under ``backbone.``."""
    from objgan_tpu_torch.models.inception_v3 import torch_name_map

    out: Dict[str, str] = {}
    backbone = []
    for name in torch_names:
        if name.endswith("num_batches_tracked"):
            continue
        if name in ("emb_features.weight", "emb_cnn_code.weight",
                    "emb_cnn_code.bias"):
            out[name] = name
        else:
            backbone.append(name)
    for tname, pname in torch_name_map(backbone).items():
        out[tname] = "backbone." + pname
    return out


def load_rnn_encoder_checkpoint(module: nn.Module,
                                state_dict: Mapping) -> nn.Module:
    """Write a lineage ``text_encoder.pth`` state dict into an
    ``RNNEncoder`` (exact: every parameter transfers). Returns it."""
    return apply_converted(module, convert_torch_state_dict(
        state_dict, rnn_encoder_name_map()))


def load_cnn_encoder_checkpoint(module: nn.Module,
                                state_dict: Mapping) -> nn.Module:
    """Write a lineage ``image_encoder.pth`` state dict into an
    ``InceptionEncoder`` (exact: backbone and both projections; the
    ``AuxLogits`` tower and the BatchNorm step counters are dropped).
    Returns it."""
    usable = {k: v for k, v in state_dict.items()
              if not k.startswith("AuxLogits")
              and not k.endswith("num_batches_tracked")}
    return apply_converted(module, convert_torch_state_dict(
        usable, cnn_encoder_name_map(usable)))


def export_rnn_encoder(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The inverse of ``load_rnn_encoder_checkpoint``: an ``RNNEncoder`` as
    a lineage ``text_encoder.pth`` state dict (exact; the LSTM bias splits
    as ``bias_ih = b``, ``bias_hh = 0``, see
    ``checkpoint.export_torch_state_dict``)."""
    return export_torch_state_dict(module, rnn_encoder_name_map())


_BN_EXPORT = {"bn_scale": "bn.weight", "bn_bias": "bn.bias",
              "bn_mean": "bn.running_mean", "bn_var": "bn.running_var"}


def cnn_encoder_export_name_map(module: nn.Module) -> Dict[str, str]:
    """lineage -> port map covering an ``InceptionEncoder``, the lineage
    names derived from the port's (the inverse of ``torch_name_map``).

    The backbone's ``fc`` classifier is left out: the lineage
    ``CNN_ENCODER`` keeps torchvision's feature modules only and replaces
    the classifier with its two projections, so its state dict has no
    ``fc.*``."""
    m: Dict[str, str] = {"emb_features.weight": "emb_features.weight",
                         "emb_cnn_code.weight": "emb_cnn_code.weight",
                         "emb_cnn_code.bias": "emb_cnn_code.bias"}
    for pname in module.state_dict():
        if not pname.startswith("backbone."):
            continue
        *scope, leaf = pname[len("backbone."):].split(".")
        if scope == ["fc"]:
            continue
        if leaf in ("weight", "bias"):
            m[".".join(scope + [leaf])] = pname
        elif leaf in _BN_EXPORT:
            m[".".join(scope + [_BN_EXPORT[leaf]])] = pname
        else:
            raise KeyError(f"unhandled InceptionEncoder param {pname!r}")
    return m


def export_cnn_encoder(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The inverse of ``load_cnn_encoder_checkpoint``: an
    ``InceptionEncoder`` as a lineage ``image_encoder.pth`` state dict. The
    BatchNorm ``num_batches_tracked`` buffers, dropped on import, come back
    as int64 zeros, so torch's strict ``load_state_dict`` takes the dict."""
    out = export_torch_state_dict(module, cnn_encoder_export_name_map(module))
    for name in [n for n in out if n.endswith(".running_mean")]:
        scope = name[: -len("running_mean")]
        out[scope + "num_batches_tracked"] = torch.zeros((),
                                                         dtype=torch.int64)
    return out


def g_net_name_map(cfg) -> Dict[str, str]:
    """Lineage ``G_NET`` (``netG_epoch_N.pth``) -> ``models/generator.py::
    GNet``, best effort, for ``load_lineage_partial``.

    Covered: ``ca_net.fc`` (exact: CANet keeps the lineage's fc, GLU and
    split), the init stage's fc and up-block convs, the attention
    ``conv_context`` (a 1x1 conv onto the ``word_proj`` Dense, squeezed by
    the loader), the residual blocks' convs, each stage's up-sampling conv
    and the bias-free image heads. Not covered, by documented divergence:
    BatchNorm (GroupNorm here), the first up-block's input widened by the
    layout channels, Obj-GAN's object-attention additions (no public
    lineage naming)."""
    n_up = max(1, (cfg.TREE.BASE_SIZE // 4).bit_length() - 1)
    m = {"ca_net.fc.weight": "ca_net.fc.weight",
         "ca_net.fc.bias": "ca_net.fc.bias",
         "h_net1.fc.0.weight": "init_stage.fc.weight"}
    for k in range(n_up):
        # lineage upBlock = Sequential(Upsample, conv3x3, BN, GLU)
        m[f"h_net1.upsample{k + 1}.1.weight"] = f"init_stage.up{k}.conv.weight"
    for i in range(1, cfg.TREE.BRANCH_NUM):
        t, p = f"h_net{i + 1}", f"attn_stage{i}"
        m[f"{t}.att.conv_context.weight"] = f"{p}.word_proj.weight"
        for r in range(cfg.GAN.R_NUM):
            m[f"{t}.residual.{r}.block.0.weight"] = f"{p}.res{r}.conv1.weight"
            m[f"{t}.residual.{r}.block.3.weight"] = f"{p}.res{r}.conv2.weight"
        m[f"{t}.upsample.1.weight"] = f"{p}.up.conv.weight"
    for i, size in enumerate(cfg.branch_sizes):
        m[f"img_net{i + 1}.img.0.weight"] = f"img{size}.img.weight"
    return m


def d_net_name_map(cfg, img_size: int) -> Dict[str, str]:
    """Lineage ``D_NET64/128/256`` (``netD*.pth``) ->
    ``models/discriminator.py::DNet`` for one pyramid scale.

    Covered: the ``encode_image_by_16times`` trunk convs but the first (its
    input here has the layout canvas's channels too, so mapping it would
    put it in ``skipped_shape`` on every load), the deeper down and
    compress convs of D_NET128/256, the ``jointConv`` block and both logit
    heads. BatchNorm entries are skipped."""
    m = {"img_code_s16.2.weight": "down_blocks_1.Conv_0.weight",
         "img_code_s16.5.weight": "down_blocks_2.Conv_0.weight",
         "img_code_s16.8.weight": "down_blocks_3.Conv_0.weight",
         "COND_DNET.jointConv.0.weight": "cond_block.Conv_0.weight",
         "COND_DNET.outlogits.0.weight": "cond_logits.weight",
         "COND_DNET.outlogits.0.bias": "cond_logits.bias",
         "UNCOND_DNET.outlogits.0.weight": "uncond_logits.weight",
         "UNCOND_DNET.outlogits.0.bias": "uncond_logits.bias"}
    if img_size >= 128:
        m["img_code_s32.0.weight"] = "down_blocks_4.Conv_0.weight"
    if img_size >= 256:
        m["img_code_s64.0.weight"] = "down_blocks_5.Conv_0.weight"
        m["img_code_s64_1.0.weight"] = "extra.Conv_0.weight"
    elif img_size >= 128:
        m["img_code_s32_1.0.weight"] = "extra.Conv_0.weight"
    return m


def load_lineage_partial(module: nn.Module, state_dict: Mapping,
                         name_map: Mapping[str, str]):
    """Best-effort lineage import: load every mapped entry whose shape
    matches the module's; a 1x1 conv onto a Dense weight is squeezed
    (``[:, :, 0, 0]``). Returns ``(module, report)``, the report listing
    lineage names under ``loaded``, ``skipped_bn``, ``skipped_shape``
    (the target exists, the widths differ), ``missing_target`` (the map
    names a parameter this module lacks: a stale entry or a smaller
    config) and ``unmapped``; the caller decides how loud to be."""
    state = module.state_dict()
    shapes = {k: tuple(getattr(v, "shape", ())) for k, v in state_dict.items()}
    report: Dict[str, List[str]] = {
        "loaded": [], "skipped_bn": [], "skipped_shape": [],
        "missing_target": [], "unmapped": []}
    converted = {}
    for tname, value in state_dict.items():
        if tname not in name_map:
            report["skipped_bn" if is_batchnorm_param(tname, shapes)
                   else "unmapped"].append(tname)
            continue
        target = name_map[tname]
        if target not in state:
            report["missing_target"].append(tname)
            continue
        t = to_port_layout(tname, value)
        want = tuple(state[target].shape)
        if tuple(t.shape) != want and t.dim() == 4 and \
                tuple(t.shape[2:]) == (1, 1):
            t = t[:, :, 0, 0]  # 1x1 conv -> Dense weight (out, in)
        if tuple(t.shape) != want:
            report["skipped_shape"].append(tname)
            continue
        converted[target] = t
        report["loaded"].append(tname)
    return apply_converted(module, converted), report


_BN_LEAVES = ("running_mean", "running_var", "num_batches_tracked")


def is_batchnorm_param(torch_name: str,
                       shapes: Mapping[str, Tuple[int, ...]]) -> bool:
    """Lineage G/D state dicts: BatchNorm entries are the running
    statistics and the ``weight``/``bias`` of a scope that has them."""
    if torch_name.endswith(_BN_LEAVES):
        return True
    scope, _, leaf = torch_name.rpartition(".")
    if leaf in ("weight", "bias"):
        return (scope + ".running_mean") in shapes
    return False


def split_convertible(state_dict: Mapping, name_map: Mapping[str, str]
                      ) -> Tuple[Dict, List[str], List[str]]:
    """A lineage state dict split into ``(mapped entries, skipped BatchNorm
    names, unmapped names)``. The BatchNorm skips are expected (the
    GroupNorm divergence); the caller decides whether the rest is an
    error."""
    shapes = {k: tuple(getattr(v, "shape", ())) for k, v in state_dict.items()}
    mapped, skipped_bn, unmapped = {}, [], []
    for name, value in state_dict.items():
        if name in name_map:
            mapped[name] = value
        elif is_batchnorm_param(name, shapes):
            skipped_bn.append(name)
        else:
            unmapped.append(name)
    return mapped, skipped_bn, unmapped
