"""Inception-v3 (the torchvision graph), NHWC: the backbone of strict
FID/IS and of the ``inception`` DAMSM image encoder. Port of
``objgan_tpu/models/inception_v3.py``.

* ``BasicConv2d``: conv (no bias) -> BatchNorm folded as frozen affine
  statistics at eps 1e-3 -> ReLU. Linen's explicit pads: VALID by default,
  the 1x7 / 7x1 convs pad (0, 3) / (3, 0).
* ``InceptionV3``: images (B, S, S, 3) in [-1, 1], resized to 299 px
  (bilinear, no antialias, as torch's ``F.interpolate``), -> ``mixed_6e``
  (B, 17, 17, 768), ``pool`` (B, 2048) and ``logits`` (B, 1000), fp32.
* ``InceptionEncoder``: the lineage's ``CNN_ENCODER`` on it: the backbone
  frozen (its parameters take no gradient, so no optimiser holds or moves
  them) and two trainable projections, a bias-free 1x1 conv of the regions
  and a dense layer with bias of the pool; the same interface as
  ``damsm.CNNEncoder``. As in the lineage, a gradient passes through the
  frozen backbone to images that require one: Stage C's DAMSM term reaches
  G through it. The JAX package stops that gradient (``stop_gradient`` on
  both features), so there G trains without its DAMSM term; ``ROADMAP.md``
  pins the difference. Real images (DAMSM pretraining, evaluation) require
  no gradient, and no autograd graph is built through the backbone.

Submodules carry the JAX module names, so ``core/bridge.py`` carries a JAX
param tree across. No weight file ships: ``load_torchvision_checkpoint``
writes a torchvision ``inception_v3`` state dict into the modules.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from objgan_tpu_torch.core.layers import Conv, Dense

BN_EPS = 1e-3


class BasicConv2d(nn.Module):
    """conv (no bias) + frozen BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int], stride: int = 1,
                 padding: Tuple[int, int] = (0, 0)):
        super().__init__()
        ph, pw = padding
        self.conv = Conv(in_features, features, kernel, stride=stride,
                         dtype=torch.float32, padding=((ph, ph), (pw, pw)))
        self.bn_scale = nn.Parameter(torch.ones(features))
        self.bn_bias = nn.Parameter(torch.zeros(features))
        self.bn_mean = nn.Parameter(torch.zeros(features))
        self.bn_var = nn.Parameter(torch.ones(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for p, v in ((self.bn_scale, 1.0), (self.bn_bias, 0.0),
                         (self.bn_mean, 0.0), (self.bn_var, 1.0)):
                p.fill_(v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.bn_var + BN_EPS) * self.bn_scale
        return torch.relu(self.conv(x) * inv + (self.bn_bias
                                                - self.bn_mean * inv))


def _nchw(fn, x: torch.Tensor) -> torch.Tensor:
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    # Linen max_pool((3, 3), strides=(2, 2)), VALID
    return _nchw(lambda t: F.max_pool2d(t, 3, 2), x)


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    # torch F.avg_pool2d(k=3, s=1, p=1) with count_include_pad=True
    return _nchw(lambda t: F.avg_pool2d(t, 3, 1, 1, count_include_pad=True),
                 x)


def _cat(*xs: torch.Tensor) -> torch.Tensor:
    return torch.cat(xs, dim=-1)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, (1, 1))
        self.branch5x5_1 = BasicConv2d(cin, 48, (1, 1))
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = BasicConv2d(cin, pool_features, (1, 1))

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return _cat(self.branch1x1(x), b5, b3,
                    self.branch_pool(_avg_pool3(x)))


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return _cat(self.branch3x3(x), bd, _max_pool(x))


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, (1, 1))
        self.branch7x7_1 = BasicConv2d(cin, c7, (1, 1))
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, (1, 1))

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return _cat(self.branch1x1(x), b7, bd,
                    self.branch_pool(_avg_pool3(x)))


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, (1, 1))
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return _cat(b3, b7, _max_pool(x))


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, (1, 1))
        self.branch3x3_1 = BasicConv2d(cin, 384, (1, 1))
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, (1, 1))

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = _cat(self.branch3x3_2a(b3), self.branch3x3_2b(b3))
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = _cat(self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd))
        return _cat(self.branch1x1(x), b3, bd,
                    self.branch_pool(_avg_pool3(x)))


def resize_299(images: torch.Tensor) -> torch.Tensor:
    """(B, S, S, C) -> (B, 299, 299, C), bilinear with half-pixel centres
    and no antialias (``jax.image.resize(..., antialias=False)``)."""
    if images.shape[1] == 299 and images.shape[2] == 299:
        return images
    return _nchw(lambda t: F.interpolate(t, size=(299, 299), mode="bilinear",
                                         align_corners=False,
                                         antialias=False), images)


class InceptionV3(nn.Module):
    """images (B, S, S, 3) in [-1, 1], any square size -> {"mixed_6e",
    "pool", "logits"}, fp32."""

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = Dense(2048, num_classes, dtype=torch.float32)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = resize_299(images.float())
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        mixed_6e = x  # (B, 17, 17, 768)
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pool = x.mean(dim=(1, 2))  # (B, 2048)
        return {"mixed_6e": mixed_6e, "pool": pool, "logits": self.fc(pool)}


class InceptionEncoder(nn.Module):
    """The lineage's ``CNN_ENCODER``: a frozen Inception-v3 ``backbone``
    and trainable projections ``emb_features`` (1x1 conv, no bias) and
    ``emb_cnn_code`` (dense, with bias). images -> (regions (B, 289, D),
    global (B, D)), fp32. The backbone's parameters take no gradient; the
    images' gradient passes through it, as through the lineage's frozen
    encoder."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.backbone = InceptionV3()
        self.backbone.requires_grad_(False)
        self.emb_features = Conv(768, embed_dim, (1, 1), dtype=torch.float32)
        # lineage CNN_ENCODER: emb_cnn_code is a default nn.Linear (bias)
        self.emb_cnn_code = Dense(2048, embed_dim, bias=True,
                                  dtype=torch.float32)

    def forward(self, images: torch.Tensor):
        feats = self.backbone(images)
        regions, pool = feats["mixed_6e"], feats["pool"]
        b, r1, r2, _ = regions.shape
        reg = self.emb_features(regions)
        return reg.reshape(b, r1 * r2, -1), self.emb_cnn_code(pool)


# -- torchvision conversion -------------------------------------------------

_BN_LEAF = {"weight": "bn_scale", "bias": "bn_bias",
            "running_mean": "bn_mean", "running_var": "bn_var"}


def _skipped(name: str) -> bool:
    return name.startswith("AuxLogits") or name.endswith(
        "num_batches_tracked")


def torch_name_map(torch_names: Iterable[str]) -> Dict[str, str]:
    """torchvision ``inception_v3`` state-dict names -> ``InceptionV3``
    parameter names (``Mixed_5b.branch1x1.bn.running_mean`` ->
    ``Mixed_5b.branch1x1.bn_mean``). AuxLogits and the BatchNorm step
    counters are skipped (the eval path reads neither)."""
    out: Dict[str, str] = {}
    for name in torch_names:
        if _skipped(name):
            continue
        *scope, leaf = name.split(".")
        if scope and scope[-1] == "bn":
            out[name] = ".".join(scope[:-1] + [_BN_LEAF[leaf]])
        elif (scope and scope[-1] == "conv" and leaf == "weight") or \
                scope == ["fc"]:
            out[name] = name
        else:
            raise KeyError(f"unhandled torchvision param {name!r}")
    return out


def load_torchvision_checkpoint(module: nn.Module,
                                state_dict: Mapping[str, torch.Tensor]
                                ) -> nn.Module:
    """Write a torchvision ``inception_v3`` state dict into an
    ``InceptionV3`` (or an ``InceptionEncoder``'s ``backbone``): every
    parameter covered exactly once, with its exact shape (torch layouts
    carry over unchanged). Returns the module."""
    net = getattr(module, "backbone", module)
    name_map = torch_name_map(state_dict)
    params = dict(net.named_parameters())
    missing = sorted(set(params) - set(name_map.values()))
    extra = sorted(set(name_map.values()) - set(params))
    if missing or extra:
        raise KeyError(f"torchvision state dict does not match InceptionV3: "
                       f"missing {missing[:8]}, unexpected {extra[:8]}")
    with torch.no_grad():
        for src, dst in name_map.items():
            val = torch.as_tensor(state_dict[src])
            if tuple(val.shape) != tuple(params[dst].shape):
                raise ValueError(f"shape mismatch at {src}: "
                                 f"{tuple(val.shape)} vs "
                                 f"{tuple(params[dst].shape)}")
            params[dst].copy_(val)
    return module


def torchvision_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The inverse of ``load_torchvision_checkpoint``: an ``InceptionV3``'s
    (or an encoder's backbone's) parameters under torchvision's names."""
    net = getattr(module, "backbone", module)
    inverse = {v: k for k, v in _BN_LEAF.items()}
    out = {}
    for name, p in net.named_parameters():
        *scope, leaf = name.split(".")
        if leaf in inverse:
            name = ".".join(scope + ["bn", inverse[leaf]])
        out[name] = p.detach().clone()
    return out
