"""VGG-16 (the torchvision graph), NHWC: the backbone of Stage B's
perceptual loss (``SHAPE.PERCEPTUAL: vgg``). Port of
``objgan_tpu/models/vgg.py``.

``VGG16`` takes images (B, H, W, 3) in [0, 1], ImageNet-normalises them
and returns the ReLU after each named conv (``relu1_2`` ... ``relu5_3``),
stopping at ``stop_at`` (small inputs such as 16 px masks would reach a
zero-size pool in block 5), plus ``logits`` with the classifier (224 px
input). Convs are ``features_<i>`` and dense layers ``classifier_<i>``,
after torchvision's Sequential indices, so ``core/bridge.py`` carries the
JAX tree across and ``torch_name_map`` is mechanical. No weight file
ships: ``load_torchvision_vgg16`` writes a torchvision ``vgg16`` state
dict into the module; ``classifier.0`` reads the flattened conv grid in
(C, H, W) order there and (H, W, C) here, so its columns are permuted.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from objgan_tpu_torch.core.layers import Conv, Dense

# torchvision vgg16 "features": Sequential index -> out-channels ('M' = 2x2
# max pool). The indices name the parameters.
VGG16_LAYERS: Tuple[Tuple[int, Any], ...] = (
    (0, 64), (2, 64), (4, "M"),
    (5, 128), (7, 128), (9, "M"),
    (10, 256), (12, 256), (14, 256), (16, "M"),
    (17, 512), (19, 512), (21, 512), (23, "M"),
    (24, 512), (26, 512), (28, 512), (30, "M"),
)

# the perceptual taps: the ReLU following each named conv
PERCEPTUAL_TAPS = ("relu1_2", "relu2_2", "relu3_3", "relu4_3")
_TAP_AFTER_CONV = {2: "relu1_2", 7: "relu2_2", 14: "relu3_3",
                   21: "relu4_3", 28: "relu5_3"}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG16(nn.Module):
    """images (B, H, W, 3) in [0, 1] -> {tap: (B, h, w, C) fp32}, up to
    ``stop_at``; ``logits`` too ``with_classifier`` (224 px input)."""

    def __init__(self, with_classifier: bool = False,
                 stop_at: str = "relu5_3"):
        super().__init__()
        self.with_classifier = with_classifier
        self.stop_at = stop_at
        self.layers = []
        prev = 3
        for idx, spec in VGG16_LAYERS:
            self.layers.append((idx, spec))
            if spec == "M":
                continue
            self.add_module(f"features_{idx}", Conv(
                prev, spec, (3, 3), bias=True, dtype=torch.float32,
                padding=((1, 1), (1, 1))))
            prev = spec
            if (_TAP_AFTER_CONV.get(idx) == stop_at
                    and not with_classifier):
                break
        if with_classifier:
            self.classifier_0 = Dense(512 * 7 * 7, 4096)
            self.classifier_3 = Dense(4096, 4096)
            self.classifier_6 = Dense(4096, 1000)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = (images.float() - self.mean) / self.std
        taps: Dict[str, torch.Tensor] = {}
        for idx, spec in self.layers:
            if spec == "M":
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(
                    0, 2, 3, 1)
                continue
            x = torch.relu(getattr(self, f"features_{idx}")(x))
            tap = _TAP_AFTER_CONV.get(idx)
            if tap is not None:
                taps[tap] = x
                if tap == self.stop_at and not self.with_classifier:
                    return taps
        if self.with_classifier:
            x = x.reshape(x.shape[0], -1)  # (B, 7*7*512), HWC order
            x = torch.relu(self.classifier_0(x))
            x = torch.relu(self.classifier_3(x))
            taps["logits"] = self.classifier_6(x)
        return taps


def _rgb(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 3:
        x = x[..., None]
    return x.expand(*x.shape[:-1], 3) if x.shape[-1] == 1 else x


def vgg_perceptual_loss(vgg: VGG16, fake: torch.Tensor, real: torch.Tensor,
                        taps: Sequence[str] = PERCEPTUAL_TAPS
                        ) -> torch.Tensor:
    """Per-sample mean L1 distance between ``vgg``'s features of ``fake``
    and of ``real`` (the real side detached), summed over ``taps``:
    (N,) fp32. Inputs (N, S, S) or (N, S, S, C) in [0, 1]; single-channel
    masks are tiled to RGB."""
    f = vgg(_rgb(fake))
    r = vgg(_rgb(real))
    total = torch.zeros(fake.shape[0], device=fake.device)
    for t in taps:
        total = total + (f[t] - r[t].detach()).abs().mean(dim=(1, 2, 3))
    return total


# -- torchvision conversion --------------------------------------------------


def torch_name_map(torch_names: Iterable[str]) -> Dict[str, str]:
    """torchvision ``vgg16`` state-dict names -> ``VGG16`` parameter names
    (``features.0.weight`` -> ``features_0.weight``)."""
    out: Dict[str, str] = {}
    for name in torch_names:
        parts = name.split(".")
        if (len(parts) == 3 and parts[0] in ("features", "classifier")
                and parts[2] in ("weight", "bias")):
            out[name] = f"{parts[0]}_{parts[1]}.{parts[2]}"
        else:
            raise KeyError(f"unhandled torchvision vgg16 param {name!r}")
    return out


def load_torchvision_vgg16(vgg: VGG16,
                           state_dict: Mapping[str, torch.Tensor]) -> VGG16:
    """Write a torchvision ``vgg16`` state dict into ``vgg``. Entries with
    no parameter here (the classifier without ``with_classifier``, convs
    past ``stop_at``) are skipped; every parameter of ``vgg`` must be
    covered. ``classifier.0.weight`` (4096, C*H*W) has its columns
    permuted to this module's (H*W*C) order. Returns ``vgg``."""
    params = dict(vgg.named_parameters())
    name_map = {k: v for k, v in torch_name_map(state_dict).items()
                if v in params}
    missing = sorted(set(params) - set(name_map.values()))
    if missing:
        raise KeyError(f"torchvision state dict lacks {missing[:8]}")
    with torch.no_grad():
        for src, dst in name_map.items():
            val = torch.as_tensor(state_dict[src])
            if dst == "classifier_0.weight":
                val = val.reshape(4096, 512, 7, 7).permute(0, 2, 3, 1
                                                          ).reshape(4096, -1)
            if tuple(val.shape) != tuple(params[dst].shape):
                raise ValueError(f"shape mismatch at {src}: "
                                 f"{tuple(val.shape)} vs "
                                 f"{tuple(params[dst].shape)}")
            params[dst].copy_(val)
    return vgg
