"""The Linen layers the JAX package builds on, in PyTorch.

``Dense``, ``Conv`` and ``Embed`` hold their weights in torch layout
((out, in), (out, in, kh, kw), (num, features)) and compute like their Linen
counterparts: a layer built with a compute ``dtype`` casts its input and
weights to it (the params stay fp32), and ``Conv`` pads like Linen's
``padding="SAME"`` unless given explicit pads. Activations are NHWC
tensors; a conv runs on the ``permute(0, 3, 1, 2)`` view, which is NCHW
in ``channels_last`` memory, so cuDNN runs it NHWC and the permutes are
free.

Fresh weights use the JAX package's initialisers, drawn from an explicit
``torch.Generator``: lecun-normal kernels, orthogonal recurrent kernels,
zero biases, Linen's embedding init, unit GroupNorm scale. ``init_weights``
walks a module tree in registration order.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

# Linen variance_scaling's truncated-normal correction: the std of a unit
# normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def orthogonal_(w: torch.Tensor, generator: torch.Generator) -> None:
    with torch.no_grad():
        nn.init.orthogonal_(w, generator=generator)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Draw fresh weights for every layer of ``module`` that has
    ``reset_parameters(generator)``, in registration order."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)


class Dense(nn.Module):
    """Linen ``nn.Dense``: y = x @ W^T (+ b) over the last axis."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, torch.float32)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Linen ``nn.Conv`` on NHWC input: ``padding="SAME"`` by default, or
    explicit ((top, bottom), (left, right)) pads as Linen takes them
    (((0, 0), (0, 0)) is ``VALID``)."""

    def __init__(self, in_features: int, out_features: int,
                 kernel: Sequence[int], stride: int = 1, bias: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 padding: Union[str, Sequence[Sequence[int]]] = "SAME"):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.padding = padding
        kh, kw = kernel
        self.weight = nn.Parameter(torch.empty(out_features, in_features, kh,
                                               kw))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, torch.float32)
        if self.padding == "SAME":
            _, h, w, _ = x.shape
            kh, kw = self.weight.shape[2:]
            ph = _same_pads(h, kh, self.stride)
            pw = _same_pads(w, kw, self.stride)
        else:
            ph, pw = self.padding
        xc = x.to(dt).permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        if ph[0] == ph[1] and pw[0] == pw[1]:
            padding = (ph[0], pw[0])
        else:
            xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
            padding = (0, 0)
        wt = self.weight.to(dtype=dt, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(xc, wt, b, stride=self.stride, padding=padding)
        return y.permute(0, 2, 3, 1)


class Embed(nn.Module):
    """Linen ``nn.Embed``: a (num, features) lookup table."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # Linen default_embed_init: variance_scaling(1, fan_in, normal,
        # out_axis=0) on (num, features), i.e. N(0, 1/features)
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(1.0 / self.weight.shape[1]),
                                generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)
