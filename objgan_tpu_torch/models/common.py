"""Shared small layers for all model families: GroupNorm(+GLU) through
kernel K1, and the activations. Port of ``objgan_tpu/models/common.py``."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from objgan_tpu_torch.ops.groupnorm import group_norm


class FusedGroupNorm(nn.Module):
    """GroupNorm over the last (channel) axis, optionally fused with GLU.
    fp32 ``weight``/``bias`` (Linen's ``scale``/``bias``); on a CUDA tensor it
    runs kernel K1 (ops/groupnorm.py). The output dtype is the module's
    ``dtype`` when set, else the input's (Linen ``nn.GroupNorm(dtype=d)``)."""

    def __init__(self, features: int, num_groups: int,
                 dtype: Optional[torch.dtype] = None, use_glu: bool = False,
                 eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.dtype = dtype
        self.use_glu = use_glu
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = group_norm(x.contiguous(), self.weight, self.bias,
                       self.num_groups, self.eps, self.use_glu)
        return y if self.dtype is None else y.to(self.dtype)


def gn(features: int, dtype: Optional[torch.dtype] = None) -> FusedGroupNorm:
    """GroupNorm with gcd(features, 32) groups."""
    return FusedGroupNorm(features, math.gcd(features, 32), dtype)


def gn_glu(features: int,
           dtype: Optional[torch.dtype] = None) -> FusedGroupNorm:
    """GroupNorm -> GLU; ``features`` is the pre-GLU channel count."""
    return FusedGroupNorm(features, math.gcd(features, 32), dtype,
                          use_glu=True)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def glu(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return a * torch.sigmoid(b)
