"""Recurrent cells: LSTM, bi-LSTM with pack_padded semantics, conv-LSTM and
bi-conv-LSTM. Port of ``objgan_tpu/ops/lstm.py``.

Parameters stay in the JAX package's layout, so the param bridge copies
them unchanged: ``w_ih`` (D, 4H), ``w_hh`` (H, 4H) and a single bias ``b``
(4H,), gate order i|f|g|o. The conv-LSTM's gate conv keeps its bias. A
recurrence is a Python loop over time: the sequences are <= 20 words or
<= 10 objects long.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from objgan_tpu_torch.core.layers import Conv, lecun_normal_, orthogonal_

Carry = Tuple[torch.Tensor, torch.Tensor]


def _gates(gates: torch.Tensor, c: torch.Tensor) -> Carry:
    i, f, g, o = gates.chunk(4, dim=-1)
    new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    return new_h, new_c


class LSTMCell(nn.Module):
    """Plain LSTM cell, gate order i|f|g|o, fp32."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        self.w_ih = nn.Parameter(torch.empty(in_features, 4 * features))
        self.w_hh = nn.Parameter(torch.empty(features, 4 * features))
        self.b = nn.Parameter(torch.zeros(4 * features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.w_ih, self.w_ih.shape[0], generator)
        orthogonal_(self.w_hh, generator)
        nn.init.zeros_(self.b)

    def forward(self, carry: Carry, x: torch.Tensor) -> Tuple[Carry,
                                                               torch.Tensor]:
        h, c = carry
        gates = x @ self.w_ih + h @ self.w_hh + self.b
        new_h, new_c = _gates(gates, c)
        return (new_h, new_c), new_h

    @staticmethod
    def init_carry(batch: int, features: int,
                   device: torch.device) -> Carry:
        z = torch.zeros(batch, features, device=device)
        return z, z


class BiLSTM(nn.Module):
    """Bi-directional LSTM over padded (B, T, D) with per-sequence lengths.

    Returns (outputs (B, T, 2H), (h_fwd, h_bwd) final hiddens (B, H) each).
    pack_padded semantics: the carry does not move on padded steps and the
    outputs there are zero. The backward direction scans the time-reversed
    sequence, padding first, as the JAX package does."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        h = features
        for d in ("fwd", "bwd"):
            self.register_parameter(f"{d}_w_ih",
                                    nn.Parameter(torch.empty(in_features,
                                                             4 * h)))
            self.register_parameter(f"{d}_w_hh",
                                    nn.Parameter(torch.empty(h, 4 * h)))
            self.register_parameter(f"{d}_b",
                                    nn.Parameter(torch.zeros(4 * h)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for d in ("fwd", "bwd"):
            w_ih = getattr(self, f"{d}_w_ih")
            lecun_normal_(w_ih, w_ih.shape[0], generator)
            orthogonal_(getattr(self, f"{d}_w_hh"), generator)
            nn.init.zeros_(getattr(self, f"{d}_b"))

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor):
        b, t, _ = xs.shape
        h = self.features
        x = xs.float()
        valid = (torch.arange(t, device=xs.device)[None, :]
                 < lengths[:, None]).float()  # (B, T)
        # input projections hoisted out of the recurrence
        xw = torch.stack([x @ self.fwd_w_ih + self.fwd_b,
                          (x @ self.bwd_w_ih + self.bwd_b).flip(1)])
        v = torch.stack([valid, valid.flip(1)])[..., None]  # (2, B, T, 1)
        w_hh = torch.stack([self.fwd_w_hh, self.bwd_w_hh])  # (2, H, 4H)
        hc = torch.zeros(2, b, h, device=xs.device)
        cc = torch.zeros_like(hc)
        ys = []
        for s in range(t):
            gates = xw[:, :, s] + torch.bmm(hc, w_hh)
            new_h, new_c = _gates(gates, cc)
            vs = v[:, :, s]
            hc = new_h * vs + hc * (1.0 - vs)
            cc = new_c * vs + cc * (1.0 - vs)
            ys.append(new_h * vs)
        ys = torch.stack(ys, dim=2)  # (2, B, T, H)
        out = torch.cat([ys[0], ys[1].flip(1)], dim=-1)
        return out, (hc[0], hc[1])


class ConvLSTMCell(nn.Module):
    """Convolutional LSTM cell over NHWC maps, gates i|f|g|o from one 3x3
    conv (with bias) of [x ; h]."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int] = (3, 3)):
        super().__init__()
        self.features = features
        self.gates = Conv(in_features + features, 4 * features, kernel,
                          bias=True)

    def forward(self, carry: Carry, x: torch.Tensor) -> Tuple[Carry,
                                                               torch.Tensor]:
        h, c = carry
        gates = self.gates(torch.cat([x, h], dim=-1))
        new_h, new_c = _gates(gates, c)
        return (new_h, new_c), new_h


class _MaskedConvLSTMCell(nn.Module):
    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int]):
        super().__init__()
        self.cell = ConvLSTMCell(in_features, features, kernel)

    def forward(self, carry: Carry, x_t: torch.Tensor,
                v_t: torch.Tensor) -> Tuple[Carry, torch.Tensor]:
        new_carry, y = self.cell(carry, x_t)
        v = v_t[:, None, None, None].to(y.dtype)
        carry = tuple(n * v + old * (1.0 - v)
                      for n, old in zip(new_carry, carry))
        return carry, y * v


class BiConvLSTM(nn.Module):
    """Bi-directional conv-LSTM over an object sequence (B, O, H, W, C).
    Returns (B, O, H, W, 2F): forward and backward passes concatenated."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int] = (3, 3)):
        super().__init__()
        self.features = features
        self.fwd = _MaskedConvLSTMCell(in_features, features, kernel)
        self.bwd = _MaskedConvLSTMCell(in_features, features, kernel)

    def forward(self, xs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        b, o, h, w, _ = xs.shape
        valid = valid.to(xs.dtype)
        zero = xs.new_zeros(b, h, w, self.features)
        outs = []
        for cell, order in ((self.fwd, range(o)),
                            (self.bwd, reversed(range(o)))):
            carry = (zero, zero)
            ys = [None] * o
            for i in order:
                carry, ys[i] = cell(carry, xs[:, i], valid[:, i])
            outs.append(torch.stack(ys, dim=1))
        return torch.cat(outs, dim=-1)
