"""DAMSM text encoder, eval only. Port of ``RNNEncoder`` and
``build_text_encoder`` from ``objgan_tpu/models/damsm.py``: embedding +
bi-LSTM; returns per-word features (B, T, 2H) and the sentence embedding
(B, 2H), the final hiddens of both directions. fp32; no dropout (the
sampling path runs it deterministic)."""

from __future__ import annotations

import torch
import torch.nn as nn

from objgan_tpu.core.config import Config
from objgan_tpu_torch.core.layers import Embed
from objgan_tpu_torch.ops.lstm import BiLSTM


class RNNEncoder(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int = 300,
                 hidden_dim: int = 128):
        super().__init__()
        self.embedding = Embed(vocab_size, embed_dim)
        self.bilstm = BiLSTM(embed_dim, hidden_dim)

    def forward(self, captions: torch.Tensor, cap_lens: torch.Tensor):
        outs, (h_f, h_b) = self.bilstm(self.embedding(captions), cap_lens)
        return outs, torch.cat([h_f, h_b], dim=-1)


def build_text_encoder(cfg: Config) -> RNNEncoder:
    if 2 * cfg.TEXT.HIDDEN_DIM != cfg.TEXT.EMBEDDING_DIM:
        raise ValueError(
            "TEXT.HIDDEN_DIM is the per-direction bi-LSTM width; the "
            "concatenated directions must equal TEXT.EMBEDDING_DIM "
            f"(got 2*{cfg.TEXT.HIDDEN_DIM} != {cfg.TEXT.EMBEDDING_DIM})")
    return RNNEncoder(cfg.TEXT.VOCAB_SIZE, cfg.TEXT.GLOVE_DIM,
                      cfg.TEXT.HIDDEN_DIM)
