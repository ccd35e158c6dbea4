"""DAMSM text and image encoders. Port of ``objgan_tpu/models/damsm.py``:

* ``RNNEncoder``: embedding + dropout + bi-LSTM; per-word features
  (B, T, 2H) and the sentence embedding (B, 2H), the final hiddens of both
  directions. Dropout (``drop_prob`` 0.5, DAMSM pretraining only) takes its
  keep mask as an argument (``keep_mask``); without one the encoder is
  deterministic, as Stage C and serving run it.
* ``CNNEncoder`` (InceptionLite): an all-conv backbone with a 16x16 region
  grid at 256 px; region features (B, R*R, D) and a global feature (B, D),
  both projected to ``TEXT.EMBEDDING_DIM``, fp32.

Both run fp32. ``TEXT.CNN_BACKBONE: inception`` builds
``models/inception_v3.py::InceptionEncoder`` instead of ``CNNEncoder``: a
frozen Inception-v3 with the same two projections.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from objgan_tpu_torch.core.config import Config
from objgan_tpu_torch.core.layers import Conv, Dense, Embed
from objgan_tpu_torch.models.common import gn
from objgan_tpu_torch.ops.lstm import BiLSTM
from objgan_tpu_torch.parallel.sharding import global_batch, local_rows


class RNNEncoder(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int = 300,
                 hidden_dim: int = 128, drop_prob: float = 0.5):
        super().__init__()
        self.embedding = Embed(vocab_size, embed_dim)
        self.bilstm = BiLSTM(embed_dim, hidden_dim)
        self.drop_prob = drop_prob

    def forward(self, captions: torch.Tensor, cap_lens: torch.Tensor,
                keep_mask: Optional[torch.Tensor] = None):
        """``keep_mask`` (B, T, embed_dim) bool, True where an embedding
        value is kept: kept values are scaled by 1 / (1 - drop_prob), the
        rest zeroed, as Linen's ``nn.Dropout``."""
        emb = self.embedding(captions)
        if keep_mask is not None:
            emb = torch.where(keep_mask, emb / (1.0 - self.drop_prob),
                              torch.zeros((), dtype=emb.dtype,
                                          device=emb.device))
        outs, (h_f, h_b) = self.bilstm(emb, cap_lens)
        return outs, torch.cat([h_f, h_b], dim=-1)

    def keep_mask(self, captions: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
        """A dropout keep mask for ``captions`` (B, T), drawn on the
        generator's device: each value kept with probability
        1 - drop_prob. Under data parallelism it is drawn for the global
        batch and this rank's rows are returned, so a row's mask does not
        depend on the world size."""
        b, t = captions.shape
        u = torch.rand(global_batch(b), t, self.embedding.weight.shape[1],
                       generator=generator, device=generator.device)
        return local_rows(u < 1.0 - self.drop_prob)


def build_text_encoder(cfg: Config) -> RNNEncoder:
    if 2 * cfg.TEXT.HIDDEN_DIM != cfg.TEXT.EMBEDDING_DIM:
        raise ValueError(
            "TEXT.HIDDEN_DIM is the per-direction bi-LSTM width; the "
            "concatenated directions must equal TEXT.EMBEDDING_DIM "
            f"(got 2*{cfg.TEXT.HIDDEN_DIM} != {cfg.TEXT.EMBEDDING_DIM})")
    return RNNEncoder(cfg.TEXT.VOCAB_SIZE, cfg.TEXT.GLOVE_DIM,
                      cfg.TEXT.HIDDEN_DIM)


class _ConvBlock(nn.Module):
    """3x3 conv (no bias) -> GroupNorm -> ReLU."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, (3, 3), stride=stride,
                           dtype=dtype)
        self.FusedGroupNorm_0 = gn(features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.FusedGroupNorm_0(self.Conv_0(x)))


class CNNEncoder(nn.Module):
    """InceptionLite: images (B, S, S, 3) in [-1, 1], S >= 64 -> (region
    features (B, (S/16)^2, D) fp32, global feature (B, D) fp32)."""

    # (output width in multiples of base_width, stride) of _ConvBlock_0..5
    _TRUNK = ((1, 2), (2, 2), (4, 2), (4, 1), (8, 2), (8, 1))

    def __init__(self, embed_dim: int, base_width: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        w, prev = base_width, 3
        for i, (mult, stride) in enumerate(self._TRUNK):
            self.add_module(f"_ConvBlock_{i}",
                            _ConvBlock(prev, w * mult, stride, dtype))
            prev = w * mult
        self.emb_features = Conv(prev, embed_dim, (1, 1), dtype=dtype)
        self._ConvBlock_6 = _ConvBlock(prev, w * 16, 2, dtype)
        self._ConvBlock_7 = _ConvBlock(w * 16, w * 16, 2, dtype)
        self.emb_cnn_code = Dense(w * 16, embed_dim, bias=False, dtype=dtype)

    def forward(self, images: torch.Tensor):
        x = images.to(self.dtype)
        for i in range(len(self._TRUNK)):
            x = getattr(self, f"_ConvBlock_{i}")(x)
        reg = self.emb_features(x)  # (B, R, R, D)
        b, r1, r2, d = reg.shape
        g = self._ConvBlock_7(self._ConvBlock_6(x)).mean(dim=(1, 2))
        g = self.emb_cnn_code(g)
        return reg.reshape(b, r1 * r2, d).float(), g.float()


def build_image_encoder(cfg: Config, base_width: int = 32) -> nn.Module:
    """The DAMSM image encoder ``TEXT.CNN_BACKBONE`` names: ``lite``
    (``CNNEncoder`` at ``base_width``) or ``inception``."""
    if cfg.TEXT.CNN_BACKBONE == "inception":
        from objgan_tpu_torch.models.inception_v3 import InceptionEncoder

        return InceptionEncoder(cfg.TEXT.EMBEDDING_DIM)
    return CNNEncoder(cfg.TEXT.EMBEDDING_DIM, base_width=base_width)
