"""Stage B, shape generator and discriminator: box layout -> per-object
mask logits, and real/fake on (mask, box raster, label).

Port of ``objgan_tpu/models/shape_generator.py``. ``ShapeGenerator`` is a
U-Net over (box raster, label, noise) in each object's own (S, S) frame,
objects folded into the batch for the convs, with a bi-directional
conv-LSTM over the object sequence at the bottleneck.
``ShapeDiscriminator`` is three strided convs, the last two GroupNormed,
and a 4x4 logit conv averaged per object; it returns its trunk features
for feature matching. fp32 (the modules' default dtype in the JAX package;
``cfg.DTYPE`` does not apply here). On the card every GroupNorm runs
kernel K1.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from objgan_tpu_torch.core.config import Config
from objgan_tpu_torch.core.layers import Conv, Dense
from objgan_tpu_torch.models.common import gn, lrelu
from objgan_tpu_torch.models.generator import upsample_nearest2x
from objgan_tpu_torch.ops.lstm import BiConvLSTM
from objgan_tpu_torch.ops.rasterize import box_maps


class _Down(nn.Module):
    def __init__(self, in_features: int, features: int, norm: bool = True):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, (4, 4), stride=2)
        self.FusedGroupNorm_0 = gn(features) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        if self.FusedGroupNorm_0 is not None:
            x = self.FusedGroupNorm_0(x)
        return lrelu(x)


class _Up(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, (3, 3))
        self.FusedGroupNorm_0 = gn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(upsample_nearest2x(x))
        return torch.relu(self.FusedGroupNorm_0(x))


class ShapeGenerator(nn.Module):
    """Returns per-object mask logits (B, O, S, S); sigmoid gives masks."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        gf = cfg.SHAPE.GF_DIM
        hid = cfg.SHAPE.HIDDEN_DIM
        self.label_proj = Dense(cfg.OBJ.LABEL_DIM, gf)
        self._Down_0 = _Down(1 + 2 * gf, gf, norm=False)
        self._Down_1 = _Down(gf, gf * 2)
        self._Down_2 = _Down(gf * 2, gf * 4)
        self.bi_clstm = BiConvLSTM(gf * 4, hid)
        self._Up_0 = _Up(2 * hid + gf * 4, gf * 2)
        self._Up_1 = _Up(gf * 2 + gf * 2, gf)
        self._Up_2 = _Up(gf + gf, gf)
        self.mask_head = Conv(gf, 1, (3, 3), bias=True)

    def forward(self, boxes: torch.Tensor, labels_emb: torch.Tensor,
                obj_valid: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """boxes (B, O, 4), labels_emb (B, O, L), obj_valid (B, O) and the
        noise z (B, O, 1, 1, GF_DIM) fp32."""
        s = self.cfg.OBJ.SHAPE_SIZE
        gf = self.cfg.SHAPE.GF_DIM
        b, o = boxes.shape[:2]
        canvas = box_maps(boxes.float(), s, s)  # (B, O, S, S)
        lab = self.label_proj(labels_emb.float())  # (B, O, gf)
        x = torch.cat([
            canvas[..., None],
            lab[:, :, None, None, :].expand(b, o, s, s, gf),
            z.float().expand(b, o, s, s, gf),
        ], dim=-1).reshape(b * o, s, s, 1 + 2 * gf)
        e1 = self._Down_0(x)   # S/2
        e2 = self._Down_1(e1)  # S/4
        e3 = self._Down_2(e2)  # S/8
        h = self.bi_clstm(e3.reshape(b, o, *e3.shape[1:]), obj_valid)
        h = h.reshape(b * o, *h.shape[2:])
        d3 = self._Up_0(torch.cat([h, e3], dim=-1))
        d2 = self._Up_1(torch.cat([d3, e2], dim=-1))
        d1 = self._Up_2(torch.cat([d2, e1], dim=-1))
        return self.mask_head(d1).reshape(b, o, s, s).float()


class ShapeDiscriminator(nn.Module):
    """Returns (logits (B, O), [the three trunk features (B, O, -1)])."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        df = cfg.SHAPE.DF_DIM
        self.label_proj = Dense(cfg.OBJ.LABEL_DIM, df // 2)
        self._Down_0 = _Down(2 + df // 2, df, norm=False)
        self._Down_1 = _Down(df, df * 2)
        self._Down_2 = _Down(df * 2, df * 4)
        self.logits = Conv(df * 4, 1, (4, 4), bias=True)

    def forward(self, masks: torch.Tensor, boxes: torch.Tensor,
                labels_emb: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """masks (B, O, S, S) in [0, 1], boxes (B, O, 4), labels_emb
        (B, O, L)."""
        s = self.cfg.OBJ.SHAPE_SIZE
        half = self.cfg.SHAPE.DF_DIM // 2
        b, o = masks.shape[:2]
        canvas = box_maps(boxes.float(), s, s)
        lab = self.label_proj(labels_emb.float())
        x = torch.cat([
            masks.float()[..., None], canvas[..., None],
            lab[:, :, None, None, :].expand(b, o, s, s, half),
        ], dim=-1).reshape(b * o, s, s, 2 + half)
        feats = []
        for down in (self._Down_0, self._Down_1, self._Down_2):
            x = down(x)
            feats.append(x)
        logits = self.logits(x).reshape(b, o, -1).mean(-1).float()
        return logits, [f.reshape(b, o, -1) for f in feats]
