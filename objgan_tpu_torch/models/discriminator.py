"""Stage-C discriminators: the per-scale patch ``DNet``s and the object-wise
``ObjectDNet``. Port of ``objgan_tpu/models/discriminator.py``.

Submodule names mirror the JAX param tree (``down_blocks_0.Conv_0``,
``DownBlock_3.FusedGroupNorm_0``, ``cls_fc``, ...) so the param bridge maps
paths one to one. Activations are NHWC in the D compute dtype; logits come
out fp32.

``DNet``: strided 4x4 convs down to a 4x4 grid over [image ; layout
canvas], then two heads: "uncond" from the trunk alone and "cond" from the
trunk with the sentence embedding tiled over the grid. ``trunk`` and
``heads`` are separate methods so that the trainer shares one real trunk
between the matched and mismatched captions.

``ObjectDNet``: a conv trunk to 1/8 scale, ROI-align over the padded boxes
(kernels K2/K3 on the card, ``ops/roi_align.py``), a per-object head with a
real/fake logit conditioned on the label embedding and class logits from
the ROI features alone. Padded objects are masked in the loss, not here.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn

from objgan_tpu_torch.core.config import Config
from objgan_tpu_torch.core.layers import Conv, Dense
from objgan_tpu_torch.models.common import gn, lrelu
from objgan_tpu_torch.ops.roi_align import roi_align


class DownBlock(nn.Module):
    """4x4 stride-2 conv (no bias) -> GroupNorm (optional) -> LeakyReLU."""

    def __init__(self, in_features: int, features: int, norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, (4, 4), stride=2,
                           dtype=dtype)
        self.FusedGroupNorm_0 = gn(features, dtype) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        if self.FusedGroupNorm_0 is not None:
            x = self.FusedGroupNorm_0(x)
        return lrelu(x)


class _Block3x3(nn.Module):
    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, (3, 3), dtype=dtype)
        self.FusedGroupNorm_0 = gn(features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lrelu(self.FusedGroupNorm_0(self.Conv_0(x)))


class DNet(nn.Module):
    """Patch discriminator for one pyramid scale: ``log2(size) - 2``
    stride-2 convs (at least 2) to 4x4, widening up to 8 * df_dim, plus a
    3x3 block above 64 px. Input channels: 3 image + ``layout_features``
    canvas; ``sent_features`` is the sentence embedding width."""

    def __init__(self, df_dim: int, img_size: int, sent_features: int,
                 layout_features: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        df = df_dim
        n_down = max(2, (img_size - 1).bit_length() - 2)
        widths = [min(df * 2 ** i, df * 8) for i in range(n_down)]
        self.n_down = n_down
        prev = 3 + layout_features
        for i, w in enumerate(widths):
            self.add_module(f"down_blocks_{i}",
                            DownBlock(prev, w, norm=i > 0, dtype=dtype))
            prev = w
        self.extra = _Block3x3(prev, df * 8, dtype) if img_size > 64 else None
        trunk = df * 8 if img_size > 64 else prev
        self.uncond_logits = Conv(trunk, 1, (4, 4), bias=True, dtype=dtype)
        self.cond_block = _Block3x3(trunk + sent_features, df * 8, dtype)
        self.cond_logits = Conv(df * 8, 1, (4, 4), bias=True, dtype=dtype)

    def trunk(self, images: torch.Tensor,
              layout: Optional[torch.Tensor] = None) -> torch.Tensor:
        """images (B, S, S, 3) in [-1, 1], layout (B, S, S, C_l) -> the
        (B, 4, 4, <= 8 df) trunk features."""
        x = images.to(self.dtype)
        if layout is not None:
            x = torch.cat([x, layout.to(self.dtype)], dim=-1)
        for i in range(self.n_down):
            x = getattr(self, f"down_blocks_{i}")(x)
        if self.extra is not None:
            x = self.extra(x)
        return x

    def heads(self, trunk: torch.Tensor,
              sent_emb: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
        out = {"uncond": self.uncond_logits(trunk)[..., 0].float()}
        if sent_emb is not None:
            b, hh, ww, _ = trunk.shape
            s = sent_emb.to(self.dtype)[:, None, None, :].expand(
                b, hh, ww, sent_emb.shape[-1])
            h = self.cond_block(torch.cat([trunk, s], dim=-1))
            out["cond"] = self.cond_logits(h)[..., 0].float()
        return out

    def forward(self, images: torch.Tensor,
                sent_emb: Optional[torch.Tensor] = None,
                layout: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        return self.heads(self.trunk(images, layout), sent_emb)


class ObjectDNet(nn.Module):
    """Object-wise Fast R-CNN discriminator: images (B, S, S, 3), boxes
    (B, O, 4), label embeddings (B, O, L) -> {"obj": (B, O), "cls":
    (B, O, NUM_CLASSES)}, fp32."""

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.roi_size = cfg.OBJ.ROI_SIZE
        df = cfg.GAN.DF_DIM
        self.DownBlock_0 = DownBlock(3, df, norm=False, dtype=dtype)  # /2
        self.DownBlock_1 = DownBlock(df, df * 2, dtype=dtype)         # /4
        self.DownBlock_2 = DownBlock(df * 2, df * 4, dtype=dtype)     # /8
        self.DownBlock_3 = DownBlock(df * 4, df * 8, dtype=dtype)     # ROIs
        self.cls_fc = Dense(df * 8, df * 4, dtype=dtype)
        self.cls_logits = Dense(df * 4, cfg.OBJ.NUM_CLASSES, dtype=dtype)
        self.Dense_0 = Dense(df * 8 + cfg.OBJ.LABEL_DIM, df * 4, dtype=dtype)
        self.obj_logits = Dense(df * 4, 1, dtype=dtype)

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                labels_emb: torch.Tensor) -> Dict[str, torch.Tensor]:
        r = self.roi_size
        x = images.to(self.dtype)
        x = self.DownBlock_2(self.DownBlock_1(self.DownBlock_0(x)))
        rois = roi_align(x, boxes, out_size=r, sampling_ratio=2)
        b, o = rois.shape[:2]
        pooled = self.DownBlock_3(rois.reshape(b * o, r, r, rois.shape[-1]))
        pooled = pooled.mean(dim=(1, 2))  # (B*O, 8df)
        # the class head reads the ROI features only; the real/fake head is
        # conditioned on the label embedding
        cls = self.cls_logits(lrelu(self.cls_fc(pooled)))
        lab = labels_emb.to(self.dtype).reshape(b * o, -1)
        h = lrelu(self.Dense_0(torch.cat([pooled, lab], dim=-1)))
        realfake = self.obj_logits(h)
        return {"obj": realfake.reshape(b, o).float(),
                "cls": cls.reshape(b, o, -1).float()}


def build_discriminators(cfg: Config,
                         dtype: torch.dtype = torch.float32) -> List[DNet]:
    """One DNet per pyramid scale, in scale order (smallest first)."""
    return [DNet(cfg.GAN.DF_DIM, size, cfg.TEXT.EMBEDDING_DIM, dtype=dtype)
            for size in cfg.branch_sizes]
