"""Stage-C cascaded attentive image generator (G_NET) and the CA-net KL loss.

Port of ``objgan_tpu/models/generator.py``. Submodule names mirror the JAX
param tree (``init_stage.up0.conv``, ``layout_enc.FusedGroupNorm_1``, ...) so
the param bridge maps paths one to one. Activations are NHWC. Only ``GNet``
runs in ``cfg.DTYPE``; attention maps stay fp32. With ``GAN.REMAT:
stages`` the attention stages run under ``torch.utils.checkpoint`` when a
gradient is being recorded: their activations are recomputed in the
backward pass instead of stored.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from objgan_tpu_torch.core.config import Config
from objgan_tpu_torch.core.layers import Conv, Dense
from objgan_tpu_torch.models.common import glu, gn, gn_glu, lrelu
from objgan_tpu_torch.ops import attention as att_ops
from objgan_tpu_torch.ops import rasterize


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.DTYPE == "bfloat16" else torch.float32


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x resize of NHWC x (``jax.image.resize(..., "nearest")``)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    return y.permute(0, 2, 3, 1)


class UpBlock(nn.Module):
    """2x upsample -> 3x3 conv -> GroupNorm -> GLU. mode "nearest" resizes
    then convolves; "subpixel" convolves at the low resolution to 4x the
    channels, then depth-to-space."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype,
                 mode: str = "nearest"):
        super().__init__()
        self.features = features
        self.mode = mode
        out = 8 * features if mode == "subpixel" else 2 * features
        self.conv = Conv(in_features, out, (3, 3), dtype=dtype)
        self.FusedGroupNorm_0 = gn_glu(2 * features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        if self.mode == "subpixel":
            f2 = 2 * self.features
            y = self.conv(x).reshape(b, h, w, 2, 2, f2)
            x = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, f2)
        else:
            x = self.conv(upsample_nearest2x(x))
        return self.FusedGroupNorm_0(x)


class ResBlock(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv(features, 2 * features, (3, 3), dtype=dtype)
        self.FusedGroupNorm_0 = gn_glu(2 * features, dtype)
        self.conv2 = Conv(features, features, (3, 3), dtype=dtype)
        self.FusedGroupNorm_1 = gn(features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.FusedGroupNorm_0(self.conv1(x))
        h = self.FusedGroupNorm_1(self.conv2(h))
        return x + h


class CANet(nn.Module):
    """Conditioning augmentation: sent_emb -> (c_code, mu, logvar); one fc
    to 4*c_dim, GLU, halves are mu and logvar. ``eps`` (B, c_dim) fp32 is
    the reparameterisation noise."""

    def __init__(self, in_features: int, condition_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.condition_dim = condition_dim
        self.dtype = dtype
        self.fc = Dense(in_features, 4 * condition_dim, dtype=dtype)

    def forward(self, sent_emb: torch.Tensor, eps: torch.Tensor):
        x = glu(self.fc(sent_emb)).float()
        mu = x[..., :self.condition_dim]
        logvar = x[..., self.condition_dim:]
        c_code = mu + torch.exp(0.5 * logvar) * eps
        return c_code.to(self.dtype), mu, logvar


class LayoutEncoder(nn.Module):
    """Layout canvas (B, S, S, C_l) -> features (B, out_hw, out_hw, F) by
    strided 4x4 convs, then a 3x3 conv."""

    def __init__(self, in_features: int, features: int, in_hw: int,
                 out_hw: int, dtype: torch.dtype):
        super().__init__()
        ch, prev, size, i = features // 4, in_features, in_hw, 0
        while size > out_hw:
            ch = min(2 * ch, features)
            self.add_module(f"Conv_{i}", Conv(prev, ch, (4, 4), stride=2,
                                              dtype=dtype))
            self.add_module(f"FusedGroupNorm_{i}", gn(ch, dtype))
            prev, size, i = ch, -(-size // 2), i + 1
        self.add_module(f"Conv_{i}", Conv(prev, features, (3, 3),
                                          dtype=dtype))
        self.add_module(f"FusedGroupNorm_{i}", gn(features, dtype))
        self.n_layers = i + 1

    def forward(self, canvas: torch.Tensor) -> torch.Tensor:
        x = canvas
        for i in range(self.n_layers):
            x = getattr(self, f"Conv_{i}")(x)
            x = lrelu(getattr(self, f"FusedGroupNorm_{i}")(x))
        return x


class FlatGroupNorm(nn.Module):
    """Linen ``nn.GroupNorm(num_groups)`` on a flat (B, F) input: groups of
    consecutive features, fp32 statistics, Linen's
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` order."""

    def __init__(self, features: int, num_groups: int, dtype: torch.dtype,
                 eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f = x.shape
        g = self.num_groups
        xg = x.float().reshape(b, g, f // g)
        mean = xg.mean(dim=-1, keepdim=True)
        mean2 = (xg * xg).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(g, f // g)
        y = (xg - mean) * mul + self.bias.reshape(g, f // g)
        return y.reshape(b, f).to(self.dtype)


class InitStageG(nn.Module):
    """[z ; c_code] -> 4x4 seed (fc, GroupNorm(32) on the flat NHWC-ordered
    output, GLU) fused with the layout features -> up-blocks to base_size."""

    def __init__(self, in_features: int, gf_dim: int, layout_features: int,
                 base_size: int, dtype: torch.dtype, up_mode: str):
        super().__init__()
        self.n_up = max(1, (base_size // 4).bit_length() - 1)
        self.ngf = gf_dim * 2 ** self.n_up
        self.fc = Dense(in_features, 4 * 4 * self.ngf * 2, bias=False,
                        dtype=dtype)
        self.GroupNorm_0 = FlatGroupNorm(4 * 4 * self.ngf * 2, 32, dtype)
        prev = self.ngf + layout_features
        for i in range(self.n_up):
            f = gf_dim * 2 ** (self.n_up - 1 - i)
            self.add_module(f"up{i}", UpBlock(prev, f, dtype, up_mode))
            prev = f

    def forward(self, z_c: torch.Tensor,
                layout_feats: torch.Tensor) -> torch.Tensor:
        b = z_c.shape[0]
        x = self.GroupNorm_0(self.fc(z_c))
        x = glu(x).reshape(b, 4, 4, self.ngf)
        x = torch.cat([x, layout_feats], dim=-1)
        for i in range(self.n_up):
            x = getattr(self, f"up{i}")(x)
        return x


class AttnStage(nn.Module):
    """Grid + object-driven attention feeding residual refinement and a 2x
    up-block."""

    def __init__(self, gf_dim: int, r_num: int, word_features: int,
                 query_features: int, dtype: torch.dtype, up_mode: str,
                 ctx_dtype: Optional[torch.dtype]):
        super().__init__()
        c = gf_dim
        self.ctx_dtype = ctx_dtype
        self.r_num = r_num
        self.word_proj = Dense(word_features, c, bias=False, dtype=dtype)
        self.obj_query_proj = Dense(query_features, c, bias=False,
                                    dtype=dtype)
        for i in range(r_num):
            self.add_module(f"res{i}", ResBlock(3 * c, dtype))
        self.up = UpBlock(3 * c, gf_dim, dtype, up_mode)

    def forward(self, h, word_embs, word_mask, obj_query, obj_maps,
                obj_valid):
        b, hh, ww, c = h.shape
        t = word_embs.shape[1]
        words_p = self.word_proj(word_embs)
        grid_ctx, grid_attn = att_ops.grid_attention(
            h.reshape(b, hh * ww, c), words_p, word_mask,
            context_dtype=self.ctx_dtype)
        obj_q = self.obj_query_proj(obj_query)
        obj_ctx, obj_attn = att_ops.object_attention(obj_q, words_p,
                                                     word_mask, obj_valid)
        pasted = att_ops.paste_object_context(
            obj_ctx, obj_maps.reshape(*obj_maps.shape[:2], hh * ww),
            obj_valid, context_dtype=self.ctx_dtype)
        x = torch.cat([h, grid_ctx.reshape(b, hh, ww, c),
                       pasted.reshape(b, hh, ww, c)], dim=-1)
        for i in range(self.r_num):
            x = getattr(self, f"res{i}")(x)
        x = self.up(x)
        return x, grid_attn.reshape(b, hh, ww, t), obj_attn


class GetImageG(nn.Module):
    def __init__(self, in_features: int, dtype: torch.dtype):
        super().__init__()
        self.img = Conv(in_features, 3, (3, 3), dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.img(h).float())


class GNet(nn.Module):
    """Full cascaded generator. Inputs (objects padded to MAX_OBJECTS):
    z (B, Z), sent_emb (B, D), word_embs (B, T, D), word_mask (B, T) bool,
    labels_emb (B, O, L), boxes (B, O, 4), shapes (B, O, S, S),
    obj_valid (B, O), ca_eps (B, CONDITION_DIM)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype(cfg)
        self.dtype = dt
        gf = cfg.GAN.GF_DIM
        base = cfg.TREE.BASE_SIZE
        self.ctx_dtype = dt if cfg.GAN.OBJ_PASTE_DTYPE == "compute" else None
        self.remat = cfg.GAN.REMAT == "stages"
        self.ca_net = CANet(cfg.TEXT.EMBEDDING_DIM, cfg.GAN.CONDITION_DIM, dt)
        self.layout_enc = LayoutEncoder(cfg.OBJ.LABEL_DIM, gf * 8, base, 4, dt)
        self.init_stage = InitStageG(cfg.GAN.Z_DIM + cfg.GAN.CONDITION_DIM,
                                     gf, gf * 8, base, dt, cfg.GAN.UP_MODE)
        self.add_module(f"img{base}", GetImageG(gf, dt))
        res = base
        for i in range(1, cfg.TREE.BRANCH_NUM):
            self.add_module(f"attn_stage{i}", AttnStage(
                gf, cfg.GAN.R_NUM, cfg.TEXT.EMBEDDING_DIM,
                cfg.OBJ.LABEL_DIM + 4, dt, cfg.GAN.UP_MODE, self.ctx_dtype))
            res *= 2
            self.add_module(f"img{res}", GetImageG(gf, dt))

    def forward(self, z, sent_emb, word_embs, word_mask, labels_emb, boxes,
                shapes, obj_valid, ca_eps) -> Dict[str, object]:
        cfg = self.cfg
        dt = self.dtype
        base = cfg.TREE.BASE_SIZE
        c_code, mu, logvar = self.ca_net(sent_emb.to(dt), ca_eps)
        z_c = torch.cat([z.to(dt), c_code], dim=-1)

        # layout canvas at the base resolution: label embeddings painted
        # into each object's shape, averaged over overlaps
        shape_maps = rasterize.paste_masks(shapes, boxes, base, base)
        b, o = shape_maps.shape[:2]
        canvas = att_ops.paste_object_context(
            labels_emb.to(dt),
            shape_maps.reshape(b, o, base * base).to(dt),
            obj_valid, context_dtype=self.ctx_dtype,
        ).reshape(-1, base, base, labels_emb.shape[-1])
        h = self.init_stage(z_c, self.layout_enc(canvas))

        obj_query = torch.cat([labels_emb.to(dt), boxes.to(dt)], dim=-1)
        word_embs = word_embs.to(dt)
        imgs = [getattr(self, f"img{base}")(h)]
        grid_attns, obj_attns = [], []
        res = base
        for i in range(1, cfg.TREE.BRANCH_NUM):
            if res == base:
                maps_i = shape_maps
            else:
                # bilinear resize of the base-resolution pastes
                # (jax.image.resize "bilinear": half-pixel centres)
                maps_i = F.interpolate(
                    shape_maps.reshape(b * o, 1, base, base), size=(res, res),
                    mode="bilinear", align_corners=False,
                ).reshape(b, o, res, res)
            stage = getattr(self, f"attn_stage{i}")
            args = (h, word_embs, word_mask, obj_query, maps_i, obj_valid)
            if self.remat and torch.is_grad_enabled():
                h, g_attn, o_attn = checkpoint(stage, *args,
                                               use_reentrant=False)
            else:
                h, g_attn, o_attn = stage(*args)
            res *= 2
            imgs.append(getattr(self, f"img{res}")(h))
            grid_attns.append(g_attn)
            obj_attns.append(o_attn)
        return {
            "images": imgs,          # list of (B, s, s, 3) fp32 in [-1, 1]
            "grid_attn": grid_attns,  # list of (B, h, w, T) fp32
            "obj_attn": obj_attns,    # list of (B, O, T) fp32
            "mu": mu,
            "logvar": logvar,
        }


def kl_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """CA-net KL(N(mu, sigma) || N(0, I)), averaged over all elements (the
    lineage's ``torch.mean(KLD_element)``)."""
    return -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))
