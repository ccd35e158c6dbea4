"""Plain PyTorch reference of one Stage-C adversarial train step.

A frozen, self-contained copy of Obj-GAN's Stage C as the port trains it:
the cascaded attentive generator (CA-net, layout encoder, init stage, two
attention stages, image heads), the three patch discriminators, the
object-wise discriminator over ROI-align, the frozen DAMSM text (bi-LSTM)
and image (InceptionLite) encoders, the GAN, object and DAMSM losses, and
Adam (b1 0.5, b2 0.999, eps 1e-8). Parameter names are the port's, so one
state dict loads into both.

It imports nothing of the program. GroupNorm and ROI-align are the plain
formulas (no kernels), everything computes in float32 with TF32 off, and
autograd differentiates it. ``Numerics(control=...)`` is the control, a
precision below the configuration's: every convolution and dense layer
that the configuration runs in bfloat16 multiplies operands rounded to
float8 e4m3 ("fp8") or int8 ("int8") and stores its output so rounded, as
the program stores bfloat16, and takes the gradient of its output rounded
to float8 e5m2 or int8 in the backward pass, each at a per-tensor scale,
accumulating in float32; a GroupNorm that the configuration runs in
bfloat16 stores its output likewise.

``Numerics.gn_calls`` records, while a list is set, each GroupNorm forward
as (elements, bytes per element as configured, channels, GLU): the launches
of kernel K1 in the program's step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

NEG_INF = -1e9
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` at a per-tensor scale that
    puts its largest magnitude at ``top``."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


def _int8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to int8 at a per-tensor scale (its largest magnitude
    at 127)."""
    scale = x.abs().amax().clamp(min=1e-30) / 127.0
    return torch.round(x / scale).clamp(-127, 127) * scale


# the control's rounding of a layer's operands (forward) and of the
# gradient of its output (backward)
ROUNDINGS = {
    "fp8": (lambda x: _fp8(x, torch.float8_e4m3fn, E4M3_MAX),
            lambda g: _fp8(g, torch.float8_e5m2, E5M2_MAX)),
    "int8": (_int8, _int8),
}


class _GradRound(torch.autograd.Function):
    """Identity forward; the gradient that flows back rounded by ``fn``."""

    @staticmethod
    def forward(ctx, y, fn):
        ctx.fn = fn
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


@dataclass
class Numerics:
    """float32 everywhere, or with ``control`` ("fp8" or "int8") the
    layers that the configuration runs in bfloat16 computed in that lower
    precision."""
    control: Optional[str] = None
    gn_calls: Optional[List[tuple]] = None

    def operand(self, x: torch.Tensor, low: bool) -> torch.Tensor:
        """``x`` in float32, or for the control rounded at a per-tensor
        scale (the gradient passes the rounding unchanged)."""
        x = x.float()
        if not (self.control and low):
            return x
        with torch.no_grad():
            q = ROUNDINGS[self.control][0](x)
        return x + (q - x).detach()

    def output(self, y: torch.Tensor, low: bool) -> torch.Tensor:
        """A layer's output; for the control, stored rounded (where the
        program stores it in bfloat16), and its gradient rounded before the
        layer's backward products use it."""
        if not (self.control and low):
            return y
        fwd, bwd = ROUNDINGS[self.control]
        with torch.no_grad():
            q = fwd(y)
        return _GradRound.apply(y + (q - y).detach(), bwd)


def no_tf32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# -- layers ------------------------------------------------------------------


class Dense(nn.Module):
    def __init__(self, num: Numerics, fin: int, fout: int, bias: bool = True,
                 low: bool = False):
        super().__init__()
        self.num, self.low = num, low
        self.weight = nn.Parameter(torch.empty(fout, fin))
        self.bias = nn.Parameter(torch.zeros(fout)) if bias else None

    def forward(self, x):
        return self.num.output(F.linear(
            self.num.operand(x, self.low),
            self.num.operand(self.weight, self.low), self.bias), self.low)


def _same(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """NHWC convolution, padding "SAME" as Linen pads it."""

    def __init__(self, num: Numerics, fin: int, fout: int, k: int,
                 stride: int = 1, bias: bool = False, low: bool = False):
        super().__init__()
        self.num, self.low, self.stride = num, low, stride
        self.weight = nn.Parameter(torch.empty(fout, fin, k, k))
        self.bias = nn.Parameter(torch.zeros(fout)) if bias else None

    def forward(self, x):
        _, h, w, _ = x.shape
        k = self.weight.shape[-1]
        ph, pw = _same(h, k, self.stride), _same(w, k, self.stride)
        xc = F.pad(self.num.operand(x, self.low).permute(0, 3, 1, 2),
                   (pw[0], pw[1], ph[0], ph[1]))
        y = F.conv2d(xc, self.num.operand(self.weight, self.low), self.bias,
                     stride=self.stride)
        return self.num.output(y, self.low).permute(0, 2, 3, 1)


class Embed(nn.Module):
    def __init__(self, n: int, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, d))

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class GroupNorm(nn.Module):
    """GroupNorm over the channel (last) axis with gcd(C, 32) groups, fp32
    statistics E[x^2] - E[x]^2 clamped at 0, eps 1e-6; optional GLU."""

    def __init__(self, num: Numerics, c: int, glu: bool = False,
                 low: bool = False):
        super().__init__()
        self.num, self.glu, self.low = num, glu, low
        self.groups = math.gcd(c, 32)
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        shape, c = x.shape, x.shape[-1]
        if self.num.gn_calls is not None:
            self.num.gn_calls.append((x.numel(), 2 if self.low else 4, c,
                                      self.glu))
        xf = x.float().reshape(shape[0], -1, self.groups, c // self.groups)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=(1, 3), keepdim=True)
                          - mean * mean, min=0.0)
        y = ((xf - mean) * torch.rsqrt(var + 1e-6)).reshape(shape)
        y = self.num.output(y * self.weight + self.bias, self.low)
        return glu(y) if self.glu else y


def glu(x):
    a, b = x.chunk(2, dim=-1)
    return a * torch.sigmoid(b)


def lrelu(x):
    return F.leaky_relu(x, 0.2)


# -- layout and attention ----------------------------------------------------


def _centres(n: int, device):
    return (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n


def _interp(out_n: int, src_n: int, origin, extent):
    src = (_centres(out_n, origin.device) - origin[..., None]) / torch.clamp(
        extent[..., None], min=1e-6) * src_n - 0.5
    s = torch.arange(src_n, dtype=torch.float32, device=origin.device)
    w = torch.clamp(1.0 - (src[..., None] - s).abs(), min=0.0)
    return w * ((src >= -0.5) & (src <= src_n - 0.5)).float()[..., None]


def paste_masks(masks, boxes, size: int):
    """(B, O, S, S) masks into their boxes on a (size, size) canvas."""
    s = masks.shape[-1]
    x0, y0, w, h = boxes.float().unbind(-1)
    return (_interp(size, s, y0, h) @ masks.float()
            @ _interp(size, s, x0, w).transpose(-1, -2))


def masked_softmax(scores, mask):
    return torch.softmax(scores.masked_fill(mask, NEG_INF), dim=-1)


def paste_context(ctx, maps, valid):
    maps = maps.float() * valid.float()[..., None]
    out = torch.bmm(maps.transpose(1, 2), ctx.float())
    return out / torch.clamp(maps.sum(dim=1), min=1.0)[..., None]


def roi_matrix(out_n: int, src_n: int, origin, extent, q: int = 2):
    """ROI-align's interpolate-and-average matrix (..., out_n, src_n): bin r
    averages q bilinear samples; samples outside [-1, n] weigh nothing."""
    fine = out_n * q
    i = torch.arange(fine, dtype=torch.float32, device=origin.device)[:, None]
    s = torch.arange(src_n, dtype=torch.float32, device=origin.device)[None]
    src = (origin.float()[..., None, None] * src_n
           + (i + 0.5) * extent.float()[..., None, None] * src_n / fine - 0.5)
    inside = ((src >= -1.0) & (src <= src_n)).float()
    w = torch.clamp(1.0 - (torch.clamp(src, 0.0, src_n - 1.0) - s).abs(),
                    min=0.0) * inside
    return w.reshape(*w.shape[:-2], out_n, q, src_n).mean(dim=-2)


def roi_align(feats, boxes, r: int):
    """feats (B, H, W, C), boxes (B, O, 4) -> (B, O, r, r, C)."""
    _, h, w, _ = feats.shape
    b = boxes.detach()
    a_y = roi_matrix(r, h, b[..., 1], b[..., 3])
    a_x = roi_matrix(r, w, b[..., 0], b[..., 2])
    t = torch.einsum("boih,bhwc->boiwc", a_y, feats.float())
    return torch.einsum("bojw,boiwc->boijc", a_x, t)


# -- the networks ------------------------------------------------------------


def up2(x):
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                         mode="nearest").permute(0, 2, 3, 1)


class UpBlock(nn.Module):
    def __init__(self, num, fin, f):
        super().__init__()
        self.conv = Conv(num, fin, 2 * f, 3, low=True)
        self.FusedGroupNorm_0 = GroupNorm(num, 2 * f, glu=True, low=True)

    def forward(self, x):
        return self.FusedGroupNorm_0(self.conv(up2(x)))


class ResBlock(nn.Module):
    def __init__(self, num, f):
        super().__init__()
        self.conv1 = Conv(num, f, 2 * f, 3, low=True)
        self.FusedGroupNorm_0 = GroupNorm(num, 2 * f, glu=True, low=True)
        self.conv2 = Conv(num, f, f, 3, low=True)
        self.FusedGroupNorm_1 = GroupNorm(num, f, low=True)

    def forward(self, x):
        h = self.FusedGroupNorm_0(self.conv1(x))
        return x + self.FusedGroupNorm_1(self.conv2(h))


class CANet(nn.Module):
    def __init__(self, num, fin, cdim):
        super().__init__()
        self.cdim = cdim
        self.fc = Dense(num, fin, 4 * cdim, low=True)

    def forward(self, sent, eps):
        x = glu(self.fc(sent))
        mu, logvar = x[..., :self.cdim], x[..., self.cdim:]
        return mu + torch.exp(0.5 * logvar) * eps, mu, logvar


class LayoutEncoder(nn.Module):
    def __init__(self, num, fin, f, in_hw, out_hw):
        super().__init__()
        ch, prev, size, i = f // 4, fin, in_hw, 0
        while size > out_hw:
            ch = min(2 * ch, f)
            self.add_module(f"Conv_{i}", Conv(num, prev, ch, 4, 2, low=True))
            self.add_module(f"FusedGroupNorm_{i}",
                            GroupNorm(num, ch, low=True))
            prev, size, i = ch, -(-size // 2), i + 1
        self.add_module(f"Conv_{i}", Conv(num, prev, f, 3, low=True))
        self.add_module(f"FusedGroupNorm_{i}", GroupNorm(num, f, low=True))
        self.n = i + 1

    def forward(self, x):
        for i in range(self.n):
            x = lrelu(getattr(self, f"FusedGroupNorm_{i}")(
                getattr(self, f"Conv_{i}")(x)))
        return x


class FlatGroupNorm(nn.Module):
    def __init__(self, f, groups):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(f))
        self.bias = nn.Parameter(torch.zeros(f))

    def forward(self, x):
        b, f = x.shape
        g = self.groups
        xg = x.float().reshape(b, g, f // g)
        mean = xg.mean(-1, keepdim=True)
        var = torch.clamp((xg * xg).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = ((xg - mean) * (torch.rsqrt(var + 1e-6)
                            * self.weight.reshape(g, f // g))
             + self.bias.reshape(g, f // g))
        return y.reshape(b, f)


class InitStageG(nn.Module):
    def __init__(self, num, fin, gf, layout_f, base):
        super().__init__()
        self.n_up = max(1, (base // 4).bit_length() - 1)
        self.ngf = gf * 2 ** self.n_up
        self.fc = Dense(num, fin, 32 * self.ngf, bias=False, low=True)
        self.GroupNorm_0 = FlatGroupNorm(32 * self.ngf, 32)
        prev = self.ngf + layout_f
        for i in range(self.n_up):
            f = gf * 2 ** (self.n_up - 1 - i)
            self.add_module(f"up{i}", UpBlock(num, prev, f))
            prev = f

    def forward(self, z_c, layout):
        x = glu(self.GroupNorm_0(self.fc(z_c))).reshape(-1, 4, 4, self.ngf)
        x = torch.cat([x, layout], dim=-1)
        for i in range(self.n_up):
            x = getattr(self, f"up{i}")(x)
        return x


class AttnStage(nn.Module):
    def __init__(self, num, gf, r_num, word_f, query_f):
        super().__init__()
        self.r_num = r_num
        self.word_proj = Dense(num, word_f, gf, bias=False, low=True)
        self.obj_query_proj = Dense(num, query_f, gf, bias=False, low=True)
        for i in range(r_num):
            self.add_module(f"res{i}", ResBlock(num, 3 * gf))
        self.up = UpBlock(num, 3 * gf, gf)

    def forward(self, h, words, word_mask, obj_query, obj_maps, valid):
        b, hh, ww, c = h.shape
        wp = self.word_proj(words)
        grid = masked_softmax(torch.bmm(h.reshape(b, hh * ww, c),
                                        wp.transpose(1, 2)),
                              word_mask[:, None, :])
        grid_ctx = torch.bmm(grid, wp)
        q = self.obj_query_proj(obj_query)
        oatt = masked_softmax(torch.bmm(q, wp.transpose(1, 2)),
                              word_mask[:, None, :]) * valid[..., None]
        pasted = paste_context(torch.bmm(oatt, wp),
                               obj_maps.reshape(b, -1, hh * ww), valid)
        x = torch.cat([h, grid_ctx.reshape(b, hh, ww, c),
                       pasted.reshape(b, hh, ww, c)], dim=-1)
        for i in range(self.r_num):
            x = getattr(self, f"res{i}")(x)
        return self.up(x)


class GetImage(nn.Module):
    def __init__(self, num, fin):
        super().__init__()
        self.img = Conv(num, fin, 3, 3, low=True)

    def forward(self, h):
        return torch.tanh(self.img(h))


class GNet(nn.Module):
    def __init__(self, num, c):
        super().__init__()
        self.c = c
        gf, base = c["GF_DIM"], c["BASE_SIZE"]
        self.ca_net = CANet(num, c["EMBEDDING_DIM"], c["CONDITION_DIM"])
        self.layout_enc = LayoutEncoder(num, c["LABEL_DIM"], gf * 8, base, 4)
        self.init_stage = InitStageG(num, c["Z_DIM"] + c["CONDITION_DIM"],
                                     gf, gf * 8, base)
        self.add_module(f"img{base}", GetImage(num, gf))
        res = base
        for i in range(1, c["BRANCH_NUM"]):
            self.add_module(f"attn_stage{i}", AttnStage(
                num, gf, c["R_NUM"], c["EMBEDDING_DIM"], c["LABEL_DIM"] + 4))
            res *= 2
            self.add_module(f"img{res}", GetImage(num, gf))

    def forward(self, z, sent, words, word_mask, labels_emb, boxes, shapes,
                valid, ca_eps):
        base = self.c["BASE_SIZE"]
        c_code, mu, logvar = self.ca_net(sent, ca_eps)
        z_c = torch.cat([z, c_code], dim=-1)
        maps = paste_masks(shapes, boxes, base)
        b, o = maps.shape[:2]
        canvas = paste_context(labels_emb, maps.reshape(b, o, base * base),
                               valid).reshape(b, base, base, -1)
        h = self.init_stage(z_c, self.layout_enc(canvas))
        query = torch.cat([labels_emb, boxes], dim=-1)
        imgs = [getattr(self, f"img{base}")(h)]
        res = base
        for i in range(1, self.c["BRANCH_NUM"]):
            maps_i = maps if res == base else F.interpolate(
                maps.reshape(b * o, 1, base, base), size=(res, res),
                mode="bilinear", align_corners=False).reshape(b, o, res, res)
            h = getattr(self, f"attn_stage{i}")(h, words, word_mask, query,
                                                maps_i, valid)
            res *= 2
            imgs.append(getattr(self, f"img{res}")(h))
        return imgs, mu, logvar


class DownBlock(nn.Module):
    def __init__(self, num, fin, f, norm=True):
        super().__init__()
        self.Conv_0 = Conv(num, fin, f, 4, 2, low=True)
        self.FusedGroupNorm_0 = GroupNorm(num, f, low=True) if norm else None

    def forward(self, x):
        x = self.Conv_0(x)
        if self.FusedGroupNorm_0 is not None:
            x = self.FusedGroupNorm_0(x)
        return lrelu(x)


class Block3(nn.Module):
    def __init__(self, num, fin, f, low=True):
        super().__init__()
        self.Conv_0 = Conv(num, fin, f, 3, low=low)
        self.FusedGroupNorm_0 = GroupNorm(num, f, low=low)

    def forward(self, x):
        return lrelu(self.FusedGroupNorm_0(self.Conv_0(x)))


class DNet(nn.Module):
    def __init__(self, num, df, size, sent_f):
        super().__init__()
        self.n_down = max(2, (size - 1).bit_length() - 2)
        widths = [min(df * 2 ** i, df * 8) for i in range(self.n_down)]
        prev = 4
        for i, w in enumerate(widths):
            self.add_module(f"down_blocks_{i}",
                            DownBlock(num, prev, w, norm=i > 0))
            prev = w
        self.extra = Block3(num, prev, df * 8) if size > 64 else None
        trunk = df * 8 if size > 64 else prev
        self.uncond_logits = Conv(num, trunk, 1, 4, bias=True, low=True)
        self.cond_block = Block3(num, trunk + sent_f, df * 8)
        self.cond_logits = Conv(num, df * 8, 1, 4, bias=True, low=True)

    def trunk(self, images, layout):
        x = torch.cat([images, layout], dim=-1)
        for i in range(self.n_down):
            x = getattr(self, f"down_blocks_{i}")(x)
        return self.extra(x) if self.extra is not None else x

    def heads(self, trunk, sent):
        b, hh, ww, _ = trunk.shape
        s = sent[:, None, None, :].expand(b, hh, ww, sent.shape[-1])
        h = self.cond_block(torch.cat([trunk, s], dim=-1))
        return {"uncond": self.uncond_logits(trunk)[..., 0],
                "cond": self.cond_logits(h)[..., 0]}

    def forward(self, images, sent, layout):
        return self.heads(self.trunk(images, layout), sent)


class ObjectDNet(nn.Module):
    def __init__(self, num, c):
        super().__init__()
        df = c["DF_DIM"]
        self.r = c["ROI_SIZE"]
        self.DownBlock_0 = DownBlock(num, 3, df, norm=False)
        self.DownBlock_1 = DownBlock(num, df, df * 2)
        self.DownBlock_2 = DownBlock(num, df * 2, df * 4)
        self.DownBlock_3 = DownBlock(num, df * 4, df * 8)
        self.cls_fc = Dense(num, df * 8, df * 4, low=True)
        self.cls_logits = Dense(num, df * 4, c["NUM_CLASSES"], low=True)
        self.Dense_0 = Dense(num, df * 8 + c["LABEL_DIM"], df * 4, low=True)
        self.obj_logits = Dense(num, df * 4, 1, low=True)

    def forward(self, images, boxes, labels_emb):
        x = self.DownBlock_2(self.DownBlock_1(self.DownBlock_0(images)))
        rois = roi_align(x, boxes, self.r)
        b, o = rois.shape[:2]
        pooled = self.DownBlock_3(rois.reshape(b * o, self.r, self.r, -1))
        pooled = pooled.mean(dim=(1, 2))
        cls = self.cls_logits(lrelu(self.cls_fc(pooled)))
        h = lrelu(self.Dense_0(torch.cat([pooled,
                                          labels_emb.reshape(b * o, -1)], -1)))
        return {"obj": self.obj_logits(h).reshape(b, o),
                "cls": cls.reshape(b, o, -1)}


class BiLSTM(nn.Module):
    """pack_padded bi-LSTM, gate order i|f|g|o; the backward direction
    scans the time-reversed sequence, padding first."""

    def __init__(self, fin, h):
        super().__init__()
        self.h = h
        for d in ("fwd", "bwd"):
            self.register_parameter(f"{d}_w_ih",
                                    nn.Parameter(torch.empty(fin, 4 * h)))
            self.register_parameter(f"{d}_w_hh",
                                    nn.Parameter(torch.empty(h, 4 * h)))
            self.register_parameter(f"{d}_b", nn.Parameter(torch.zeros(4 * h)))

    def _run(self, x, valid, w_ih, w_hh, b):
        n, t, _ = x.shape
        h = c = x.new_zeros(n, self.h)
        ys = []
        for s in range(t):
            i, f, g, o = (x[:, s] @ w_ih + b + h @ w_hh).chunk(4, dim=-1)
            nc = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            nh = torch.sigmoid(o) * torch.tanh(nc)
            v = valid[:, s, None]
            h, c = nh * v + h * (1 - v), nc * v + c * (1 - v)
            ys.append(nh * v)
        return torch.stack(ys, 1), h

    def forward(self, x, lens):
        t = x.shape[1]
        valid = (torch.arange(t, device=x.device)[None]
                 < lens[:, None]).float()
        yf, hf = self._run(x, valid, self.fwd_w_ih, self.fwd_w_hh, self.fwd_b)
        yb, hb = self._run(x.flip(1), valid.flip(1), self.bwd_w_ih,
                           self.bwd_w_hh, self.bwd_b)
        return torch.cat([yf, yb.flip(1)], dim=-1), torch.cat([hf, hb], -1)


class RNNEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.embedding = Embed(c["VOCAB_SIZE"], c["GLOVE_DIM"])
        self.bilstm = BiLSTM(c["GLOVE_DIM"], c["HIDDEN_DIM"])

    def forward(self, caps, lens):
        return self.bilstm(self.embedding(caps), lens)


class ConvBlock(nn.Module):
    def __init__(self, num, fin, f, stride):
        super().__init__()
        self.Conv_0 = Conv(num, fin, f, 3, stride)
        self.FusedGroupNorm_0 = GroupNorm(num, f)

    def forward(self, x):
        return torch.relu(self.FusedGroupNorm_0(self.Conv_0(x)))


class CNNEncoder(nn.Module):
    """InceptionLite at base width 32, fp32 as configured."""

    TRUNK = ((1, 2), (2, 2), (4, 2), (4, 1), (8, 2), (8, 1))

    def __init__(self, num, embed, w=32):
        super().__init__()
        prev = 3
        for i, (mult, stride) in enumerate(self.TRUNK):
            self.add_module(f"_ConvBlock_{i}",
                            ConvBlock(num, prev, w * mult, stride))
            prev = w * mult
        self.emb_features = Conv(num, prev, embed, 1)
        self._ConvBlock_6 = ConvBlock(num, prev, w * 16, 2)
        self._ConvBlock_7 = ConvBlock(num, w * 16, w * 16, 2)
        self.emb_cnn_code = Dense(num, w * 16, embed, bias=False)

    def forward(self, x):
        for i in range(len(self.TRUNK)):
            x = getattr(self, f"_ConvBlock_{i}")(x)
        reg = self.emb_features(x)
        b, r1, r2, d = reg.shape
        g = self._ConvBlock_7(self._ConvBlock_6(x)).mean(dim=(1, 2))
        return reg.reshape(b, r1 * r2, d), self.emb_cnn_code(g)


# -- losses ------------------------------------------------------------------


def bce(logits, target: float, reduce=True):
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, target),
        reduction="mean" if reduce else "none")


def masked_mean(x, mask):
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def class_ce(logits, labels):
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long(),
                           reduction="none").reshape(labels.shape)


def d_patch_loss(real, fake, wrong):
    return ((bce(real["cond"], 1.0) + bce(real["uncond"], 1.0)) / 2.0
            + (bce(fake["cond"], 0.0) + bce(wrong["cond"], 0.0)
               + bce(fake["uncond"], 0.0)) / 3.0)


def _norm(x, dim=-1, keepdim=False):
    return torch.sqrt(torch.clamp((x * x).sum(dim=dim, keepdim=keepdim),
                                  min=1e-12))


def _sym_ce(scores, mask):
    scores = scores.masked_fill(mask, NEG_INF)
    return (-torch.diagonal(torch.log_softmax(scores, 1)).mean()
            - torch.diagonal(torch.log_softmax(scores, 0)).mean())


def damsm_matching(regions, global_f, words, sent, lens, class_ids, sm):
    """DAMSM word + sentence matching loss of the batch."""
    b, t, d = words.shape
    valid = torch.arange(t, device=lens.device)[None] < lens[:, None]
    w = words[:, None].expand(b, b, t, d).reshape(b * b, t, d)
    v = valid[:, None].expand(b, b, t).reshape(b * b, t)
    reg = regions[None].expand(b, *regions.shape).reshape(
        b * b, *regions.shape[1:])
    scores = torch.bmm(reg, w.transpose(1, 2)).masked_fill(
        ~v[:, None, :], NEG_INF)
    attn = torch.softmax(torch.softmax(scores, -1).transpose(1, 2)
                         * sm["GAMMA1"], -1)
    ctx = torch.bmm(attn, reg)
    cos = (w * ctx).sum(-1) / (_norm(w) * _norm(ctx))
    cos = torch.where(v, sm["GAMMA2"] * cos, torch.full_like(cos, NEG_INF))
    sims = (torch.logsumexp(cos, -1) / sm["GAMMA2"]).reshape(b, b)
    same = class_ids[:, None] == class_ids[None, :]
    mask = same & ~torch.eye(b, dtype=torch.bool, device=same.device)
    words_l = _sym_ce(sm["GAMMA3"] * sm["GAMMA2"] * sims, mask)
    g = global_f / _norm(global_f, keepdim=True)
    s = sent / _norm(sent, keepdim=True)
    return words_l + _sym_ce(sm["GAMMA3"] * (s @ g.t()), mask)


# -- the step ----------------------------------------------------------------


class StageC(nn.Module):
    """Every Stage-C network under the port's parameter names, and the
    frozen label table."""

    def __init__(self, c: Dict, num: Numerics):
        super().__init__()
        self.c, self.num = c, num
        self.g_net = GNet(num, c)
        self.d_nets = nn.ModuleList(
            DNet(num, c["DF_DIM"], s, c["EMBEDDING_DIM"])
            for s in branch_sizes(c))
        self.obj_d = ObjectDNet(num, c)
        self.text_enc = RNNEncoder(c)
        self.img_enc = CNNEncoder(num, c["EMBEDDING_DIM"])
        self.register_buffer("label_table", torch.zeros(c["NUM_CLASSES"],
                                                        c["LABEL_DIM"]))
        self.text_enc.requires_grad_(False)
        self.img_enc.requires_grad_(False)

    def trained(self) -> Dict[str, nn.Parameter]:
        return {n: p for n, p in self.named_parameters() if p.requires_grad}

    def losses(self, batch: Dict, z, ca_eps):
        c = self.c
        caps, lens = batch["captions"].long(), batch["cap_lens"].long()
        boxes, valid = batch["boxes"].float(), batch["obj_valid"].float()
        labels = batch["labels"].long()
        with torch.no_grad():
            words, sent = self.text_enc(caps, lens)
            labels_emb = self.label_table[labels]
            sizes = branch_sizes(c)
            top = sizes[-1]
            maps = paste_masks(batch["shapes"], boxes, top)
            lay = {top: (maps * valid[..., None, None]).amax(1)[..., None]}
            for s in reversed(sizes[:-1]):
                prev = lay[s * 2]
                lay[s] = F.avg_pool2d(prev.permute(0, 3, 1, 2),
                                      prev.shape[1] // s).permute(0, 2, 3, 1)
        t = caps.shape[1]
        word_mask = torch.arange(t, device=caps.device)[None] >= lens[:, None]
        fakes, mu, logvar = self.g_net(z, sent, words, word_mask, labels_emb,
                                       boxes, batch["shapes"].float(), valid,
                                       ca_eps)
        wrong = torch.roll(sent, 1, 0)
        d_total = 0.0
        for i, dnet in enumerate(self.d_nets):
            l = lay[branch_sizes(c)[i]]
            trunk = dnet.trunk(batch["images"][i], l)
            d_total = d_total + d_patch_loss(
                dnet.heads(trunk, sent), dnet(fakes[i].detach(), sent, l),
                dnet.heads(trunk, wrong))
        real = self.obj_d(batch["images"][-1], boxes, labels_emb)
        fake = self.obj_d(fakes[-1].detach(), boxes, labels_emb)
        d_total = (d_total + masked_mean(bce(real["obj"], 1.0, False), valid)
                   + masked_mean(bce(fake["obj"], 0.0, False), valid)
                   + masked_mean(class_ce(real["cls"], labels), valid))
        g_total = 0.0
        for i, dnet in enumerate(self.d_nets):
            out = dnet(fakes[i], sent, lay[branch_sizes(c)[i]])
            g_total = g_total + bce(out["cond"], 1.0) + bce(out["uncond"],
                                                            1.0)
        fake_g = self.obj_d(fakes[-1], boxes, labels_emb)
        g_total = (g_total + masked_mean(bce(fake_g["obj"], 1.0, False), valid)
                   + masked_mean(class_ce(fake_g["cls"], labels), valid))
        regions, global_f = self.img_enc(fakes[-1])
        sm = c["SMOOTH"]
        g_total = g_total + sm["LAMBDA"] * damsm_matching(
            regions, global_f, words, sent, lens, batch["class_ids"], sm)
        kl = -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))
        return d_total, g_total + kl

    def grads(self, batch: Dict, z, ca_eps):
        """(d_loss, g_loss, {name: gradient}) at the current weights: the
        D losses by the D parameters, the G losses by the G parameters."""
        d_total, g_total = self.losses(batch, z, ca_eps)
        params = self.trained()
        d_names = [n for n in params if not n.startswith("g_net.")]
        g_names = [n for n in params if n.startswith("g_net.")]
        out = {}
        for loss, names in ((d_total, d_names), (g_total, g_names)):
            got = torch.autograd.grad(loss, [params[n] for n in names],
                                      allow_unused=True)
            out.update({n: torch.zeros_like(params[n]) if g is None else g
                        for n, g in zip(names, got)})
        return float(d_total.detach()), float(g_total.detach()), out


class Adam:
    """Adam as the port sets it up: b1 0.5, b2 0.999, eps 1e-8; the
    generator at GENERATOR_LR, every discriminator at DISCRIMINATOR_LR."""

    def __init__(self, c: Dict):
        self.c = c
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, nn.Parameter],
             grads: Dict[str, torch.Tensor]) -> None:
        b1, b2, eps = 0.5, 0.999, 1e-8
        self.t += 1
        for n, p in params.items():
            g = grads[n]
            m = self.m.setdefault(n, torch.zeros_like(p))
            v = self.v.setdefault(n, torch.zeros_like(p))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            lr = self.c["GENERATOR_LR" if n.startswith("g_net.")
                        else "DISCRIMINATOR_LR"]
            denom = v.sqrt() / math.sqrt(1 - b2 ** self.t) + eps
            p.addcdiv_(m, denom, value=-lr / (1 - b1 ** self.t))


def branch_sizes(c: Dict) -> List[int]:
    return [c["BASE_SIZE"] * 2 ** i for i in range(c["BRANCH_NUM"])]


def from_wire(c: Dict, batch: Dict[str, np.ndarray], device) -> Dict:
    """A uint8 wire batch as the step reads it: the image pyramid in
    [-1, 1] (each coarser scale the box-filter mean of the finer), masks
    in [0, 1]."""
    out = {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
           for k, v in batch.items() if k not in ("image_u8", "shapes_u8")}
    out["shapes"] = torch.as_tensor(batch["shapes_u8"],
                                    device=device).float() / 255.0
    img = torch.as_tensor(np.ascontiguousarray(batch["image_u8"]),
                          device=device).float() / 127.5 - 1.0
    pyr = [img]
    for s in reversed(branch_sizes(c)[:-1]):
        b, h, w, ch = pyr[0].shape
        f = h // s
        pyr.insert(0, pyr[0].reshape(b, s, f, s, f, ch).mean(dim=(2, 4)))
    out["images"] = pyr
    return out


def step_seed(seed: int, step: int, stream: int = 0) -> int:
    """The seed of the generator that draws a step's noise: numpy's
    SeedSequence over (seed, step, stream), its first 64-bit word halved."""
    state = np.random.SeedSequence([seed, step, stream]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


def step_noise(c: Dict, seed: int, step: int, batch: int, device):
    """A train step's z (B, Z_DIM) and CA-net eps (B, CONDITION_DIM),
    standard normal, drawn in that order on ``device``."""
    g = torch.Generator(device=device).manual_seed(step_seed(seed, step))
    z = torch.randn(batch, c["Z_DIM"], generator=g, device=device)
    eps = torch.randn(batch, c["CONDITION_DIM"], generator=g, device=device)
    return z, eps


def flat_config(tree: Dict) -> Dict:
    """The sizes the reference reads, from a configuration file's tree."""
    keys = {"TREE": ("BASE_SIZE", "BRANCH_NUM"),
            "GAN": ("GF_DIM", "DF_DIM", "Z_DIM", "CONDITION_DIM", "R_NUM"),
            "TEXT": ("EMBEDDING_DIM", "VOCAB_SIZE", "GLOVE_DIM",
                     "HIDDEN_DIM"),
            "OBJ": ("LABEL_DIM", "NUM_CLASSES", "ROI_SIZE"),
            "TRAIN": ("GENERATOR_LR", "DISCRIMINATOR_LR")}
    out = {k: tree[group][k] for group, names in keys.items() for k in names}
    out["SMOOTH"] = dict(tree["TRAIN"]["SMOOTH"])
    return out
