"""Plain PyTorch reference of Obj-GAN's Stage C with the paper's DAMSM image
encoder: AttnGAN's ``CNN_ENCODER`` (Xu et al., CVPR 2018,
arXiv:1711.10485, section 3.3) on a frozen ImageNet Inception-v3
(Szegedy et al., arXiv:1512.00567) as torchvision builds it, in place of
``stagec.CNNEncoder``. Everything else is ``stagec``'s, and its names are
the port's, so one state dict loads into both.

It imports nothing of the program and no JAX; it computes in float32 with
TF32 off (``no_tf32``), and autograd differentiates it: G's DAMSM term
passes its gradient through the frozen backbone to the fake image, as in
the lineage, while the backbone's parameters take none.

The backbone follows torchvision's ``inception_v3`` graph, NCHW: each
``BasicConv2d`` a bias-free conv with torchvision's explicit symmetric
pads (1x7 / 7x1 pad (0, 3) / (3, 0), 1x3 / 3x1 pad (0, 1) / (1, 0); the
stride-2 convs VALID), ``F.batch_norm`` in eval mode on its statistics at
eps 1e-3, ReLU; max pool 3/2; the branches' average pool 3/1/1 with
``count_include_pad``; the global average pool. Departures, each to match
the port and the lineage's encoder: the input is the image in [-1, 1]
resized to 299 px (bilinear, ``align_corners=False``, no antialias; no
``transform_input``); ``AuxLogits`` is absent; ``fc`` (the classifier) is
held for its weights' names and not run, since the encoder reads only
``Mixed_6e`` (17x17x768) and the pool (2048). The projections are the
lineage's: ``emb_features`` a bias-free 1x1 conv of ``Mixed_6e``,
``emb_cnn_code`` a dense layer with bias of the pool, each to
``EMBEDDING_DIM``.

``Numerics(control="tf32")`` is the control of this configuration: the
reference with the image encoder computed under TF32 (cuDNN's and
cuBLAS's TF32 switched on for its forward and for its backward, between
two identity marks), everything else as the sound reference. ``fp8`` and
``int8`` are ``stagec``'s.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from h100bench.reference import stagec
# the rest of the step as stagec has it (what the training drivers read)
from h100bench.reference.stagec import (Adam, flat_config,  # noqa: F401
                                        from_wire, no_tf32, step_noise,
                                        step_seed)

ROUNDINGS = dict(stagec.ROUNDINGS, tf32=None)  # the controls' names
BN_EPS = 1e-3


@dataclass
class Numerics(stagec.Numerics):
    """``stagec.Numerics``, and ``control="tf32"``: the image encoder under
    TF32, the rest in float32."""
    tf32_encoder: bool = False

    def __post_init__(self):
        if self.control == "tf32":
            self.control, self.tf32_encoder = None, True


def _tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")


@contextlib.contextmanager
def tf32_on(on: bool):
    if not on:
        yield
        return
    _tf32(True)
    try:
        yield
    finally:
        stagec.no_tf32()


class _Switch(torch.autograd.Function):
    """Identity forward; in the backward, TF32 set to ``on`` as the
    gradients pass."""

    @staticmethod
    def forward(ctx, on, *xs):
        ctx.on = on
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.on:
            _tf32(True)
        else:
            stagec.no_tf32()
        return (None, *grads)


# -- Inception-v3, torchvision's graph ---------------------------------------


class BasicConv2d(nn.Module):
    """conv (no bias) -> BatchNorm (eval, eps 1e-3) -> ReLU, NCHW; the
    BatchNorm leaves under the port's names."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn_scale = nn.Parameter(torch.ones(cout))
        self.bn_bias = nn.Parameter(torch.zeros(cout))
        self.bn_mean = nn.Parameter(torch.zeros(cout))
        self.bn_var = nn.Parameter(torch.ones(cout))

    def forward(self, x):
        x = F.batch_norm(self.conv(x), self.bn_mean, self.bn_var,
                         self.bn_scale, self.bn_bias, training=False,
                         eps=BN_EPS)
        return F.relu(x)


def _pool3(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_pool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), b3, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_pool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_pool3(x))], 1)


class InceptionV3(nn.Module):
    """images (B, S, S, 3) in [-1, 1] -> (``Mixed_6e`` (B, 768, 17, 17),
    the global pool (B, 2048)), float32."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, 1000)  # not run (see the module's notes)

    def forward(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.interpolate(images.float().permute(0, 3, 1, 2),
                          size=(299, 299), mode="bilinear",
                          align_corners=False, antialias=False)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(F.max_pool2d(x, 3, 2)))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        mixed_6e = x
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        return mixed_6e, F.adaptive_avg_pool2d(x, 1).flatten(1)


class InceptionEncoder(nn.Module):
    """AttnGAN's ``CNN_ENCODER``: images (B, S, S, 3) -> (regions
    (B, 289, D), global (B, D)), the regions in row-major order of the
    17x17 grid."""

    def __init__(self, num: stagec.Numerics, embed: int):
        super().__init__()
        self.tf32 = getattr(num, "tf32_encoder", False)
        self.backbone = InceptionV3()
        self.emb_features = stagec.Conv(num, 768, embed, 1)
        self.emb_cnn_code = stagec.Dense(num, 2048, embed, bias=True)

    def forward(self, images):
        on = self.tf32
        if on and images.requires_grad:
            (images,) = _Switch.apply(False, images)  # last in the backward
        with tf32_on(on):
            mixed_6e, pool = self.backbone(images)
            reg = self.emb_features(mixed_6e.permute(0, 2, 3, 1))
            b, r1, r2, d = reg.shape
            out = (reg.reshape(b, r1 * r2, d), self.emb_cnn_code(pool))
        if on and any(t.requires_grad for t in out):
            out = _Switch.apply(True, *out)  # first in the backward
        return out


class StageC(stagec.StageC):
    """``stagec.StageC`` with ``InceptionEncoder`` as ``img_enc``
    (frozen)."""

    def __init__(self, c: Dict, num: stagec.Numerics):
        super().__init__(c, num)
        self.img_enc = InceptionEncoder(num, c["EMBEDDING_DIM"])
        self.img_enc.requires_grad_(False)

    def damsm_term(self, batch: Dict, z, ca_eps):
        """G's DAMSM term alone, LAMBDA times the matching loss of the
        finest fake, as ``losses`` adds it to the G loss."""
        c = self.c
        caps, lens = batch["captions"].long(), batch["cap_lens"].long()
        with torch.no_grad():
            words, sent = self.text_enc(caps, lens)
            labels_emb = self.label_table[batch["labels"].long()]
        word_mask = torch.arange(caps.shape[1], device=caps.device)[None] \
            >= lens[:, None]
        fakes, _, _ = self.g_net(z, sent, words, word_mask, labels_emb,
                                 batch["boxes"].float(),
                                 batch["shapes"].float(),
                                 batch["obj_valid"].float(), ca_eps)
        regions, global_f = self.img_enc(fakes[-1])
        sm = c["SMOOTH"]
        return sm["LAMBDA"] * stagec.damsm_matching(
            regions, global_f, words, sent, lens, batch["class_ids"], sm)
