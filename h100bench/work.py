"""The yardstick: the H100's peaks and the least work of each hand-written
kernel, counted from shapes and boxes alone.

A frozen copy of the arithmetic of the port's ``utils/breakdown.py::
kernel_work`` and ``ops/roi_align.py::roi_work``: each input byte read
once and each output byte written once. A kernel's bound is the larger of
its FLOPs over the peak and its bytes over the memory bandwidth.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from h100bench.reference.stagec import roi_matrix

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, fp32 outside them,
# HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_s(nbytes: float, flops: float,
            peak_flops: float = PEAK_FP32_FLOPS) -> float:
    return max(nbytes / PEAK_BYTES, flops / peak_flops)


def k1_work(numel: int, itemsize: int, channels: int,
            use_glu: bool) -> Tuple[int, int]:
    """(bytes, flops) of one GroupNorm(+GLU) launch over ``numel``
    elements: x read once, y (half of x under GLU) written once, the fp32
    scale and bias read once; 8 operations an element."""
    x_bytes = numel * itemsize
    y_bytes = x_bytes // 2 if use_glu else x_bytes
    return x_bytes + y_bytes + 2 * channels * 4, 8 * numel


def k1_bound_s(calls: Iterable[tuple]) -> float:
    """The summed bound of K1 launches given as (numel, itemsize,
    channels, GLU)."""
    return sum(bound_s(*k1_work(*c)) for c in calls)


def roi_work(boxes: torch.Tensor, f_shape, out_size: int,
             q: int = 2) -> Tuple[int, int]:
    """(touched feature pixels, multiply-add terms) of one ROI-align over
    ``boxes`` (B, O, 4) on features of ``f_shape`` (B, H, W, C): the pixels
    some sample weighs, and the sum over boxes of nnz(A_y) * nnz(A_x)."""
    _, h, w, _ = f_shape
    b = boxes.detach().float()
    a_y = roi_matrix(out_size, h, b[..., 1], b[..., 3], q)
    a_x = roi_matrix(out_size, w, b[..., 0], b[..., 2], q)
    rows, cols = (a_y != 0).any(-2), (a_x != 0).any(-2)
    touched = (rows[..., :, None] & cols[..., None, :]).any(1).sum()
    terms = ((a_y != 0).sum((-1, -2)) * (a_x != 0).sum((-1, -2))).sum()
    return int(touched), int(terms)


def roi_fwd_work(boxes, f_shape, itemsize: int, out_size: int,
                 q: int = 2) -> Tuple[int, int]:
    """(bytes, flops) of K2: the touched pixels read, the ROIs written."""
    b, o = boxes.shape[:2]
    c = f_shape[-1]
    touched, terms = roi_work(boxes, f_shape, out_size, q)
    out_bytes = b * o * out_size * out_size * c * itemsize
    return (touched * c * itemsize + out_bytes + boxes.numel() * 4,
            2 * terms * c)


def roi_bwd_work(boxes, f_shape, itemsize: int, out_size: int,
                 q: int = 2) -> Tuple[int, int]:
    """(bytes, flops) of K3: the ROIs' gradient read, the whole feature
    gradient written."""
    b, o = boxes.shape[:2]
    _, h, w, c = f_shape
    _, terms = roi_work(boxes, f_shape, out_size, q)
    g_bytes = b * o * out_size * out_size * c * itemsize
    return (g_bytes + b * h * w * c * itemsize + boxes.numel() * 4,
            2 * terms * c)
