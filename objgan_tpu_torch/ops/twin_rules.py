"""How the hand-written kernels are held to their plain PyTorch twins: the
tolerances, written once, one comparison per kernel, the adversarial ROI
boxes and the kernels' names on the device.

Each comparison is made element by element in fp64,
``|got - want| <= atol * span + rtol * |want|``, and fails on a NaN; it
returns (the largest error over ``span``, whether every element is within).

- K1 (``groupnorm.group_norm_cuda``): fp32 within FP32_ATOL of the twin
  evaluated in fp64 (``k1_twin``: at the DAMSM step's (48, 16384, 32),
  |mean| / std ~ 6, the fp32 twin's own statistics err by 3-4e-5); bf16
  within K1_BF16_ATOL + K1_BF16_RTOL * |want| of the twin in bf16 (a fp32
  difference can round to the neighbouring bf16 value, and the GLU rounds
  three times).
- K1 backward (``groupnorm.group_norm_backward_cuda``) against the twin's
  VJP in fp64: dx at K1's tolerances (rounded to bf16 once; under GLU a, g
  and the sigmoid are rounded as the forward rounds them). dscale and
  dbias are fp32 sums over B * N rows: within PARAM_RTOL of their largest
  magnitude (at least 1) in both dtypes, which a sum that drops or counts
  twice a share of the rows fails; only under GLU in bf16, where the
  rounded a, g and sigmoid enter every term, within K1's bf16 numbers so
  scaled. Largest errors measured on an H100, as a share of that
  magnitude: 7.9e-7 without GLU, 5.9e-7 in fp32 with it, 8.3e-3 under GLU
  in bf16 (the calls of a coco_objgan train step; 3.2e-3 at the card
  tests' shapes).
- K2 and K3 (``roi_align.roi_align_cuda``, ``roi_align_backward_cuda``):
  fp32 within FP32_ATOL; bf16 within ROI_BF16_ATOL + ROI_BF16_RTOL *
  |want| (fp32 sums in another order, then one rounding to bf16, a step of
  at most 2^-8 relative, on both sides).
"""

from __future__ import annotations

from typing import Tuple

import torch

FP32_ATOL = 1e-4
K1_BF16_ATOL, K1_BF16_RTOL = 3e-2, 2e-2
PARAM_RTOL = 1e-4
ROI_BF16_ATOL, ROI_BF16_RTOL = 1e-2, 1e-2

# each kernel's name in a CUDA graph's nodes and the profiler's events
KERNEL_NAMES = {"K1": "gn_fused_kernel", "K1 backward": "gn_bwd_kernel",
                "K2": "roi_fwd_kernel", "K3": "roi_bwd_kernel"}


def within(got: torch.Tensor, want: torch.Tensor, atol: float,
           rtol: float = 0.0, span: float = 1.0) -> Tuple[float, bool]:
    """(largest |got - want| over ``span``, whether every element lies
    within ``atol * span + rtol * |want|``), in fp64 on ``want``'s
    device."""
    with torch.no_grad():
        want = want.to(torch.float64)
        err = (got.to(want.device, torch.float64) - want).abs()
        ok = bool((err <= atol * span + rtol * want.abs()).all())
        return float(err.max()) / span, ok


def _tolerances(dtype: torch.dtype, bf16: Tuple[float, float]):
    if dtype == torch.bfloat16:
        return bf16
    if dtype == torch.float32:
        return FP32_ATOL, 0.0
    raise ValueError(f"no tolerance for {dtype}")


def k1_twin(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            num_groups: int, eps: float, use_glu: bool) -> torch.Tensor:
    """What K1's output at these arguments is held to: the twin, in fp64
    for an fp32 ``x`` and in bf16 for a bf16 one."""
    from objgan_tpu_torch.ops.groupnorm import group_norm_reference

    if x.dtype == torch.float32:
        x = x.double()
    return group_norm_reference(x, scale, bias, num_groups, eps, use_glu)


def k1(got: torch.Tensor, want: torch.Tensor,
       dtype: torch.dtype) -> Tuple[float, bool]:
    """K1's output for an x of ``dtype`` against ``k1_twin``'s."""
    return within(got, want, *_tolerances(dtype, (K1_BF16_ATOL,
                                                  K1_BF16_RTOL)))


def k1_grad(name: str, got: torch.Tensor, want: torch.Tensor,
            dtype: torch.dtype, use_glu: bool) -> Tuple[float, bool]:
    """K1 backward's ``name`` ("dx", "dscale" or "dbias") for an x of
    ``dtype`` against the twin's VJP in fp64; dscale's and dbias's error
    is over their largest magnitude (at least 1)."""
    dx = _tolerances(dtype, (K1_BF16_ATOL, K1_BF16_RTOL))
    if name == "dx":
        return within(got, want, *dx)
    span = max(1.0, float(want.abs().max()))
    if use_glu and dtype == torch.bfloat16:
        return within(got, want, *dx, span)
    return within(got, want, PARAM_RTOL, 0.0, span)


def roi(got: torch.Tensor, want: torch.Tensor,
        dtype: torch.dtype) -> Tuple[float, bool]:
    """K2's output or K3's feature gradient in ``dtype`` against its
    twin's."""
    return within(got, want, *_tolerances(dtype, (ROI_BF16_ATOL,
                                                  ROI_BF16_RTOL)))


def adversarial_boxes(device=None) -> torch.Tensor:
    """(3, 10, 4) boxes (x0, y0, w, h), relative to the frame, at the edges
    of K2's and K3's designs. Image 0: the full frame; a zero (padded) box
    at object 1, which samples the top-left pixel only; a sub-pixel box
    whose samples all fall in one pixel pair; boxes ending on the frame;
    boxes reaching past it; coordinates on multiples of 1/32; a box wider
    than the frame. Image 1: a box wholly off the frame, boxes straddling
    its edges, one-pixel-thin boxes along them, a box of 1e-4 of the
    frame. Image 2: all ten objects on one band of eight rows (of 32)."""
    edges = [[0.0, 0.0, 1.0, 1.0],
             [0.0, 0.0, 0.0, 0.0],
             [0.5 + 0.1 / 32, 0.3 + 0.2 / 32, 0.2 / 32, 0.3 / 32],
             [0.75, 0.5, 0.25, 0.5],
             [0.8, -0.3, 0.6, 0.5],
             [-0.2, 0.9, 0.4, 0.6],
             [3 / 32, 5 / 32, 7 / 32, 9 / 32],
             [0.25, 13 / 32, 17 / 32, 1 / 32],
             [-0.5, -0.5, 2.0, 2.0],
             [0.0, 0.0, 0.0, 0.0]]
    outside = [[0.9, 0.9, 0.3, 0.3], [0.0, 0.0, 0.0, 0.0],
               [-0.2, 0.5, 0.4, 0.4], [0.0, 0.0, 1.0, 1.0],
               [0.97, 0.0, 0.03, 1.0], [0.5, 0.97, 0.5, 0.03],
               [0.3, 0.3, 1e-4, 1e-4], [1.2, 1.2, 0.5, 0.5],
               [-0.5, -0.5, 2.0, 2.0], [0.0, 0.0, 0.0, 0.0]]
    band = [[0.08 * k, 8 / 32 + k / 320, 0.05 + 0.02 * k, 0.2]
            for k in range(10)]
    return torch.tensor([edges, outside, band], device=device)
