"""ROI-align for the object-wise discriminator: kernels K2 (forward) and K3
(backward) and their plain PyTorch twins.

Port of ``objgan_tpu/ops/roi_align.py``. Boxes are axis-aligned, so
bilinear ROI-align (torchvision ``aligned=True``, ``sampling_ratio``
samples per bin and axis) is separable: per (image, box)

    out = A_y @ features @ A_x^T        (per channel)

with ``A_y (R, H)`` and ``A_x (R, W)`` the interpolate-and-average matrices
of ``_pool_matrix``. Samples outside [-1, n] contribute zero and samples
inside clamp to [0, n - 1], so a padded all-zero box returns the top-left
pixel's features: callers mask padded objects out.

``roi_align`` is what the models call. On a CPU tensor it runs the twin
``roi_align_reference`` (two fp32 einsums, differentiated by autograd); on
a CUDA tensor it runs ``RoiAlignFunction``, whose forward launches K2 and
whose backward launches K3 (``csrc/roi_align.cu``, replacing the Pallas
kernels ``_fwd_kernel`` and ``_bwd_kernel``), or raises. Boxes get no
gradient. Every channel count goes to the kernels: the JAX package's
``C % 128`` rule is a TPU tiling constraint.
"""

from __future__ import annotations

import ctypes

import torch

from objgan_tpu_torch.ops import _build

# Launches of each kernel since the last reset (the twins never count).
launches = {"fwd": 0, "bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _pool_matrix(out_n: int, src_n: int, origin: torch.Tensor,
                 extent: torch.Tensor, sampling_ratio: int) -> torch.Tensor:
    """Interpolate-and-average matrix A (..., out_n, src_n) for one axis.
    origin/extent: box start and size, normalised, any batch shape. Bin r
    averages ``sampling_ratio`` bilinear samples at
    ``origin*n + (r*q + k + 0.5) * extent*n / (out_n*q) - 0.5``."""
    q = sampling_ratio
    fine_n = out_n * q
    origin = origin.float()
    extent = extent.float()
    dev = origin.device
    i = torch.arange(fine_n, dtype=torch.float32, device=dev)[:, None]
    s = torch.arange(src_n, dtype=torch.float32, device=dev)[None, :]
    src = (origin[..., None, None] * src_n
           + (i + 0.5) * extent[..., None, None] * src_n / fine_n - 0.5)
    inside = ((src >= -1.0) & (src <= src_n)).float()
    src_c = torch.clamp(src, 0.0, src_n - 1.0)
    w = torch.clamp(1.0 - (src_c - s).abs(), min=0.0) * inside
    return w.reshape(*w.shape[:-2], out_n, q, src_n).mean(dim=-2)


def _pool_matrices(boxes: torch.Tensor, h: int, w: int, out_size: int,
                   sampling_ratio: int):
    boxes = boxes.detach()
    a_y = _pool_matrix(out_size, h, boxes[..., 1], boxes[..., 3],
                       sampling_ratio)  # (B, O, R, H)
    a_x = _pool_matrix(out_size, w, boxes[..., 0], boxes[..., 2],
                       sampling_ratio)  # (B, O, R, W)
    return a_y, a_x


def roi_align_reference(features: torch.Tensor, boxes: torch.Tensor,
                        out_size: int = 7,
                        sampling_ratio: int = 2) -> torch.Tensor:
    """Twin of K2: features (B, H, W, C), boxes (B, O, 4) normalised
    (x0, y0, w, h) -> (B, O, R, R, C) in the features' dtype, fp32 sums."""
    _, h, w, _ = features.shape
    a_y, a_x = _pool_matrices(boxes, h, w, out_size, sampling_ratio)
    f = features.float()
    t = torch.einsum("boih,bhwc->boiwc", a_y, f)
    out = torch.einsum("bojw,boiwc->boijc", a_x, t)
    return out.to(features.dtype)


def roi_align_backward_reference(boxes: torch.Tensor, g: torch.Tensor,
                                 f_shape, f_dtype: torch.dtype,
                                 out_size: int = 7,
                                 sampling_ratio: int = 2) -> torch.Tensor:
    """Twin of K3: the features' gradient for the output cotangent
    g (B, O, R, R, C), ``df[y,x,c] = sum_o sum_ij A_y[i,y] A_x[j,x]
    g[o,i,j,c]`` in fp32, cast once to ``f_dtype``."""
    _, h, w, _ = f_shape
    a_y, a_x = _pool_matrices(boxes, h, w, out_size, sampling_ratio)
    t = torch.einsum("boiy,boijc->boyjc", a_y, g.float())
    df = torch.einsum("bojx,boyjc->byxc", a_x, t)
    return df.to(f_dtype)


def _entry(name: str):
    fn = getattr(_build.load("roi_align"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
    return fn


def _check(t: torch.Tensor, name: str, dims: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dim() != dims or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dims}-d tensor, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")


def _check_boxes(boxes: torch.Tensor, b: int, device) -> None:
    _check(boxes, "boxes", 3)
    if (boxes.dtype != torch.float32 or boxes.shape[0] != b
            or boxes.shape[2] != 4 or boxes.device != device):
        raise ValueError(f"boxes must be fp32 (B={b}, O, 4) on {device}, got "
                         f"{boxes.dtype} {tuple(boxes.shape)} on "
                         f"{boxes.device}")


def roi_align_cuda(features: torch.Tensor, boxes: torch.Tensor,
                   out_size: int, sampling_ratio: int) -> torch.Tensor:
    """Launch K2: features (B, H, W, C) fp32/bf16 and boxes (B, O, 4) fp32,
    both contiguous on one CUDA device -> (B, O, R, R, C)."""
    _check(features, "features", 4)
    if features.dtype not in _DTYPE_CODE:
        raise TypeError(f"roi_align_cuda takes float32 or bfloat16, got "
                        f"{features.dtype}")
    b, h, w, c = features.shape
    _check_boxes(boxes, b, features.device)
    o = boxes.shape[1]
    out = torch.empty((b, o, out_size, out_size, c), dtype=features.dtype,
                      device=features.device)
    if out.numel() == 0:
        return out
    err = _entry("objgan_roi_align_fwd")(
        features.data_ptr(), boxes.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[features.dtype], b, h, w, c, o, out_size, sampling_ratio,
        torch.cuda.current_stream(features.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"roi_align forward kernel launch failed: "
                           f"cudaError {err}")
    launches["fwd"] += 1
    return out


def roi_align_backward_cuda(boxes: torch.Tensor, g: torch.Tensor, f_shape,
                            out_size: int,
                            sampling_ratio: int) -> torch.Tensor:
    """Launch K3: the features' gradient (B, H, W, C) in g's dtype for the
    cotangent g (B, O, R, R, C), contiguous fp32/bf16 on a CUDA device."""
    _check(g, "g", 5)
    if g.dtype not in _DTYPE_CODE:
        raise TypeError(f"roi_align_backward_cuda takes float32 or bfloat16, "
                        f"got {g.dtype}")
    b, h, w, c = f_shape
    o = g.shape[1]
    if tuple(g.shape) != (b, o, out_size, out_size, c):
        raise ValueError(f"g {tuple(g.shape)} does not match features "
                         f"{tuple(f_shape)} at R={out_size}")
    _check_boxes(boxes, b, g.device)
    if boxes.shape[1] != o:
        raise ValueError(f"boxes hold {boxes.shape[1]} objects, g {o}")
    df = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
    if df.numel() == 0:
        return df
    err = _entry("objgan_roi_align_bwd")(
        g.data_ptr(), boxes.data_ptr(), df.data_ptr(), _DTYPE_CODE[g.dtype],
        b, h, w, c, o, out_size, sampling_ratio,
        torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        # cudaErrorInvalidValue (1) also means O, R and W need more shared
        # memory than K3 may take (bwd_smem_bytes in csrc/roi_align.cu)
        raise RuntimeError(f"roi_align backward kernel launch failed: "
                           f"cudaError {err} (O={o}, R={out_size}, W={w})")
    launches["bwd"] += 1
    return df


class RoiAlignFunction(torch.autograd.Function):
    """K2 forward, K3 backward; the boxes are constants."""

    @staticmethod
    def forward(ctx, features, boxes, out_size, sampling_ratio):
        boxes = boxes.detach().float().contiguous()
        ctx.save_for_backward(boxes)
        ctx.f_shape = tuple(features.shape)
        ctx.args = (out_size, sampling_ratio)
        return roi_align_cuda(features.contiguous(), boxes, out_size,
                              sampling_ratio)

    @staticmethod
    def backward(ctx, g):
        (boxes,) = ctx.saved_tensors
        df = roi_align_backward_cuda(boxes, g.contiguous(), ctx.f_shape,
                                     *ctx.args)
        return df, None, None, None


def roi_align(features: torch.Tensor, boxes: torch.Tensor, out_size: int = 7,
              sampling_ratio: int = 2) -> torch.Tensor:
    """ROI-align of features (B, H, W, C) over boxes (B, O, 4) ->
    (B, O, R, R, C): the twin for a CPU tensor, K2/K3 for a CUDA tensor."""
    if features.device.type == "cpu":
        return roi_align_reference(features, boxes, out_size, sampling_ratio)
    return RoiAlignFunction.apply(features, boxes, out_size, sampling_ratio)
