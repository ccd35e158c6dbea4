"""GroupNorm (+GLU) over channels-last activations: kernel K1 and its twin.

``group_norm`` is what the models call. On a CPU tensor it runs
``group_norm_reference``, the plain PyTorch twin; on a CUDA tensor it
launches the hand-written kernel ``csrc/groupnorm.cu`` (which replaces the
JAX package's Pallas kernel ``objgan_tpu/ops/groupnorm.py::_kernel``) or
raises. There is no fallback from the kernel to the twin.

On the card the kernel runs inside ``GroupNormFunction``, a
``torch.autograd.Function`` whose backward is the VJP of the twin with the
statistics recomputed from the saved ``x, scale, bias``, as the JAX
package's ``custom_vjp`` does (``_gn_bwd``). There is no backward kernel.

Semantics are the JAX package's ``group_norm_reference``: Linen GroupNorm
statistics in fp32 (E[x^2] - E[x]^2 clamped at 0), the per-channel affine,
a cast back to the input dtype, then optionally GLU over the channel halves.
"""

from __future__ import annotations

import ctypes

import torch

from objgan_tpu_torch.ops import _build

# Launches of the CUDA kernel since the last reset (the CPU twin never counts).
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256
# stats blocks per SM the split count aims for (B * S blocks in all)
_STATS_BLOCKS_PER_SM = 4
# smallest row range worth a stats block of its own
_MIN_ROWS_PER_SPLIT = 64
_MAX_FINALIZE_SMEM = 48 * 1024


def group_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, num_groups: int, eps: float,
                         use_glu: bool) -> torch.Tensor:
    """Plain PyTorch twin of kernel K1. x is (B, ..., C) channels-last."""
    shape = x.shape
    c = shape[-1]
    xf = x.float().reshape(shape[0], -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    mean2 = (xf * xf).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(shape) * scale.float() + bias.float()
    y = y.to(x.dtype)
    if use_glu:
        a, g = y.chunk(2, dim=-1)
        return a * torch.sigmoid(g)
    return y


def _entry():
    """The kernel's C entry point, built and typed at first use."""
    fn = _build.load("groupnorm").objgan_group_norm
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
    return fn


_sm_counts: dict = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def group_norm_cuda(x3: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, eps: float,
                    use_glu: bool) -> torch.Tensor:
    """Launch K1 on x3 (B, N, C), contiguous, bf16 or fp32, on a CUDA device.
    Returns (B, N, C) or (B, N, C // 2) with GLU, in x3's dtype."""
    global launches
    if x3.device.type != "cuda":
        raise ValueError(f"group_norm_cuda needs a CUDA tensor, got "
                         f"{x3.device}")
    if x3.dtype not in _DTYPE_CODE:
        raise TypeError(f"group_norm_cuda takes float32 or bfloat16, got "
                        f"{x3.dtype}")
    if x3.dim() != 3 or not x3.is_contiguous():
        raise ValueError(f"group_norm_cuda needs a contiguous (B, N, C) "
                         f"tensor, got shape {tuple(x3.shape)} strides "
                         f"{x3.stride()}")
    b, n, c = x3.shape
    if c % num_groups or (use_glu and c % 2):
        raise ValueError(f"C={c} must be divisible by num_groups="
                         f"{num_groups} (and by 2 with GLU)")
    if (2 * c + 2 * num_groups) * 4 > _MAX_FINALIZE_SMEM:
        raise ValueError(f"C={c} exceeds the finalize pass's shared memory")
    for name, p in (("scale", scale), ("bias", bias)):
        if (p.device != x3.device or p.dtype != torch.float32
                or p.shape != (c,) or not p.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous fp32 ({c},) tensor "
                             f"on {x3.device}")
    sms = _sm_count(x3.device)
    # stats row splits: enough (b, split) blocks to fill every SM
    s = max(1, min(-(-_STATS_BLOCKS_PER_SM * sms // b),
                   -(-n // _MIN_ROWS_PER_SPLIT)))
    c_out = c // 2 if use_glu else c
    y = torch.empty((b, n, c_out), dtype=x3.dtype, device=x3.device)
    # fp32 scratch: partial sums (B, S, C), partial sums of squares
    # (B, S, C), per-channel affine (B, 2, C)
    scratch = torch.empty(b * (2 * s + 2) * c, dtype=torch.float32,
                          device=x3.device)
    part = b * s * c
    apply_blocks = max(1, min(-(-b * n * c_out // _THREADS), 16 * sms))
    ptr, f32 = scratch.data_ptr(), 4
    err = _entry()(
        x3.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        ptr, ptr + part * f32, ptr + 2 * part * f32,
        _DTYPE_CODE[x3.dtype], b, n, c, num_groups, s, float(eps),
        int(use_glu), apply_blocks,
        torch.cuda.current_stream(x3.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"groupnorm kernel launch failed: cudaError {err}")
    launches += 1
    return y


def group_norm_backward_reference(x: torch.Tensor, scale: torch.Tensor,
                                  bias: torch.Tensor, num_groups: int,
                                  eps: float, use_glu: bool,
                                  grad_y: torch.Tensor,
                                  needs=(True, True, True)):
    """Gradients (dx, dscale, dbias) of ``group_norm_reference`` at
    (x, scale, bias) for the output cotangent ``grad_y``: autograd through
    the twin, statistics recomputed. Entries whose ``needs`` flag is False
    are None."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(want)
                  for t, want in zip((x, scale, bias), needs)]
        y = group_norm_reference(*leaves, num_groups, eps, use_glu)
        wanted = [t for t, want in zip(leaves, needs) if want]
        grads = iter(torch.autograd.grad(y, wanted, grad_y))
    return tuple(next(grads) if want else None for want in needs)


class GroupNormFunction(torch.autograd.Function):
    """K1 forward on (B, N, C), the twin's VJP backward."""

    @staticmethod
    def forward(ctx, x3, scale, bias, num_groups, eps, use_glu):
        ctx.save_for_backward(x3, scale, bias)
        ctx.args = (num_groups, eps, use_glu)
        return group_norm_cuda(x3, scale, bias, num_groups, eps, use_glu)

    @staticmethod
    def backward(ctx, grad_y):
        x3, scale, bias = ctx.saved_tensors
        grads = group_norm_backward_reference(
            x3, scale, bias, *ctx.args, grad_y,
            needs=ctx.needs_input_grad[:3])
        return (*grads, None, None, None)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float, use_glu: bool) -> torch.Tensor:
    """GroupNorm(+GLU) of a channels-last x (B, ..., C): the twin for a CPU
    tensor, kernel K1 (differentiable) for a CUDA tensor."""
    if x.device.type == "cpu":
        return group_norm_reference(x, scale, bias, num_groups, eps, use_glu)
    b, c = x.shape[0], x.shape[-1]
    y = GroupNormFunction.apply(x.reshape(b, -1, c), scale, bias, num_groups,
                                eps, use_glu)
    return y.reshape(*x.shape[:-1], y.shape[-1])
