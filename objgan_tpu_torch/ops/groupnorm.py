"""GroupNorm (+GLU) over channels-last activations: kernel K1 and its twin.

``group_norm`` is what the models call. On a CPU tensor it runs
``group_norm_reference``, the plain PyTorch twin; on a CUDA tensor it
launches the hand-written kernel ``csrc/groupnorm.cu`` (which replaces the
JAX package's Pallas kernel ``objgan_tpu/ops/groupnorm.py::_kernel``) or
raises. There is no fallback from the kernel to the twin.

One call is one kernel launch. ``_plan`` (pure Python, tested on the CPU)
picks how: a thread-block cluster per batch element whose CTAs keep their
rows of x in shared memory where they fit (read once from device memory),
or stream the rest and read it a second time (see csrc/groupnorm.cu).

On the card the kernel runs inside ``GroupNormFunction``, a
``torch.autograd.Function`` whose backward is "K1 backward", a second
hand-written kernel in the same source: the VJP of the twin with the
statistics recomputed from the saved ``x, scale, bias``, as the JAX
package's ``custom_vjp`` does (``_gn_bwd``, autodiff of its reference; no
TPU kernel). One launch per call, and a second, small one that sums the
batch elements' dscale and dbias where they are wanted; ``_bwd_plan``
(pure Python, tested on the CPU) picks cluster and kept rows as ``_plan``
does. On a CPU tensor autograd runs through the twin, and
``group_norm_backward_reference`` (that VJP) is the oracle the kernel is
held to.

Semantics are the JAX package's ``group_norm_reference``: Linen GroupNorm
statistics in fp32 (E[x^2] - E[x]^2 clamped at 0), the per-channel affine,
a cast back to the input dtype, then optionally GLU over the channel halves.
The kernel takes its sums about a pivot (csrc/groupnorm.cu), which equals
E[x^2] - E[x]^2 in exact arithmetic and keeps fp32 from cancelling where
|mean| >> std; there it is closer to the exact statistics than the twin.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch

from objgan_tpu_torch.ops import _build

# Launches of the CUDA kernel since the last reset (the CPU twin never counts).
launches = 0
# Calls of K1 backward since the last reset, one per call (a call launches
# one or two kernels); the CPU twin never counts.
bwd_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The same numbers as csrc/groupnorm.cu's kThreads, kChunks, kStages and
# kMaxCluster.
_THREADS = 256
_CHUNKS = 8
_STAGES = 4
_MAX_CLUSTER = 16
# The plan keeps a CTA within this, so that two CTAs share an SM: 228 KB of
# shared memory per SM, less 1 KB the system keeps per CTA, halved.
_HALF_SMEM = 115712
# A small slice takes a cluster of up to _SPREAD CTAs while each keeps at
# least _MIN_CTA_BYTES of it: more SMs per batch element, at a cluster
# barrier whose skew outweighs them beyond that.
_SPREAD = 4
_MIN_CTA_BYTES = 32 * 1024
# Bytes of one ring slot of the streaming regime; the ring is used once a
# CTA streams more than _RING_MIN_BYTES (below, 16-byte loads beside more
# resident rows are faster).
_RING_SLOT_BYTES = 16 * 1024
_RING_MIN_BYTES = 96 * 1024
# Resident rows of fewer bytes than this are copied by the threads: a bulk
# copy's set-up costs more than it saves there.
_MIN_BULK_BYTES = 32 * 1024
# In a one-wave plan a CTA streams at most this many bytes of x; a larger
# share is slower than resident CTAs in several waves (measured at (160,
# 4096, 64) fp32).
_MAX_STREAM_BYTES = 768 * 1024
# Cluster sizes for one wave: on an H100 SXM 16 clusters of 12 are
# co-resident at two CTAs per SM, but only 14 of 14 or 16 (GPCs of 12 to 18
# SMs). Several waves take powers of two up to 16.
_WAVE_SIZES = (1, 2, 4, 8, 12)
_SIZES = (1, 2, 4, 8, _MAX_CLUSTER)


def group_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, num_groups: int, eps: float,
                         use_glu: bool) -> torch.Tensor:
    """Plain PyTorch twin of kernel K1. x is (B, ..., C) channels-last. It
    computes in fp32 (in fp64 for an fp64 x, which ``twin_rules.k1_twin``
    uses as the exact reference for K1's fp32 calls)."""
    shape = x.shape
    c = shape[-1]
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct).reshape(shape[0], -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    mean2 = (xf * xf).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(shape) * scale.to(ct) + bias.to(ct)
    y = y.to(x.dtype)
    if use_glu:
        a, g = y.chunk(2, dim=-1)
        return a * torch.sigmoid(g)
    return y


class Plan(NamedTuple):
    """How one K1 call is launched: grid (cluster, B) in clusters of
    ``cluster`` CTAs; CTA r owns rows [r * rows, (r + 1) * rows) of its batch
    element and keeps the first ``res_rows`` in shared memory (copied by
    bulk copies if ``bulk``, else by the threads); the rest stream through a
    ring of _STAGES slots of ``ring_rows`` rows (0: 16-byte loads);
    ``smem`` bytes of dynamic shared memory; ``vec`` elements per vector."""
    regime: str   # "resident": x[b] fits in the cluster; else "streaming"
    cluster: int
    rows: int
    res_rows: int
    ring_rows: int
    bulk: bool
    smem: int
    vec: int
    grid: Tuple[int, int]


def _fixed_smem(c: int, vec: int) -> int:
    """Shared memory before the ring and the row tile: mbarriers, a scratch
    of _THREADS * vec floats and three 2C float arrays (csrc/groupnorm.cu's
    tile_offset)."""
    raw = 8 * (_CHUNKS + _STAGES) + 4 * _THREADS * vec + 24 * c
    return -(-raw // 128) * 128


def _vec_width(c: int, itemsize: int, use_glu: bool) -> int:
    """16-byte vectors when every row (and the GLU gate half) starts on a
    16-byte boundary, else 1."""
    v = 16 // itemsize
    return v if c % v == 0 and (not use_glu or (c // 2) % v == 0) else 1


def _slots(sms: int) -> int:
    """CTAs the card runs at once at two per SM, as clusters: count 7/8 of
    them, for the SMs that whole clusters leave free in a GPC."""
    return 2 * sms * 7 // 8


def _cluster_for(b: int, n: int, cap: int, row_bytes: int, sms: int,
                 max_stream: float = math.inf) -> int:
    """The cluster size of a plan over b batch elements of n rows, a CTA
    keeping at most ``cap`` rows of ``row_bytes`` bytes read each. The
    clusters of one wave (_WAVE_SIZES with b * size <= _slots(sms)) run
    every batch element at once: the smallest that keeps every row (spread
    up to _SPREAD CTAs while each reads _MIN_CTA_BYTES), else the largest
    while a CTA's share is at most ``max_stream`` bytes; beyond that more
    waves, at the smallest power of two that keeps every row, or 16. No CTA
    is left without rows."""

    def rows_at(cs):
        return -(-n // cs)

    wave = [cs for cs in _WAVE_SIZES if b * cs <= _slots(sms)] or [1]
    fit = [cs for cs in wave if rows_at(cs) <= cap]
    if fit:
        cluster = max(cs for cs in wave if cs == fit[0] or (
            fit[0] < cs <= _SPREAD and rows_at(cs) * row_bytes
            >= _MIN_CTA_BYTES))
    elif rows_at(wave[-1]) * row_bytes <= max_stream:
        cluster = wave[-1]
    else:
        cluster = next((cs for cs in _SIZES if rows_at(cs) <= cap),
                       _MAX_CLUSTER)
    while cluster > 1 and (cluster - 1) * rows_at(cluster) >= n:
        cluster = max(cs for cs in _WAVE_SIZES if cs < cluster)
    return cluster


def _plan(b: int, n: int, c: int, itemsize: int, use_glu: bool, sms: int,
          aligned: bool = True) -> Plan:
    """The launch plan of K1 for x (b, n, c) of ``itemsize`` bytes on a card
    with ``sms`` SMs; ``aligned`` says x starts on a 16-byte boundary. A CTA
    takes at most _HALF_SMEM bytes of shared memory, so that two share an
    SM.

    The cluster is ``_cluster_for``'s: resident in one wave where a
    cluster holds the slice x[b], else streaming in one wave while a CTA's
    share is at most _MAX_STREAM_BYTES, else more waves (resident at the
    smallest power of two that holds the slice, or streaming at 16)."""
    vec = _vec_width(c, itemsize, use_glu) if aligned else 1
    row = c * itemsize
    fixed = _fixed_smem(c, vec)
    if fixed + row > _HALF_SMEM:
        raise ValueError(f"C={c} is too wide for K1's shared memory")
    cap = (_HALF_SMEM - fixed) // row  # rows one CTA can hold
    cluster = _cluster_for(b, n, cap, row, sms, _MAX_STREAM_BYTES)
    rows = -(-n // cluster)
    ring_rows = 0
    if ((rows - cap) * row > _RING_MIN_BYTES and vec > 1
            and c // vec <= _THREADS):
        ring_rows = max(1, _RING_SLOT_BYTES // row)
        if fixed + (_STAGES * ring_rows + 1) * row > _HALF_SMEM:
            ring_rows = 0
    res_rows = min(rows, (_HALF_SMEM - fixed - _STAGES * ring_rows * row)
                   // row)
    data = (_STAGES * ring_rows + res_rows) * row
    return Plan("resident" if res_rows == rows else "streaming", cluster,
                rows, res_rows, ring_rows,
                vec > 1 and res_rows * row > _MIN_BULK_BYTES, fixed + data,
                vec, (cluster, b))


def plan_for(x3: torch.Tensor, use_glu: bool) -> Plan:
    """The plan ``group_norm_cuda`` launches for x3 (B, N, C) on its card."""
    b, n, c = x3.shape
    return _plan(b, n, c, x3.element_size(), use_glu, _sm_count(x3.device),
                 x3.data_ptr() % 16 == 0)


class BwdPlan(NamedTuple):
    """How one K1 backward call is launched: grid (cluster, B) in clusters
    of ``cluster`` CTAs; CTA r owns rows [r * rows, (r + 1) * rows) of its
    batch element and keeps the first ``res_rows`` of x (and of the
    cotangent where dx is wanted) in shared memory; the rest are read again
    in each later pass; ``smem`` bytes of dynamic shared memory; ``vec``
    elements per vector; ``params``: dscale and dbias are wanted, and a
    second kernel sums the batch elements' partials."""
    regime: str   # "resident": every byte of x and dy read once
    cluster: int
    rows: int
    res_rows: int
    smem: int
    vec: int
    params: bool


def _bwd_fixed_smem(c: int, vec: int) -> int:
    """Shared memory before the kept rows: a scratch of _THREADS * vec
    floats, 4C floats of partials, 4C of the cluster's sums and eight C
    float arrays (csrc/groupnorm.cu's bwd_tile_offset)."""
    raw = 4 * (_THREADS * vec + 16 * c)
    return -(-raw // 128) * 128


def _bwd_vec_width(c: int, itemsize: int, use_glu: bool) -> int:
    """16-byte vectors (8-byte for bf16 with GLU, where a thread holds both
    halves' coefficients) when every row and the GLU's halves start on
    such a boundary, else 1."""
    v = 16 // itemsize
    if use_glu:
        v = min(v, 4)
    return v if c % v == 0 and (not use_glu or (c // 2) % v == 0) else 1


def _bwd_plan(b: int, n: int, c: int, itemsize: int, use_glu: bool,
              needs: Tuple[bool, bool, bool], sms: int,
              aligned: bool = True) -> BwdPlan:
    """The launch plan of K1 backward for x (b, n, c) of ``itemsize`` bytes
    and the gradients ``needs`` flags (dx, dscale, dbias) on a card with
    ``sms`` SMs; ``aligned`` says x and the cotangent start on a 16-byte
    boundary. A CTA takes at most _HALF_SMEM bytes of shared memory.

    The passes after the first (with GLU, or for dx) read x and the
    cotangent again; a kept row spares that, so a row keeps x, and the
    cotangent where dx is wanted. The cluster is ``_cluster_for``'s, always
    in one wave: resident where a cluster keeps every row, else streaming
    at the largest, keeping as many rows as fit. A call of one pass (no
    GLU, no dx) keeps nothing and reads everything once."""
    want_dx, params = needs[0], bool(needs[1] or needs[2])
    if not (want_dx or params):
        raise ValueError("K1 backward with no gradient wanted")
    vec = _bwd_vec_width(c, itemsize, use_glu) if aligned else 1
    cd = c // 2 if use_glu else c
    read = (c + cd) * itemsize  # bytes of x and the cotangent in a row
    keep = (c + cd * want_dx) * itemsize if use_glu or want_dx else 0
    fixed = _bwd_fixed_smem(c, vec)
    if fixed + keep > _HALF_SMEM:
        raise ValueError(f"C={c} is too wide for K1 backward's shared memory")
    cap = (_HALF_SMEM - fixed) // keep if keep else n  # rows a CTA keeps
    cluster = _cluster_for(b, n, cap, read, sms)
    rows = -(-n // cluster)
    res_rows = min(rows, cap) if keep else 0
    return BwdPlan("resident" if res_rows == rows or not keep else
                   "streaming", cluster, rows, res_rows,
                   fixed + res_rows * keep, vec, params)


def bwd_plan_for(x3: torch.Tensor, grad_y: torch.Tensor, use_glu: bool,
                 needs) -> BwdPlan:
    """The plan ``group_norm_backward_cuda`` launches for x3 (B, N, C) and
    its cotangent on their card."""
    b, n, c = x3.shape
    aligned = x3.data_ptr() % 16 == 0 and grad_y.data_ptr() % 16 == 0
    return _bwd_plan(b, n, c, x3.element_size(), use_glu, tuple(needs),
                     _sm_count(x3.device), aligned)


# ctypes types of csrc/groupnorm.cu's objgan_group_norm: x, y, scale, bias;
# dtype, vec, B, N, C, G, cluster, rows, res_rows, ring_rows, bulk, smem;
# eps, use_glu; stream
_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 12
             + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))


# ctypes types of csrc/groupnorm.cu's objgan_group_norm_bwd: x, dy, scale,
# bias, dx, part, dparams; dtype, vec, B, N, C, G, cluster, rows, res_rows,
# smem; eps, use_glu; stream
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 10
                 + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))


# ctypes types of csrc/groupnorm.cu's objgan_group_norm_max_clusters:
# backward, dtype, vec, use_glu, cluster, smem; out
_MAX_CLUSTERS_ARGTYPES = (ctypes.c_int,) * 6 + (ctypes.POINTER(ctypes.c_int),)


def _lib():
    """The kernel library, built, typed and its function attributes set on
    the current device at first use."""
    lib = _build.load("groupnorm")
    fn = lib.objgan_group_norm
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = list(_ARGTYPES)
        lib.objgan_group_norm_bwd.restype = ctypes.c_int
        lib.objgan_group_norm_bwd.argtypes = list(_BWD_ARGTYPES)
        lib.objgan_group_norm_setup.restype = ctypes.c_int
        lib.objgan_group_norm_setup.argtypes = []
        mc = lib.objgan_group_norm_max_clusters
        mc.restype = ctypes.c_int
        mc.argtypes = list(_MAX_CLUSTERS_ARGTYPES)
    return lib


_sm_counts: dict = {}
_ready_devices: set = set()
_schedulable: dict = {}


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def _sm_count(device: torch.device) -> int:
    idx = _device_index(device)
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def _check_plan(lib, idx: int, dtype_code: int, plan,
                use_glu: bool, backward: bool = False) -> None:
    """Sets the function attributes on device ``idx`` once, and raises
    unless the card can hold one cluster of the plan (a ``Plan``, or with
    ``backward`` a ``BwdPlan``; asked once per plan; both happen at a
    shape's first call, outside any CUDA-graph capture)."""
    key = (idx, dtype_code, plan.vec, use_glu, plan.cluster, plan.smem)
    if backward:
        key += ("bwd",)
    if key in _schedulable:
        return
    with torch.cuda.device(idx):
        if idx not in _ready_devices:
            err = lib.objgan_group_norm_setup()
            if err != 0:
                raise RuntimeError(f"groupnorm kernel attributes refused: "
                                   f"cudaError {err}")
            _ready_devices.add(idx)
        out = ctypes.c_int(0)
        err = lib.objgan_group_norm_max_clusters(
            int(backward), dtype_code, plan.vec, int(use_glu), plan.cluster,
            plan.smem, ctypes.byref(out))
    if err != 0 or out.value < 1:
        raise RuntimeError(f"the card cannot run K1's plan {plan}: cudaError "
                           f"{err}, {out.value} clusters fit")
    _schedulable[key] = out.value


def _check_inputs(x3: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  num_groups: int, use_glu: bool) -> None:
    """Raises unless K1 (forward or backward) takes x3 (B, N, C),
    contiguous, bf16 or fp32, on a CUDA device, and fp32 (C,) scale and
    bias on its card."""
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
    if not 1 <= b <= 65535 or n < 1:
        raise ValueError(f"group_norm_cuda takes 1 <= B <= 65535 and N >= 1, "
                         f"got {tuple(x3.shape)}")
    for name, p in (("scale", scale), ("bias", bias)):
        if (p.device != x3.device or p.dtype != torch.float32
                or p.shape != (c,) or not p.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous fp32 ({c},) tensor "
                             f"on {x3.device}")


def group_norm_cuda(x3: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, eps: float, use_glu: bool) -> torch.Tensor:
    """Launch K1 on x3 (B, N, C), contiguous, bf16 or fp32, on a CUDA device:
    one kernel, launched by ``plan_for(x3, use_glu)``. Returns (B, N, C) or
    (B, N, C // 2) with GLU, in x3's dtype."""
    global launches
    _check_inputs(x3, scale, bias, num_groups, use_glu)
    b, n, c = x3.shape
    plan = plan_for(x3, use_glu)
    lib, idx, code = _lib(), _device_index(x3.device), _DTYPE_CODE[x3.dtype]
    _check_plan(lib, idx, code, plan, use_glu)
    y = torch.empty((b, n, c // 2 if use_glu else c), dtype=x3.dtype,
                    device=x3.device)
    # the kernel launches on the current device: make it the tensor's
    with torch.cuda.device(x3.device):
        err = lib.objgan_group_norm(
            x3.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            code, plan.vec, b, n, c, num_groups, plan.cluster, plan.rows,
            plan.res_rows, plan.ring_rows, int(plan.bulk), plan.smem,
            float(eps), int(use_glu),
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


def group_norm_backward_cuda(x3: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, num_groups: int, eps: float,
                             use_glu: bool, grad_y: torch.Tensor,
                             needs=(True, True, True)):
    """K1 backward: (dx, dscale, dbias) of K1 at x3 (B, N, C) for the
    output cotangent ``grad_y`` (B, N, C), or (B, N, C // 2) with GLU, in
    x3's dtype, on x3's card; the arguments are the forward's. One kernel,
    and a second that sums the batch elements' dscale and dbias where
    ``needs`` asks for them; entries whose flag is False are None. dx has
    x3's dtype, dscale and dbias are fp32."""
    global bwd_launches
    _check_inputs(x3, scale, bias, num_groups, use_glu)
    b, n, c = x3.shape
    cd = c // 2 if use_glu else c
    grad_y = grad_y.contiguous()
    if (grad_y.shape != (b, n, cd) or grad_y.dtype != x3.dtype
            or grad_y.device != x3.device):
        raise ValueError(f"the cotangent must be {x3.dtype} {(b, n, cd)} on "
                         f"{x3.device}, got {grad_y.dtype} "
                         f"{tuple(grad_y.shape)} on {grad_y.device}")
    plan = bwd_plan_for(x3, grad_y, use_glu, needs)
    lib, idx, code = _lib(), _device_index(x3.device), _DTYPE_CODE[x3.dtype]
    _check_plan(lib, idx, code, plan, use_glu, backward=True)
    dx = torch.empty_like(x3) if needs[0] else None
    part = dparams = None
    if plan.params:
        part = torch.empty((b, 2 * c), dtype=torch.float32, device=x3.device)
        dparams = torch.empty((2, c), dtype=torch.float32, device=x3.device)
    with torch.cuda.device(x3.device):
        err = lib.objgan_group_norm_bwd(
            x3.data_ptr(), grad_y.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), None if dx is None else dx.data_ptr(),
            None if part is None else part.data_ptr(),
            None if dparams is None else dparams.data_ptr(), code, plan.vec,
            b, n, c, num_groups, plan.cluster, plan.rows, plan.res_rows,
            plan.smem, float(eps), int(use_glu),
            torch.cuda.current_stream(x3.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"groupnorm backward kernel launch failed: "
                           f"cudaError {err}")
    bwd_launches += 1
    return (dx, dparams[0] if needs[1] else None,
            dparams[1] if needs[2] else None)


class GroupNormFunction(torch.autograd.Function):
    """K1 forward and K1 backward on (B, N, C)."""

    @staticmethod
    def forward(ctx, x3, scale, bias, num_groups, eps, use_glu):
        ctx.save_for_backward(x3, scale, bias)
        ctx.args = (num_groups, eps, use_glu)
        return group_norm_cuda(x3, scale, bias, num_groups, eps, use_glu)

    @staticmethod
    def backward(ctx, grad_y):
        x3, scale, bias = ctx.saved_tensors
        grads = group_norm_backward_cuda(
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
