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

Each call is one launch, shaped by a plan that ``fwd_plan`` and
``bwd_plan`` (pure Python, tested on the CPU) pick from the shapes alone:
K2 takes one block per (image, box, channel tile) and runs the separable
passes through shared memory; K3 takes one block per (image, band of
rows, range of columns, channel tile) and owns those df elements.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from objgan_tpu_torch.ops import _build

# Launches of each kernel since the last reset (the twins never count).
launches = {"fwd": 0, "bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The same numbers as csrc/roi_align.cu's kFwdThreads, kBwdThreads,
# kFwdOwn, kBwdOwn and kMaxSmem.
_FWD_THREADS = 128
_BWD_THREADS = 256
_FWD_OWN = 4
_BWD_OWN = 8
_MAX_SMEM = 232448
# Channels of a K3 block's tile: 128 bytes of a bf16 pixel, so that eight
# threads read one pixel's tile in 16-byte vectors.
_TILE_CHANNELS = 64
# The patch of a box's footprint that K2 holds in shared memory at once,
# rows by columns: with t, 39 KB at R = 7 and 64 bf16 channels, so that
# five blocks share an SM and the train step's 640 run in one wave.
_FWD_ROWS = 12
_FWD_CHUNK = 12
# Vectors of K2's channel tile at most; a power of two, so that a thread
# finds its vector and column with a mask and a shift.
_FWD_TILE = 8
# df columns of one K3 block at most: a warp's lanes take them one each.
_BWD_COLUMNS = 32
# K3's shared memory where the boxes allow: half an SM's 228 KB less the
# 1 KB the system keeps per block, so that two blocks share an SM (as its
# registers allow).
_HALF_SMEM = 115712


class FwdPlan(NamedTuple):
    """How one K2 call is launched: grid (B * O, tiles) of _FWD_THREADS;
    a block covers ``tile`` vectors of ``vec`` channels and walks its box's
    footprint in patches of ``rows`` rows by ``chunk`` columns, in
    ``smem`` bytes."""
    vec: int
    tile: int
    rows: int
    chunk: int
    smem: int
    grid: Tuple[int, int]


class BwdPlan(NamedTuple):
    """How one K3 call is launched: grid (tiles, row bands x column ranges,
    B) of _BWD_THREADS; a block owns ``band`` rows, ``cols`` columns and
    ``tile`` vectors of ``vec`` channels of df, and stages g for ``group``
    boxes at a time in ``smem`` bytes."""
    vec: int
    tile: int
    band: int
    cols: int
    group: int
    smem: int
    grid: Tuple[int, int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _vectors(c: int, itemsize: int, aligned: bool) -> Tuple[int, int]:
    """(elements per vector, vectors per pixel): 16-byte vectors where C
    splits into them and the tensors are aligned, else single elements."""
    v = 16 // itemsize
    vec = v if aligned and c % v == 0 else 1
    return vec, c // vec


def fwd_smem_bytes(r: int, q: int, rows: int, chunk: int,
                   tile_channels: int, itemsize: int) -> int:
    """csrc/roi_align.cu's fwd_smem_bytes: t (R, chunk, channels) fp32 and
    the feature patch (rows, chunk, channels) in the I/O dtype, rounded up
    to 16 bytes; the taps of both axes (2 x (2, R, 2q) words) and four
    footprint ends."""
    data = 4 * r * chunk * tile_channels + rows * chunk * tile_channels \
        * itemsize
    return _cdiv(data, 16) * 16 + 4 * (8 * r * q + 4)


def bwd_smem_bytes(o: int, r: int, band: int, cols: int, group: int,
                   tile_channels: int, itemsize: int) -> int:
    """csrc/roi_align.cu's bwd_smem_bytes: staged g (group, R, R, channels)
    in the I/O dtype, rounded up to 16 bytes; A_y and A_x over the block
    (O, R, band + cols) fp32, rows (O, 2) ints, row masks (O, R) and bin
    ranges per column (O, cols, 2 shorts), one word each."""
    staged = _cdiv(group * r * r * tile_channels * itemsize, 16) * 16
    return staged + 4 * (o * r * (band + cols) + 2 * o + o * r + o * cols)


def fwd_plan(b: int, h: int, w: int, c: int, o: int, r: int, q: int,
             itemsize: int, aligned: bool = True) -> FwdPlan:
    """The launch plan of K2 for features (b, h, w, c) of ``itemsize``
    bytes and (b, o) boxes at R = r, q = q. A tile is a power of two of up
    to _FWD_TILE vectors (64 bf16 or 32 fp32 channels, 8 on the scalar
    path), halved while a block's R * R * tile outputs exceed what its
    threads keep in registers; the footprint goes in patches of up to
    _FWD_ROWS x _FWD_CHUNK pixels (at most a column per thread group)."""
    vec, nvec = _vectors(c, itemsize, aligned)
    tile = 1 << (min(nvec, _FWD_TILE).bit_length() - 1)
    while r * r * tile > _FWD_THREADS * _FWD_OWN and tile > 1:
        tile //= 2
    if r * r * tile > _FWD_THREADS * _FWD_OWN:
        raise ValueError(f"R={r} gives K2 more outputs per block than its "
                         f"{_FWD_THREADS} threads hold")
    rows = min(h, _FWD_ROWS)
    chunk = min(w, _FWD_CHUNK, _FWD_THREADS // tile)

    def smem():
        return fwd_smem_bytes(r, q, rows, chunk, tile * vec, itemsize)

    while smem() > _MAX_SMEM and max(rows, chunk) > 1:
        rows, chunk = _cdiv(rows, 2), _cdiv(chunk, 2)
    if smem() > _MAX_SMEM:
        raise ValueError(f"R={r}, q={q} need {smem()} bytes of K2's shared "
                         f"memory, more than {_MAX_SMEM}")
    return FwdPlan(vec, tile, rows, chunk, smem(), (b * o, _cdiv(nvec, tile)))


def bwd_plan(b: int, h: int, w: int, c: int, o: int, r: int, q: int,
             itemsize: int, sms: int = 132, aligned: bool = True) -> BwdPlan:
    """The launch plan of K3 for df (b, h, w, c) of ``itemsize`` bytes and
    (b, o) boxes at R = r (at most 32) on a card with ``sms`` SMs. A thread
    owns one (column, channel vector) of its block at up to _BWD_OWN rows,
    so a block spans up to _BWD_COLUMNS columns of a 64-channel tile
    (narrowed until one row of them is at most _BWD_THREADS vectors) and as
    many rows as its threads then hold (at most 32), balanced over the
    bands and halved while the grid has fewer blocks than the card has SMs.
    g is staged for as many boxes as keep the block within _HALF_SMEM (all
    O at the train step), else for as many as fit at all."""
    if r > 32:
        raise ValueError(f"K3 takes at most 32 bins per axis, got R={r}")
    vec, nvec = _vectors(c, itemsize, aligned)
    tile = min(nvec, max(1, _TILE_CHANNELS // vec))
    cols = min(w, _BWD_COLUMNS)
    while cols * tile > _BWD_THREADS and tile > 1:
        tile = _cdiv(tile, 2)
    while cols * tile > _BWD_THREADS:
        cols = _cdiv(cols, 2)
    band = min(h, 32, _BWD_THREADS // (cols * tile) * _BWD_OWN)
    band = _cdiv(h, _cdiv(h, band))  # the same height for every band

    def blocks(bd):
        return b * _cdiv(h, bd) * _cdiv(w, cols) * _cdiv(nvec, tile)

    while blocks(band) < sms and band > 1:
        band = _cdiv(h, _cdiv(h, _cdiv(band, 2)))
    sizes = [bwd_smem_bytes(o, r, band, cols, g, tile * vec, itemsize)
             for g in range(1, o + 1)]
    fits = [g for g, sz in enumerate(sizes, 1) if sz <= _HALF_SMEM]
    group = fits[-1] if fits else 1
    smem = sizes[group - 1]
    if smem > _MAX_SMEM:
        raise ValueError(f"O={o}, R={r} need {smem} bytes of K3's shared "
                         f"memory, more than {_MAX_SMEM}")
    yx = _cdiv(h, band) * _cdiv(w, cols)
    if yx > 65535 or b > 65535:
        raise ValueError(f"df ({b}, {h}, {w}, {c}) needs more K3 blocks than "
                         f"a grid holds")
    return BwdPlan(vec, tile, band, cols, group, smem,
                   (_cdiv(nvec, tile), yx, b))


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


# ctypes types of csrc/roi_align.cu's entries: (features | g), boxes,
# (out | df); dtype, B, H, W, C, O, R, q, vec, then the plan (tile, rows,
# chunk, smem | tile, band, cols, ucap, smem); stream
_ARGTYPES = {
    "objgan_roi_align_fwd": ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 13
                             + (ctypes.c_void_p,)),
    "objgan_roi_align_bwd": ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 14
                             + (ctypes.c_void_p,)),
}

_ready_devices: set = set()


def _entry(name: str, device: torch.device):
    """The C entry ``name``, typed, with the kernels' shared-memory limit
    raised on ``device`` at its first use there."""
    lib = _build.load("roi_align")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = list(_ARGTYPES[name])
        lib.objgan_roi_align_setup.restype = ctypes.c_int
        lib.objgan_roi_align_setup.argtypes = []
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _ready_devices:
        with torch.cuda.device(idx):
            err = lib.objgan_roi_align_setup()
        if err != 0:
            raise RuntimeError(f"roi_align kernel attributes refused: "
                               f"cudaError {err}")
        _ready_devices.add(idx)
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


_sm_counts: dict = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


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
    plan = fwd_plan(b, h, w, c, o, out_size, sampling_ratio,
                    features.element_size(),
                    features.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    err = _entry("objgan_roi_align_fwd", features.device)(
        features.data_ptr(), boxes.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[features.dtype], b, h, w, c, o, out_size, sampling_ratio,
        plan.vec, plan.tile, plan.rows, plan.chunk, plan.smem,
        torch.cuda.current_stream(features.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"roi_align forward kernel launch failed: "
                           f"cudaError {err} ({plan})")
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
    plan = bwd_plan(b, h, w, c, o, out_size, sampling_ratio, g.element_size(),
                    _sm_count(g.device),
                    g.data_ptr() % 16 == 0 and df.data_ptr() % 16 == 0)
    err = _entry("objgan_roi_align_bwd", g.device)(
        g.data_ptr(), boxes.data_ptr(), df.data_ptr(), _DTYPE_CODE[g.dtype],
        b, h, w, c, o, out_size, sampling_ratio, plan.vec, plan.tile,
        plan.band, plan.cols, plan.group, plan.smem,
        torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"roi_align backward kernel launch failed: "
                           f"cudaError {err} ({plan})")
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
