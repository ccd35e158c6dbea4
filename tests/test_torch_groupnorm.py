"""K1's launch plan (``objgan_tpu_torch/ops/groupnorm.py::_plan``), on the
CPU: the pure-Python function that picks, per call shape, the regime
(resident or streaming), the cluster size, the rows per CTA and the dynamic
shared memory of the one kernel launch in ``csrc/groupnorm.cu``. Checked at
every K1 shape of a served batch (``cfg/eval_coco.yml``), of a train step
(``cfg/coco_objgan.yml``) and of a DAMSM pretraining step
(``cfg/damsm_coco.yml``, B = 48), at the odd widths that take the scalar path and
on both sides of the regime threshold. The kernel itself is compared with
its twin on the card (``tests/test_torch_cuda.py``)."""

import ctypes
import re
from pathlib import Path

import pytest

from objgan_tpu_torch.ops import groupnorm as tgn

MAX_SMEM = 232448   # opt-in dynamic shared memory of one sm_90 block
HALF_SMEM = 115712  # the most a CTA takes so that two share an SM
CU = Path(tgn.__file__).resolve().parents[1] / "csrc" / "groupnorm.cu"

# (B, N, C, itemsize, use_glu)
SERVE_SHAPES = [
    (160, 256, 128, 4, False), (160, 64, 256, 4, False),
    (160, 1024, 64, 4, False), (160, 4096, 64, 4, False),
    (16, 1024, 128, 2, False), (16, 256, 256, 2, False),
    (16, 64, 256, 2, False), (16, 16, 256, 2, False),
    (16, 64, 512, 2, True), (16, 256, 256, 2, True),
    (16, 1024, 128, 2, True), (16, 4096, 64, 2, True),
    (16, 4096, 192, 2, True), (16, 4096, 96, 2, False),
    (16, 16384, 64, 2, True), (16, 16384, 192, 2, True),
    (16, 16384, 96, 2, False), (16, 65536, 64, 2, True),
]
TRAIN_SHAPES = [
    # bf16 discriminators (DNet 64/128/256 px, ObjectDNet)
    (16, 16, 512, 2, False), (16, 256, 128, 2, False),
    (16, 1024, 256, 2, False), (16, 256, 512, 2, False),
    (16, 64, 512, 2, False), (16, 4096, 128, 2, False),
    (160, 16, 512, 2, False),
    # fp32 image encoder at B = 16
    (16, 16384, 32, 4, False), (16, 4096, 64, 4, False),
    (16, 1024, 128, 4, False), (16, 256, 256, 4, False),
    (16, 64, 512, 4, False), (16, 16, 512, 4, False),
]
# the fp32 image encoder of a DAMSM pretraining step at B = 48: 8 calls,
# (48, 1024, 128) and (48, 256, 256) twice; C = 32 is one channel per group
DAMSM_SHAPES = [
    (48, 16384, 32, 4, False), (48, 4096, 64, 4, False),
    (48, 1024, 128, 4, False), (48, 256, 256, 4, False),
    (48, 64, 512, 4, False), (48, 16, 512, 4, False),
]
ODD_SHAPES = [(3, 37, 6, 4, False), (2, 100, 12, 2, True)]
# slices at the resident/streaming threshold, just below and just above
THRESHOLD_SHAPES = [
    (2, 9924, 64, 2, True), (2, 9925, 64, 2, True),
    (2, 3408, 96, 4, False), (2, 3409, 96, 4, False),
    (1, 57216, 6, 4, False), (1, 57217, 6, 4, False),
]
ALL_SHAPES = (SERVE_SHAPES + TRAIN_SHAPES + DAMSM_SHAPES + ODD_SHAPES
              + THRESHOLD_SHAPES)


def _fits(n, c, itemsize, vec, cs):
    """The slice fits when each of cs CTAs' rows fits in half an SM's
    shared memory beside the fixed arrays."""
    return (-(-n // cs) * c * itemsize + tgn._fixed_smem(c, vec)
            <= HALF_SMEM)


def _check(plan, b, n, c, itemsize):
    cs, rows = plan.cluster, plan.rows
    # the CTAs' row ranges cover N exactly once, none of them empty
    ranges = [(r * rows, min(n, (r + 1) * rows)) for r in range(cs)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))
    assert all(r1 > r0 for r0, r1 in ranges)
    # a cluster of at most 16 that divides the grid
    assert cs in (1, 2, 4, 8, 12, 16)
    assert plan.grid == (cs, b) and plan.grid[0] % cs == 0
    # the dynamic shared memory holds the fixed arrays, the ring and the
    # resident rows, and two CTAs share an SM
    assert plan.smem <= HALF_SMEM <= MAX_SMEM
    assert plan.smem == (tgn._fixed_smem(c, plan.vec)
                         + c * itemsize * (plan.res_rows + 4 * plan.ring_rows))
    assert 0 <= plan.res_rows <= rows
    assert (plan.regime == "resident") == (plan.res_rows == rows)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("b,n,c,itemsize,use_glu", ALL_SHAPES)
def test_plan(b, n, c, itemsize, use_glu, sms):
    plan = tgn._plan(b, n, c, itemsize, use_glu, sms)
    _check(plan, b, n, c, itemsize)
    # resident exactly when the slice fits in the plan's cluster
    assert (plan.regime == "resident") == _fits(n, c, itemsize, plan.vec,
                                                plan.cluster)
    # and whenever a cluster that runs every batch element in one wave
    # (two CTAs per SM, 7/8 of the SMs) could hold it
    wave = [cs for cs in (1, 2, 4, 8, 12) if b * cs <= 2 * sms * 7 // 8]
    if any(_fits(n, c, itemsize, plan.vec, cs) for cs in wave):
        assert plan.regime == "resident"
    if plan.regime == "streaming":
        # as many rows kept as fit beside the ring
        assert plan.smem + c * itemsize > HALF_SMEM


# (B, N, C, itemsize, use_glu) -> (regime, cluster) on a 132-SM H100: the
# choices that timing every cluster size on the card led to (PERF.md)
SERVED_PLANS = {
    (160, 256, 128, 4, False): ("streaming", 1),
    (160, 4096, 64, 4, False): ("resident", 16),
    (16, 1024, 128, 2, False): ("resident", 4),
    (16, 16, 256, 2, False): ("resident", 1),
    (16, 4096, 96, 2, False): ("resident", 8),
    (16, 4096, 192, 2, True): ("streaming", 12),
    (16, 16384, 96, 2, False): ("streaming", 12),
    (16, 16384, 192, 2, True): ("streaming", 12),
    (16, 65536, 64, 2, True): ("streaming", 12),
}


@pytest.mark.parametrize("shape", SERVED_PLANS)
def test_plan_of_served_shapes(shape):
    """One wave of clusters for every batch element first (clusters of 12
    for B = 16), resident where the slice fits, else streaming; several
    waves of resident clusters of 16 where a CTA would stream more than
    768 KB ((160, 4096, 64) fp32)."""
    plan = tgn._plan(*shape, 132)
    assert (plan.regime, plan.cluster) == SERVED_PLANS[shape]


# a 132-SM H100 holds 231 CTAs of such clusters at once: at B = 48 clusters
# of at most 4 run in one wave, so the three largest slices stream
DAMSM_PLANS = {
    (48, 16384, 32, 4, False): ("streaming", 4, 128),
    (48, 4096, 64, 4, False): ("streaming", 4, 64),
    (48, 1024, 128, 4, False): ("streaming", 4, 0),
    (48, 256, 256, 4, False): ("resident", 4, 0),
    (48, 64, 512, 4, False): ("resident", 4, 0),
    (48, 16, 512, 4, False): ("resident", 1, 0),
}


@pytest.mark.parametrize("shape", DAMSM_PLANS)
def test_plan_of_damsm_shapes(shape):
    """(regime, cluster, ring rows) at each K1 shape of a DAMSM step: one
    wave of 48 clusters, 16-byte vectors (4 fp32, so a vector of the C = 32
    call spans four one-channel groups), each CTA streaming at most
    768 KB, through the ring where it streams more than 96 KB."""
    b, n, c, itemsize, glu = shape
    plan = tgn._plan(*shape, 132)
    assert (plan.regime, plan.cluster, plan.ring_rows) == DAMSM_PLANS[shape]
    assert b * plan.cluster <= tgn._slots(132) and plan.vec == 4
    assert (plan.rows - plan.res_rows) * c * itemsize <= 768 * 1024


def test_plan_picks_every_cluster_size():
    """bf16 (2, N, 256): up to 4 CTAs while each keeps 32 KB, then the
    smallest cluster that holds the slice; 16 only over several waves."""
    got = [tgn._plan(2, n, 256, 2, False, 132).cluster
           for n in (64, 128, 512, 1024, 2048)]
    assert got == [1, 2, 4, 8, 12]
    assert tgn._plan(160, 4096, 64, 4, False, 132).cluster == 16


def test_vector_width():
    assert tgn._plan(16, 64, 512, 2, True, 132).vec == 8
    assert tgn._plan(16, 64, 512, 4, False, 132).vec == 4
    assert tgn._plan(3, 37, 6, 4, False, 132).vec == 1      # C % 4
    assert tgn._plan(2, 100, 12, 2, True, 132).vec == 1     # (C / 2) % 8
    # x not on a 16-byte boundary takes the scalar path
    assert tgn._plan(16, 64, 512, 2, True, 132, aligned=False).vec == 1


def test_plan_refuses_a_channel_count_beyond_shared_memory():
    with pytest.raises(ValueError, match="too wide"):
        tgn._plan(2, 16, 16384, 4, False, 132)


def test_argtypes_match_the_c_signature():
    """The wrapper's ctypes types follow objgan_group_norm's parameters:
    c_void_p for every pointer and the stream, c_int for an int, c_float
    for a float."""
    src = CU.read_text()
    sig = re.search(r"int objgan_group_norm\((.*?)\)\s*\{", src, re.S)
    params = [p.strip() for p in sig.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in p else
            ctypes.c_float if p.startswith("float") else ctypes.c_int
            for p in params]
    assert list(tgn._ARGTYPES) == want


def test_fixed_smem_matches_the_kernel_source():
    """``_fixed_smem`` mirrors the kernel's tile_offset: the constants both
    use are the same numbers."""
    src = CU.read_text()
    for name, value in (("kThreads", tgn._THREADS), ("kChunks", tgn._CHUNKS),
                        ("kStages", tgn._STAGES), ("kMaxSmem", MAX_SMEM),
                        ("kMaxCluster", tgn._MAX_CLUSTER)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "(kChunks + kStages) * 8 + kThreads * V * 4 + 6 * C * 4" in src


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_twin_computes_in_fp32_or_the_inputs_wider_precision(dtype):
    """The twin's arithmetic is fp32 for fp32 and bf16 inputs and fp64 for
    fp64 inputs (the exact reference the card's check holds K1's fp32
    calls against), and its output keeps the input's dtype."""
    import torch

    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(2, 5, 8, generator=g, dtype=torch.float64) * 0.5
         + 6.0).to(dt)
    scale = torch.rand(8, generator=g) + 0.5
    bias = torch.randn(8, generator=g)
    got = tgn.group_norm_reference(x, scale, bias, 4, 1e-6, False)
    assert got.dtype == dt
    ct = torch.float64 if dt == torch.float64 else torch.float32
    xf = x.to(ct).reshape(2, 5, 4, 2)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp(
        min=0.0)
    want = ((xf - mean) * torch.rsqrt(var + 1e-6)).reshape(2, 5, 8) \
        * scale.to(ct) + bias.to(ct)
    assert torch.equal(got, want.to(dt))


# -- K1 backward's plan (``_bwd_plan``) ----------------------------------------

ALL = (True, True, True)
DX = (True, False, False)
# (B, N, C, itemsize, use_glu, needs): the GroupNorm calls of a coco_objgan
# train step at batch 16, 27 distinct (the bf16 G and discriminators want
# every gradient; the frozen fp32 image encoder dx alone; B = 160 is the
# object discriminator's 10 objects per image)
GAN_BWD_SHAPES = [
    (16, 1024, 128, 2, False, ALL), (16, 1024, 256, 2, False, ALL),
    (16, 16, 256, 2, False, ALL), (16, 16, 512, 2, False, ALL),
    (16, 16384, 96, 2, False, ALL), (16, 256, 128, 2, False, ALL),
    (16, 256, 256, 2, False, ALL), (16, 256, 512, 2, False, ALL),
    (16, 4096, 128, 2, False, ALL), (16, 4096, 96, 2, False, ALL),
    (16, 64, 256, 2, False, ALL), (16, 64, 512, 2, False, ALL),
    (160, 16, 512, 2, False, ALL),
    (16, 1024, 128, 2, True, ALL), (16, 16384, 192, 2, True, ALL),
    (16, 16384, 64, 2, True, ALL), (16, 256, 256, 2, True, ALL),
    (16, 4096, 192, 2, True, ALL), (16, 4096, 64, 2, True, ALL),
    (16, 64, 512, 2, True, ALL), (16, 65536, 64, 2, True, ALL),
    (16, 1024, 128, 4, False, DX), (16, 16, 512, 4, False, DX),
    (16, 16384, 32, 4, False, DX), (16, 256, 256, 4, False, DX),
    (16, 4096, 64, 4, False, DX), (16, 64, 512, 4, False, DX),
]
# a DAMSM step (cfg/damsm_coco.yml, B = 48, the image encoder trained) and
# a Stage-B step (cfg/shape_coco.yml, 160 objects, fp32; two of its 11
# calls want dx alone)
DAMSM_BWD_SHAPES = [(b, n, c, 4, False, ALL)
                    for b, n, c, _, _ in DAMSM_SHAPES]
SHAPE_BWD_SHAPES = [
    (160, 1024, 64, 4, False, ALL), (160, 256, 128, 4, False, ALL),
    (160, 256, 128, 4, False, DX), (160, 4096, 64, 4, False, ALL),
    (160, 64, 256, 4, False, ALL), (160, 64, 256, 4, False, DX),
]


def _keep(c, itemsize, use_glu, needs):
    """Bytes a kept row holds: x, and the cotangent where dx is wanted;
    nothing for a call of one pass (no GLU, no dx)."""
    cd = c // 2 if use_glu else c
    if not (use_glu or needs[0]):
        return 0
    return (c + cd * needs[0]) * itemsize


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("b,n,c,itemsize,use_glu,needs",
                         GAN_BWD_SHAPES + DAMSM_BWD_SHAPES + SHAPE_BWD_SHAPES)
def test_bwd_plan(b, n, c, itemsize, use_glu, needs, sms):
    plan = tgn._bwd_plan(b, n, c, itemsize, use_glu, needs, sms)
    cs, rows = plan.cluster, plan.rows
    ranges = [(r * rows, min(n, (r + 1) * rows)) for r in range(cs)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(r1 > r0 for r0, r1 in ranges)
    # every batch element's cluster in one wave, two CTAs per SM
    assert cs in (1, 2, 4, 8, 12)
    assert b * cs <= tgn._slots(sms) or cs == 1
    keep = _keep(c, itemsize, use_glu, needs)
    assert plan.smem == tgn._bwd_fixed_smem(c, plan.vec) + plan.res_rows * keep
    assert plan.smem <= HALF_SMEM
    assert 0 <= plan.res_rows <= rows
    assert plan.params == (needs[1] or needs[2])
    # every byte read once exactly when every row is kept (or one pass)
    assert (plan.regime == "resident") == (plan.res_rows == rows or not keep)
    # resident whenever a cluster of the wave could keep the slice
    cap = (HALF_SMEM - tgn._bwd_fixed_smem(c, plan.vec)) // max(keep, 1)
    wave = [w for w in (1, 2, 4, 8, 12) if b * w <= tgn._slots(sms)]
    if keep and any(-(-n // w) <= cap for w in wave):
        assert plan.regime == "resident"
    if plan.regime == "streaming":
        # as many rows kept as fit
        assert plan.smem + keep > HALF_SMEM
    # 16-byte vectors (8-byte for bf16 under GLU) at every train width
    assert plan.vec == (4 if use_glu or itemsize == 4 else 8)


# (B, N, C, itemsize, use_glu) -> (regime, cluster, kept rows) on a 132-SM
# H100, every gradient wanted
GAN_BWD_PLANS = {
    (16, 65536, 64, 2, True): ("streaming", 12, 560),
    (16, 16384, 192, 2, True): ("streaming", 12, 172),
    (16, 16384, 96, 2, False): ("streaming", 12, 264),
    (16, 4096, 128, 2, False): ("streaming", 12, 194),
    (16, 4096, 64, 2, True): ("resident", 8, 512),
    (16, 1024, 256, 2, False): ("resident", 12, 86),
    (16, 256, 512, 2, False): ("resident", 8, 32),
    (16, 16, 512, 2, False): ("resident", 1, 16),
    (160, 16, 512, 2, False): ("resident", 1, 16),
}


@pytest.mark.parametrize("shape", GAN_BWD_PLANS)
def test_bwd_plan_of_train_shapes(shape):
    plan = tgn._bwd_plan(*shape, ALL, 132)
    assert (plan.regime, plan.cluster, plan.res_rows) == GAN_BWD_PLANS[shape]


def test_bwd_plan_threshold_and_needs():
    """bf16 (2, N, 64): a row keeps x and dy (256 bytes), a CTA 404 rows,
    so clusters of 12 keep N = 4848 and stream at 4849; without dx the
    cotangent is not kept, and without GLU a dx-less call is one pass that
    keeps nothing and reads everything once."""
    assert tgn._bwd_plan(2, 4848, 64, 2, False, ALL, 132)[:4] == (
        "resident", 12, 404, 404)
    assert tgn._bwd_plan(2, 4849, 64, 2, False, ALL, 132).regime \
        == "streaming"
    glu = tgn._bwd_plan(2, 4096, 64, 2, True, (False, True, True), 132)
    assert glu.smem - tgn._bwd_fixed_smem(64, 4) == glu.res_rows * 128
    one = tgn._bwd_plan(2, 65536, 64, 2, False, (False, True, True), 132)
    assert (one.regime, one.res_rows, one.params) == ("resident", 0, True)
    assert not tgn._bwd_plan(2, 64, 64, 2, False, DX, 132).params
    with pytest.raises(ValueError, match="no gradient"):
        tgn._bwd_plan(2, 64, 64, 2, False, (False, False, False), 132)


def test_bwd_vector_width():
    assert tgn._bwd_plan(16, 64, 512, 2, False, ALL, 132).vec == 8
    assert tgn._bwd_plan(16, 64, 512, 2, True, ALL, 132).vec == 4
    assert tgn._bwd_plan(16, 64, 512, 4, True, ALL, 132).vec == 4
    assert tgn._bwd_plan(3, 37, 6, 4, False, ALL, 132).vec == 1     # C % 4
    assert tgn._bwd_plan(2, 100, 12, 2, True, ALL, 132).vec == 1    # C/2 % 4
    assert tgn._bwd_plan(16, 64, 512, 2, True, ALL, 132,
                         aligned=False).vec == 1
    with pytest.raises(ValueError, match="too wide"):
        tgn._bwd_plan(2, 16, 4096, 4, False, ALL, 132)


@pytest.mark.parametrize("entry,argtypes", [
    ("objgan_group_norm_bwd", tgn._BWD_ARGTYPES),
    ("objgan_group_norm_max_clusters", tgn._MAX_CLUSTERS_ARGTYPES),
])
def test_bwd_argtypes_match_the_c_signature(entry, argtypes):
    """The ctypes types of the backward's entry and of the occupancy query
    (forward and backward in one) follow their C parameters: an int
    pointer is POINTER(c_int), any other pointer c_void_p."""
    src = CU.read_text()
    sig = re.search(rf"int {entry}\((.*?)\)\s*\{{", src, re.S)
    params = [p.strip() for p in sig.group(1).split(",")]
    want = [ctypes.POINTER(ctypes.c_int) if p.startswith("int*") else
            ctypes.c_void_p if "*" in p else
            ctypes.c_float if p.startswith("float") else ctypes.c_int
            for p in params]
    assert list(argtypes) == want


def test_bwd_fixed_smem_matches_the_kernel_source():
    """``_bwd_fixed_smem`` mirrors the kernel's bwd_tile_offset, and the
    kernel's names keep K1's forward roofline apart: each holds gn_bwd and
    none gn_fused_kernel."""
    src = CU.read_text()
    assert "const int raw = (kThreads * V + 16 * C) * 4;" in src
    assert tgn._bwd_fixed_smem(64, 8) == -(-(256 * 8 + 16 * 64) * 4
                                           // 128) * 128
    names = set(re.findall(
        r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(", src))
    assert names == {"gn_fused_kernel", "gn_bwd_kernel",
                     "gn_bwd_param_kernel"}


def _pivot_vjp(x, scale, bias, groups, eps, use_glu, gy):
    """The algebra K1 backward implements, in fp64: statistics and the
    cotangent's sums about the pivot k (the group's first value in row 0),
    per batch element, channel sums P = sum dy and Q = sum dy (x - k)."""
    import torch

    b, n, c = x.shape
    cg = c // groups
    m = n * cg
    k = x[:, 0, :].reshape(b, groups, cg)[..., :1].expand(b, groups, cg)
    k = k.reshape(b, 1, c)
    s = (x - k).sum(1).reshape(b, groups, cg).sum(-1)
    s2 = ((x - k) ** 2).sum(1).reshape(b, groups, cg).sum(-1)
    d = s / m
    r = (s2 / m - d * d).clamp(min=0.0).add(eps).rsqrt()
    per_c = lambda t: t.repeat_interleave(cg, dim=1)[:, None, :]  # noqa
    mu, rc, dc = per_c(k[:, 0, ::cg] + d), per_c(r), per_c(d)
    if use_glu:
        a_c = rc * scale
        y = x * a_c + (bias - mu * a_c)
        h = c // 2
        sig = torch.sigmoid(y[..., h:])
        dy = torch.cat([gy * sig, gy * y[..., :h] * sig * (1 - sig)], -1)
    else:
        dy = gy
    p = dy.sum(1)                       # (b, c)
    q = (dy * (x - k)).sum(1)
    dscale = (r.repeat_interleave(cg, 1) * (q - d.repeat_interleave(cg, 1)
                                           * p)).sum(0)
    dbias = p.sum(0)
    sp = (scale * p).reshape(b, groups, cg).sum(-1)
    sq = (scale * (q - d.repeat_interleave(cg, 1) * p)).reshape(
        b, groups, cg).sum(-1)
    beta = per_c(-r ** 3 * sq / m)
    const = per_c(-r * sp / m)
    dx = rc * scale * dy + beta * (x - mu) + const
    return dx, dscale, dbias


@pytest.mark.parametrize("b,n,c,groups,use_glu,offset", [
    (2, 7, 8, 4, False, 0.0), (2, 7, 8, 4, True, 0.0),
    (3, 5, 96, 32, False, 6.0), (3, 5, 96, 32, True, 6.0),
    (2, 9, 32, 32, False, 40.0), (1, 13, 12, 2, True, -3.0),
])
def test_pivot_closed_form_is_the_twins_vjp(b, n, c, groups, use_glu, offset):
    """In fp64 the pivot formulas that csrc/groupnorm.cu's backward
    implements equal ``group_norm_backward_reference`` (autograd through
    the twin) to rounding, GLU included, with one channel or three per
    group and |mean| up to 40 standard deviations from 0."""
    import torch

    g = torch.Generator().manual_seed(b * 1000 + c)
    x = torch.randn(b, n, c, generator=g, dtype=torch.float64) + offset
    scale = torch.rand(c, generator=g, dtype=torch.float64) + 0.5
    bias = torch.randn(c, generator=g, dtype=torch.float64)
    gy = torch.randn(b, n, c // 2 if use_glu else c, generator=g,
                     dtype=torch.float64)
    want = tgn.group_norm_backward_reference(x, scale, bias, groups, 1e-6,
                                             use_glu, gy)
    got = _pivot_vjp(x, scale, bias, groups, 1e-6, use_glu, gy)
    for u, v in zip(got, want):
        assert torch.allclose(u, v, rtol=1e-9, atol=1e-9)


def test_backward_entry_refuses_cpu_tensor():
    import torch

    x = torch.zeros(1, 16, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgn.group_norm_backward_cuda(x, torch.ones(64), torch.zeros(64), 32,
                                     1e-6, False, torch.zeros(1, 16, 64))


def test_cpu_backward_is_autograd_through_the_twin():
    """On the CPU the backward never reaches the kernel (nor counts it):
    autograd through ``group_norm_reference``, equal to the twin's VJP."""
    import torch

    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 4, 4, 64, generator=g, requires_grad=True)
    scale = (torch.rand(64, generator=g) + 0.5).requires_grad_()
    bias = torch.randn(64, generator=g).requires_grad_()
    gy = torch.randn(2, 4, 4, 32, generator=g)
    before = tgn.bwd_launches
    y = tgn.group_norm(x, scale, bias, 32, 1e-6, True)
    got = torch.autograd.grad(y, (x, scale, bias), gy)
    assert tgn.bwd_launches == before
    want = tgn.group_norm_backward_reference(x, scale, bias, 32, 1e-6, True,
                                             gy)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
