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
