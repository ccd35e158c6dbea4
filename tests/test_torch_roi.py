"""ROI-align in the port (``objgan_tpu_torch/ops/roi_align.py``): the plain
twins of kernels K2 (forward) and K3 (backward) against the JAX package's
``roi_align_xla``, its Pallas kernels run in interpret mode (as
``tests/test_ops.py`` runs them on the CPU), their VJP, and the numpy
oracle of ``tests/test_ops.py``; and the CPU dispatch of ``roi_align``.

It also checks the pure-Python launch plans of K2 and K3
(``fwd_plan``, ``bwd_plan``) and that they mirror ``csrc/roi_align.cu``.

Tolerances: fp32 atol 1e-5 (the same sums in another order); against the
float64 numpy oracle atol 1e-4, as ``tests/test_ops.py`` holds
``roi_align_xla``; bf16 atol 1e-2 rtol 1e-2 (fp32 sums, one rounding to
bf16 on each side)."""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_ops as jax_op_tests
from objgan_tpu.ops import roi_align as jra
from objgan_tpu_torch.ops import roi_align as tra
from tests.torch_parity import n, t

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


def _case(b, h, w, c, o, seed=0):
    """Features and boxes made with numpy: one full-frame box, one padded
    (all-zero) box, the rest random."""
    r = np.random.default_rng(seed)
    f = r.normal(size=(b, h, w, c)).astype(np.float32)
    xy = r.uniform(0.0, 0.7, (b, o, 2))
    wh = r.uniform(0.05, 0.35, (b, o, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    boxes[0, 0] = [0.0, 0.0, 1.0, 1.0]
    boxes[:, -1] = 0.0
    return f, boxes


@pytest.mark.parametrize("shape,out_size,q", [
    ((2, 16, 12, 5, 4), 7, 2),
    ((2, 8, 8, 32, 3), 4, 2),     # the tiny config's object D
    ((1, 9, 7, 3, 5), 3, 3),
    ((2, 32, 32, 16, 10), 7, 2),  # production geometry, narrow C
])
def test_twin_matches_xla(shape, out_size, q):
    f, boxes = _case(*shape)
    want = jra.roi_align_xla(jnp.asarray(f), jnp.asarray(boxes), out_size, q)
    got = tra.roi_align_reference(t(f), t(boxes), out_size, q)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), **TOL)


@pytest.mark.parametrize("out_size,q", [(7, 2), (4, 1)])
def test_twin_matches_numpy_oracle(out_size, q):
    f, boxes = _case(2, 16, 12, 5, 4, seed=1)
    oracle = jax_op_tests.TestRoiAlign()._numpy_reference(f, boxes, out_size,
                                                          q)
    got = tra.roi_align_reference(t(f), t(boxes), out_size, q)
    np.testing.assert_allclose(n(got), oracle, atol=1e-4)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jra, "INTERPRET", True)


def test_twin_matches_pallas_forward_interpret(interpret):
    f, boxes = _case(2, 8, 8, 128, 3, seed=2)
    want = jra.roi_align_pallas(jnp.asarray(f), jnp.asarray(boxes), 4, 2)
    got = tra.roi_align(t(f), t(boxes), 4, 2)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def _vjp(fn, f, boxes, g, out_size=4):
    _, pull = jax.vjp(lambda x: fn(x, jnp.asarray(boxes), out_size, 2),
                      jnp.asarray(f))
    return pull(jnp.asarray(g))[0]


def test_backward_twin_matches_pallas_vjp_interpret(interpret):
    f, boxes = _case(2, 8, 8, 128, 3, seed=3)
    g = np.random.default_rng(4).normal(size=(2, 3, 4, 4, 128)).astype(
        np.float32)
    want = _vjp(jra.roi_align_pallas, f, boxes, g)
    got = tra.roi_align_backward_reference(t(boxes), t(g), f.shape,
                                           torch.float32, 4, 2)
    np.testing.assert_allclose(n(got), n(want), **TOL)


@pytest.mark.parametrize("shape", [(2, 8, 8, 32, 3), (2, 16, 12, 5, 6)])
def test_backward_twin_matches_xla_vjp_and_autograd(shape):
    """K3's twin is the VJP of the forward twin: against ``jax.vjp`` of
    ``roi_align_xla`` and against autograd through the forward twin."""
    f, boxes = _case(*shape, seed=5)
    b, _, _, c, o = shape
    g = np.random.default_rng(6).normal(size=(b, o, 4, 4, c)).astype(
        np.float32)
    want = _vjp(jra.roi_align_xla, f, boxes, g)
    got = tra.roi_align_backward_reference(t(boxes), t(g), f.shape,
                                           torch.float32, 4, 2)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    leaf = t(f).requires_grad_()
    bx = t(boxes).requires_grad_()
    (auto,) = torch.autograd.grad(tra.roi_align(leaf, bx, 4, 2), leaf, t(g))
    np.testing.assert_allclose(n(auto), n(got), **TOL)


def test_backward_bf16_accumulates_in_fp32(interpret):
    """Ten boxes over one region add into the same pixels: the twin sums
    in fp32 and rounds to bf16 once, like the Pallas backward."""
    r = np.random.default_rng(7)
    f = r.normal(size=(1, 8, 8, 128)).astype(np.float32)
    boxes = np.tile(np.array([[[0.1, 0.1, 0.8, 0.8]]], np.float32),
                    (1, 10, 1))
    g = r.normal(size=(1, 10, 4, 4, 128)).astype(np.float32)
    g16 = jnp.asarray(g, jnp.bfloat16)
    want = _vjp(jra.roi_align_pallas, jnp.asarray(f, jnp.bfloat16), boxes,
                g16)
    got = tra.roi_align_backward_reference(t(boxes), t(n(g16)).bfloat16(),
                                           f.shape, torch.bfloat16, 4, 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(n(got), n(want), **BF16_TOL)


def test_bf16_forward_matches_xla():
    f, boxes = _case(2, 8, 8, 32, 3, seed=8)
    f16 = jnp.asarray(f, jnp.bfloat16)
    want = jra.roi_align_xla(f16, jnp.asarray(boxes), 4, 2)
    got = tra.roi_align(t(n(f16)).bfloat16(), t(boxes), 4, 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(n(got), n(want), **BF16_TOL)


def test_zero_box_gives_top_left_pixel():
    f = np.random.default_rng(9).normal(size=(2, 8, 8, 3)).astype(np.float32)
    out = tra.roi_align(t(f), torch.zeros(2, 1, 4), 4, 2)
    want = np.broadcast_to(f[:, None, None, None, 0, 0], (2, 1, 4, 4, 3))
    np.testing.assert_array_equal(n(out), want)
    jax_out = jra.roi_align_xla(jnp.asarray(f), jnp.zeros((2, 1, 4)), 4, 2)
    np.testing.assert_array_equal(n(out), n(jax_out))


def test_cpu_dispatch_runs_twin_and_kernels_refuse_cpu():
    f, boxes = _case(1, 8, 8, 16, 2)
    before = dict(tra.launches)
    out = tra.roi_align(t(f), t(boxes), 4, 2)
    assert tra.launches == before  # the twin counts no launch
    assert out.shape == (1, 2, 4, 4, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tra.roi_align_cuda(t(f), t(boxes), 4, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tra.roi_align_backward_cuda(t(boxes), out, f.shape, 4, 2)


def _adversarial_boxes():
    """(2, 10, 4) boxes at the edges of K2's and K3's designs. Image 0:
    the full frame; a zero (padded) box; a sub-pixel box whose samples all
    fall in one pixel pair; boxes ending on the frame (x0 + w = 1,
    y0 + h = 1); boxes reaching past it, so that samples fall outside
    [-1, n]; coordinates on multiples of 1/32; a box wider than the frame.
    Image 1: all ten objects on one band of eight rows (of 32)."""
    first = [[0.0, 0.0, 1.0, 1.0],
             [0.0, 0.0, 0.0, 0.0],
             [0.5 + 0.1 / 32, 0.3 + 0.2 / 32, 0.2 / 32, 0.3 / 32],
             [0.75, 0.5, 0.25, 0.5],
             [0.8, -0.3, 0.6, 0.5],
             [-0.2, 0.9, 0.4, 0.6],
             [3 / 32, 5 / 32, 7 / 32, 9 / 32],
             [0.25, 13 / 32, 17 / 32, 1 / 32],
             [-0.5, -0.5, 2.0, 2.0],
             [0.0, 0.0, 0.0, 0.0]]
    band = [[0.08 * k, 8 / 32 + k / 320, 0.05 + 0.02 * k, 0.2]
            for k in range(10)]
    return np.array([first, band], np.float32)


ADV_SHAPE = (2, 32, 32, 128)  # (B, H, W, C): the train step's geometry


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_adversarial_boxes_forward(interpret, dtype, reference):
    """The forward twin on the adversarial boxes against ``roi_align_xla``
    and the Pallas forward in interpret mode: fp32 atol 1e-5, bf16 atol and
    rtol 1e-2."""
    f = np.random.default_rng(11).normal(size=ADV_SHAPE).astype(np.float32)
    boxes = _adversarial_boxes()
    fj = jnp.asarray(f, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    fn = jra.roi_align_xla if reference == "xla" else jra.roi_align_pallas
    want = fn(fj, jnp.asarray(boxes), 7, 2)
    ft = t(n(fj.astype(jnp.float32)))
    got = tra.roi_align_reference(
        ft.bfloat16() if dtype == "bfloat16" else ft, t(boxes), 7, 2)
    assert got.shape == (2, 10, 7, 7, 128)
    np.testing.assert_allclose(n(got.float()), n(want.astype(jnp.float32)),
                               **(BF16_TOL if dtype == "bfloat16" else TOL))
    # padded boxes return the top-left pixel
    np.testing.assert_array_equal(
        n(got[0, 1].float()),
        np.broadcast_to(n(ft[0, 0, 0].to(got.dtype).float()), (7, 7, 128)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_adversarial_boxes_backward(interpret, dtype, reference):
    """The backward twin on the adversarial boxes against the VJP of
    ``roi_align_xla`` and of the Pallas kernels (its backward kernel) in
    interpret mode: fp32 atol 1e-5, bf16 atol and rtol 1e-2."""
    r = np.random.default_rng(12)
    f = r.normal(size=ADV_SHAPE).astype(np.float32)
    g = r.normal(size=(2, 10, 7, 7, 128)).astype(np.float32)
    boxes = _adversarial_boxes()
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    fn = jra.roi_align_xla if reference == "xla" else jra.roi_align_pallas
    _, pull = jax.vjp(lambda x: fn(x, jnp.asarray(boxes), 7, 2),
                      jnp.asarray(f, jdt))
    gj = jnp.asarray(g, jdt)
    want = pull(gj)[0]
    gt = t(n(gj.astype(jnp.float32)))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got = tra.roi_align_backward_reference(t(boxes), gt.to(tdt), f.shape,
                                           tdt, 7, 2)
    assert got.dtype == tdt and got.shape == f.shape
    np.testing.assert_allclose(n(got.float()), n(want.astype(jnp.float32)),
                               **(BF16_TOL if dtype == "bfloat16" else TOL))


CU = Path(tra.__file__).resolve().parents[1] / "csrc" / "roi_align.cu"
# Shared memory of an H100 SM, and what the system keeps per block.
SM_SMEM, BLOCK_RESERVED = 233472, 1024
TRAIN = (16, 32, 32, 256, 10, 7, 2)  # (B, H, W, C, O, R, q) of a train step

# (B, H, W, C, O, R, q, itemsize): the train step in bf16 and fp32, the
# tiny config's object D, odd channel counts (scalar path), a wide frame
# (W = 256, which the previous K3 refused), a tall one, more bins, q = 3
PLAN_SHAPES = [
    (*TRAIN, 2), (*TRAIN, 4),
    (2, 8, 8, 32, 3, 4, 2, 4), (3, 9, 7, 5, 4, 3, 3, 4),
    (2, 8, 8, 12, 3, 4, 2, 2), (1, 8, 256, 8, 10, 7, 2, 4),
    (2, 300, 20, 64, 6, 7, 2, 2), (4, 64, 64, 96, 20, 14, 2, 2),
    (2, 64, 8, 16, 3, 22, 1, 4),
    (1, 16, 16, 1, 1, 1, 1, 4),
]


def _channels(vec, tile, c, t):
    """Channels [lo, hi) of tile ``t``."""
    return t * tile * vec, min(c, (t + 1) * tile * vec)


@pytest.mark.parametrize("b,h,w,c,o,r,q,itemsize", PLAN_SHAPES)
def test_fwd_plan_covers_every_output_once(b, h, w, c, o, r, q, itemsize):
    """K2's blocks (box, tile) own every (b, o, channel) of the output once;
    a block's outputs fit its threads' registers, its shared memory is the
    source's formula and within the card's."""
    p = tra.fwd_plan(b, h, w, c, o, r, q, itemsize)
    assert c % p.vec == 0 and p.vec in (1, 16 // itemsize)
    boxes, tiles = p.grid
    assert boxes == b * o
    seen = np.zeros(c, int)
    for t_ in range(tiles):
        lo, hi = _channels(p.vec, p.tile, c, t_)
        assert lo < hi
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert r * r * p.tile <= tra._FWD_THREADS * tra._FWD_OWN
    assert p.tile & (p.tile - 1) == 0 and p.tile <= tra._FWD_TILE
    assert 1 <= p.chunk <= w and 1 <= p.rows <= h
    assert p.chunk * p.tile <= tra._FWD_THREADS
    assert p.smem == tra.fwd_smem_bytes(r, q, p.rows, p.chunk,
                                        p.tile * p.vec, itemsize)
    assert p.smem <= tra._MAX_SMEM


@pytest.mark.parametrize("b,h,w,c,o,r,q,itemsize", PLAN_SHAPES)
def test_bwd_plan_covers_every_output_once(b, h, w, c, o, r, q, itemsize):
    """K3's blocks (tile, band x column range, image) own every df element
    once, so that no two blocks write one element; a block's elements fit
    its threads' registers (a thread owns one column and channel vector at
    up to _BWD_OWN rows); g is staged in whole groups of boxes; its shared
    memory is the source's formula and within the card's."""
    p = tra.bwd_plan(b, h, w, c, o, r, q, itemsize)
    tiles, yx, images = p.grid
    assert images == b and 1 <= p.band <= h and 1 <= p.cols <= w
    ncb = -(-w // p.cols)
    assert yx == -(-h // p.band) * ncb
    seen = np.zeros((h, w, c), int)
    for t_ in range(tiles):
        lo, hi = _channels(p.vec, p.tile, c, t_)
        for blk in range(yx):
            y0, x0 = blk // ncb * p.band, blk % ncb * p.cols
            seen[y0:y0 + p.band, x0:x0 + p.cols, lo:hi] += 1
    assert (seen == 1).all()
    assert p.cols * p.tile <= tra._BWD_THREADS
    assert p.band <= tra._BWD_THREADS // (p.cols * p.tile) * tra._BWD_OWN
    assert 1 <= p.group <= o and p.band <= 32
    assert p.smem == tra.bwd_smem_bytes(o, r, p.band, p.cols, p.group,
                                        p.tile * p.vec, itemsize)
    assert p.smem <= tra._MAX_SMEM


def test_plans_run_the_train_step_in_one_wave():
    """At the train step's shape (bf16) each kernel's grid fits the card at
    once: K2's 640 blocks of 128 threads at the blocks per SM that its
    shared memory allows (at most 16 by threads), K3's 256 blocks at the
    two per SM that its launch bounds and shared memory allow, with g of
    all ten boxes staged at once."""
    sms = 132
    f = tra.fwd_plan(*TRAIN, 2)
    assert f.grid == (160, 4) and f.tile * f.vec == 64 and f.tile == 8
    per_sm = min(2048 // tra._FWD_THREADS,
                 SM_SMEM // (f.smem + BLOCK_RESERVED))
    assert f.grid[0] * f.grid[1] <= per_sm * sms
    bw = tra.bwd_plan(*TRAIN, 2, sms=sms)
    assert bw.grid == (4, 4, 16) and (bw.band, bw.cols) == (8, 32)
    assert bw.group == 10 and bw.smem + BLOCK_RESERVED <= SM_SMEM // 2
    assert bw.grid[0] * bw.grid[1] * bw.grid[2] <= 2 * sms


def test_bwd_plan_fills_the_card_before_it_widens_bands():
    """A small df takes one-row bands while the grid has fewer blocks than
    the card has SMs."""
    assert tra.bwd_plan(1, 8, 256, 8, 10, 7, 2, 4).band == 1
    assert tra.bwd_plan(16, 32, 32, 256, 10, 7, 2, 2, sms=8).band == 8


def test_vector_width_follows_alignment():
    assert tra.fwd_plan(*TRAIN, 2).vec == 8
    assert tra.fwd_plan(*TRAIN, 2, aligned=False).vec == 1
    assert tra.bwd_plan(*TRAIN, 4, aligned=False).vec == 1
    assert tra.bwd_plan(2, 8, 8, 6, 3, 4, 2, 4).vec == 1  # C % 4 != 0


def test_plans_refuse_what_does_not_fit():
    """A clear error where no tile fits: more bins than K2's threads hold,
    or more boxes than K3's shared memory holds tables for."""
    with pytest.raises(ValueError, match="threads hold"):
        tra.fwd_plan(1, 64, 64, 8, 1, 40, 2, 4)
    with pytest.raises(ValueError, match="shared memory"):
        tra.bwd_plan(1, 32, 32, 8, 3000, 7, 2, 4)
    with pytest.raises(ValueError, match="32 bins"):
        tra.bwd_plan(1, 64, 64, 8, 2, 33, 2, 4)


@pytest.mark.parametrize("entry", sorted(tra._ARGTYPES))
def test_argtypes_match_the_c_signature(entry):
    """The wrapper's ctypes types follow the C entry's parameters: c_void_p
    for every pointer and the stream, c_int for an int."""
    sig = re.search(rf"int {entry}\((.*?)\)\s*\{{", CU.read_text(), re.S)
    params = [p.strip() for p in sig.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert list(tra._ARGTYPES[entry]) == want


def test_plan_constants_and_smem_match_the_kernel_source():
    """The plans' constants and shared-memory formulas are the source's."""
    src = CU.read_text()
    for name, value in (("kFwdThreads", tra._FWD_THREADS),
                        ("kBwdThreads", tra._BWD_THREADS),
                        ("kFwdOwn", tra._FWD_OWN), ("kBwdOwn", tra._BWD_OWN),
                        ("kMaxSmem", tra._MAX_SMEM)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert ("align16(4 * (size_t)R * chunk * tile_channels +\n"
            "                 (size_t)rows * chunk * tile_channels * itemsize)"
            in src)
    assert "4 * (8 * (size_t)R * q + 4);" in src
    assert ("align16((size_t)group * R * R * tile_channels * itemsize) +\n"
            "         4 * ((size_t)O * R * (band + cols) + 2 * (size_t)O +\n"
            "              (size_t)O * R + (size_t)O * cols);") in src
