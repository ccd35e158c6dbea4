"""ROI-align in the port (``objgan_tpu_torch/ops/roi_align.py``): the plain
twins of kernels K2 (forward) and K3 (backward) against the JAX package's
``roi_align_xla``, its Pallas kernels run in interpret mode (as
``tests/test_ops.py`` runs them on the CPU), their VJP, and the numpy
oracle of ``tests/test_ops.py``; and the CPU dispatch of ``roi_align``.

Tolerances: fp32 atol 1e-5 (the same sums in another order); against the
float64 numpy oracle atol 1e-4, as ``tests/test_ops.py`` holds
``roi_align_xla``; bf16 atol 1e-2 rtol 1e-2 (fp32 sums, one rounding to
bf16 on each side)."""

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
