"""Parity of the port's recurrences and GMM sampler with the JAX package at
fp32 (atol 1e-5, rtol 1e-5): LSTM cell, bi-LSTM with pack_padded
semantics, bi-conv-LSTM with masked objects, and the mixture box sampler
fed JAX's own random draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objgan_tpu.ops import gmm as jgmm
from objgan_tpu.ops import lstm as jlstm
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.ops import gmm as tgmm
from objgan_tpu_torch.ops import lstm as tlstm
from tests.torch_parity import n, t

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


def _flax(module, *args, seed=0):
    params = module.init(jax.random.PRNGKey(seed), *args)
    return params, module.apply(params, *args)


def test_lstm_cell():
    r = np.random.default_rng(0)
    x = r.normal(size=(3, 7)).astype(np.float32)
    h = r.normal(size=(3, 5)).astype(np.float32)
    c = r.normal(size=(3, 5)).astype(np.float32)
    carry = (jnp.asarray(h), jnp.asarray(c))
    params, ((wh, wc), wy) = _flax(jlstm.LSTMCell(5), carry, jnp.asarray(x))
    # a nonzero bias so the single-bias layout is exercised
    params = jax.tree.map(np.asarray, params)
    params["params"]["b"] = r.normal(size=20).astype(np.float32)
    (wh, wc), wy = jlstm.LSTMCell(5).apply(params, carry, jnp.asarray(x))
    cell = tlstm.LSTMCell(7, 5)
    bridge.load_jax_params(cell, params)
    (gh, gc), gy = cell((t(h), t(c)), t(x))
    for got, want in ((gh, wh), (gc, wc), (gy, wy)):
        np.testing.assert_allclose(n(got), n(want), **TOL)


def test_bilstm_pack_padded():
    r = np.random.default_rng(1)
    xs = r.normal(size=(3, 6, 4)).astype(np.float32)
    lens = np.array([6, 3, 1], np.int32)
    params, (wout, (whf, whb)) = _flax(jlstm.BiLSTM(5), jnp.asarray(xs),
                                       jnp.asarray(lens))
    m = tlstm.BiLSTM(4, 5)
    bridge.load_jax_params(m, jax.device_get(params))
    gout, (ghf, ghb) = m(t(xs), t(lens))
    np.testing.assert_allclose(n(gout), n(wout), **TOL)
    np.testing.assert_allclose(n(ghf), n(whf), **TOL)
    np.testing.assert_allclose(n(ghb), n(whb), **TOL)
    # padded steps are exactly zero in both directions
    assert not n(gout)[1, 3:].any() and not n(gout)[2, 1:].any()


def test_bi_conv_lstm_masked():
    r = np.random.default_rng(2)
    xs = r.normal(size=(2, 4, 4, 4, 3)).astype(np.float32)
    valid = np.array([[1, 1, 0, 1], [1, 0, 0, 0]], np.float32)
    params, want = _flax(jlstm.BiConvLSTM(5), jnp.asarray(xs),
                         jnp.asarray(valid))
    params = jax.tree.map(np.asarray, params)
    # nonzero gate biases: the conv-LSTM keeps its bias
    for d in ("fwd", "bwd"):
        params["params"][d]["cell"]["gates"]["bias"] = r.normal(
            size=20).astype(np.float32)
    want = jlstm.BiConvLSTM(5).apply(params, jnp.asarray(xs),
                                     jnp.asarray(valid))
    m = tlstm.BiConvLSTM(3, 5)
    bridge.load_jax_params(m, params)
    got = m(t(xs), t(valid))
    np.testing.assert_allclose(n(got), n(want), **TOL)


class TestGMM:
    K = 4

    def _params(self, mode, seed):
        size = jgmm.param_size(self.K, mode)
        return np.random.default_rng(seed).normal(size=(5, size)).astype(
            np.float32) * 2.0

    def test_split_params_corr(self):
        p = self._params("corr", 3)
        want = jgmm.split_params_corr(jnp.asarray(p), self.K)
        got = tgmm.split_params_corr(t(p), self.K)
        for g, w in zip(got, want):
            np.testing.assert_allclose(n(g), n(w), **TOL)

    @pytest.mark.parametrize("mode", ["diag", "corr"])
    @pytest.mark.parametrize("temperature", [1.0, 0.4])
    def test_sample_with_replayed_noise(self, mode, temperature):
        p = self._params(mode, 4)
        rng = jax.random.PRNGKey(11)
        want = jgmm.sample(jnp.asarray(p), rng, self.K, temperature,
                           mode=mode)
        # gmm.sample's own draws: split(rng) -> (categorical key, normal key)
        k_rng, g_rng = jax.random.split(rng)
        comp_g = jax.random.gumbel(k_rng, (5, self.K))
        eps = jax.random.normal(g_rng, (5, 4))
        got = tgmm.sample(t(p), t(comp_g), t(eps), self.K, temperature,
                          mode=mode)
        np.testing.assert_allclose(n(got), n(want), **TOL)

    def test_unknown_mode_raises(self):
        with pytest.raises(ValueError, match="unknown GMM mode"):
            tgmm.param_size(4, "full")


def test_categorical_is_argmax_of_logits_plus_gumbel():
    """The identity the noise replay rests on, in JAX alone:
    jax.random.categorical(k, l) == argmax(l + jax.random.gumbel(k, l.shape))
    for the shapes the samplers use."""
    r = np.random.default_rng(12)
    for i, shape in enumerate([(16, 81), (16, 20), (2, 7), (3, 4)]):
        logits = jnp.asarray(r.normal(size=shape).astype(np.float32) * 3)
        k = jax.random.PRNGKey(100 + i)
        want = jax.random.categorical(k, logits)
        got = jnp.argmax(logits + jax.random.gumbel(k, logits.shape), -1)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
