"""Parity of the port's ops with the JAX package at fp32: GroupNorm(+GLU)
(the twin of kernel K1 and the VJP that K1's autograd Function uses as its
backward, against the JAX reference and the Pallas kernel in interpret
mode), attention (DAMSM's too, against JAX and ``tests/goldens.npz``),
rasterization and the layout canvas, resizes and SAME padding.

Tolerances: fp32 atol 1e-5, rtol 1e-5 (same math, different summation
order). Where a bf16 path is compared, atol/rtol 2e-2: bf16 keeps 8 bits,
and the two frameworks round at different points."""

import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objgan_tpu.ops import attention as jatt
from objgan_tpu.ops import groupnorm as jgn
from objgan_tpu.ops import rasterize as jras
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.core.layers import Conv
from objgan_tpu_torch.models.common import FusedGroupNorm, gn, gn_glu
from objgan_tpu_torch.models.generator import upsample_nearest2x
from objgan_tpu_torch.ops import attention as tatt
from objgan_tpu_torch.ops import groupnorm as tgn
from objgan_tpu_torch.ops import rasterize as tras
from tests.golden_utils import GOLDEN_PATH
from tests.torch_parity import n, t

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _gn_inputs(shape, seed):
    r = np.random.default_rng(seed)
    c = shape[-1]
    x = r.normal(size=shape).astype(np.float32) * 2.0 + 0.5
    scale = r.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (r.normal(size=c) * 0.2).astype(np.float32)
    return x, scale, bias


class TestGroupNormTwin:
    # channel counts of the served model: cg = C / gcd(C, 32) of 2, 3, 4, 6
    @pytest.mark.parametrize("shape,use_glu", [
        ((2, 8, 8, 64), True),     # cg 2 (UpBlock 64 -> 32)
        ((2, 8, 8, 96), False),    # cg 3 (ResBlock gn 96)
        ((2, 4, 4, 192), True),    # cg 6 (ResBlock gn_glu 192)
        ((3, 4, 4, 128), False),   # cg 4
        ((2, 5, 3, 6), False),     # odd sizes, 2 groups
    ])
    def test_matches_jax_reference_fp32(self, shape, use_glu):
        x, scale, bias = _gn_inputs(shape, 1)
        g = math.gcd(shape[-1], 32)
        want = jgn.group_norm_reference(jnp.asarray(x), scale, bias, g, 1e-6,
                                        use_glu)
        got = tgn.group_norm_reference(t(x), t(scale), t(bias), g, 1e-6,
                                       use_glu)
        np.testing.assert_allclose(n(got), n(want), **TOL)

    @pytest.mark.parametrize("use_glu", [False, True])
    def test_matches_jax_reference_bf16(self, use_glu):
        x, scale, bias = _gn_inputs((2, 8, 8, 64), 2)
        xb = jnp.asarray(x, jnp.bfloat16)
        want = jgn.group_norm_reference(xb, scale, bias, 32, 1e-6, use_glu)
        got = tgn.group_norm_reference(t(x).bfloat16(), t(scale), t(bias), 32,
                                       1e-6, use_glu)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(n(got), n(want), **BF16_TOL)

    @pytest.mark.parametrize("shape,use_glu", [
        ((1, 16, 16, 128), False),
        ((1, 32, 32, 64), True),
    ])
    def test_matches_pallas_kernel_interpret(self, shape, use_glu,
                                             monkeypatch):
        """The TPU kernel run as tests/test_groupnorm.py runs it on CPU."""
        monkeypatch.setattr(jgn, "INTERPRET", True)
        x, scale, bias = _gn_inputs(shape, 3)
        b, c = shape[0], shape[-1]
        want = jgn._pallas_group_norm(jnp.asarray(x).reshape(b, -1, c),
                                      jnp.asarray(scale), jnp.asarray(bias),
                                      32, 1e-6, use_glu)
        got = tgn.group_norm(t(x).reshape(b, -1, c), t(scale), t(bias), 32,
                             1e-6, use_glu)
        np.testing.assert_allclose(n(got), n(want), **TOL)

    @pytest.mark.parametrize("use_glu", [False, True])
    def test_backward_matches_jax_vjp(self, use_glu):
        """``group_norm_backward_reference``, the twin's VJP with the
        statistics recomputed, which K1 backward on the card is held to:
        against ``jax.vjp`` of the JAX reference, as its ``custom_vjp``
        backward computes it."""
        x, scale, bias = _gn_inputs((2, 6, 6, 96), 5)
        c_out = 48 if use_glu else 96
        g = np.random.default_rng(6).normal(size=(2, 6, 6, c_out)).astype(
            np.float32)
        _, pull = jax.vjp(
            lambda a, s, b: jgn.group_norm_reference(a, s, b, 32, 1e-6,
                                                     use_glu),
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
        want = pull(jnp.asarray(g))
        got = tgn.group_norm_backward_reference(t(x), t(scale), t(bias), 32,
                                                1e-6, use_glu, t(g))
        for gv, wv in zip(got, want):
            np.testing.assert_allclose(n(gv), n(wv), atol=1e-4, rtol=1e-5)
        only_dx = tgn.group_norm_backward_reference(
            t(x), t(scale), t(bias), 32, 1e-6, use_glu, t(g),
            needs=(True, False, False))
        assert only_dx[1] is None and only_dx[2] is None
        np.testing.assert_array_equal(n(only_dx[0]), n(got[0]))

    def test_cuda_entry_refuses_cpu_tensor(self):
        x = torch.zeros(1, 16, 64)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tgn.group_norm_cuda(x, torch.ones(64), torch.zeros(64), 32, 1e-6,
                                False)

    def test_cpu_path_does_not_count_launches(self):
        before = tgn.launches
        tgn.group_norm(torch.randn(1, 4, 4, 32), torch.ones(32),
                       torch.zeros(32), 32, 1e-6, False)
        assert tgn.launches == before


class TestFusedGroupNormModule:
    @pytest.mark.parametrize("features,use_glu,dtype", [
        (64, False, None), (96, True, None), (64, True, "bfloat16"),
    ])
    def test_matches_flax_module(self, features, use_glu, dtype):
        from objgan_tpu.models import common as jcommon

        x, scale, bias = _gn_inputs((2, 4, 4, features), 4)
        jdt = jnp.bfloat16 if dtype else None
        mk = jcommon.gn_glu if use_glu else jcommon.gn
        jmod = mk(features, jdt)
        params = {"params": {"scale": scale, "bias": bias}}
        want = jmod.apply(params, jnp.asarray(x))
        tdt = torch.bfloat16 if dtype else None
        tmod = (gn_glu if use_glu else gn)(features, tdt)
        assert tmod.num_groups == math.gcd(features, 32)
        assert tmod.eps == 1e-6
        bridge.load_jax_params(tmod, params)
        got = tmod(t(x))
        # the output dtype is the module's when set (flax parity)
        assert n(got).shape == want.shape
        assert got.dtype == (torch.bfloat16 if dtype else torch.float32)
        assert want.dtype == (jnp.bfloat16 if dtype else jnp.float32)
        np.testing.assert_allclose(n(got), n(want),
                                   **(BF16_TOL if dtype else TOL))

    def test_params_are_fp32(self):
        m = FusedGroupNorm(64, 32, torch.bfloat16)
        assert m.weight.dtype == m.bias.dtype == torch.float32


def _attn_inputs(seed=0, b=2, l=12, tw=5, o=3, c=8):
    r = np.random.default_rng(seed)
    q = r.normal(size=(b, l, c)).astype(np.float32)
    src = r.normal(size=(b, tw, c)).astype(np.float32)
    mask = np.zeros((b, tw), bool)
    mask[1, 3:] = True
    oq = r.normal(size=(b, o, c)).astype(np.float32)
    valid = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
    maps = r.uniform(0, 1, (b, o, l)).astype(np.float32)
    return q, src, mask, oq, valid, maps


class TestAttention:
    def test_masked_softmax(self):
        r = np.random.default_rng(0)
        s = r.normal(size=(2, 3, 5)).astype(np.float32)
        m = r.uniform(size=(2, 3, 5)) > 0.6
        want = jatt.masked_softmax(jnp.asarray(s), jnp.asarray(m), axis=-1)
        got = tatt.masked_softmax(t(s), t(m), dim=-1)
        np.testing.assert_allclose(n(got), n(want), **TOL)

    def test_grid_attention_fp32_context(self):
        q, src, mask, *_ = _attn_inputs()
        wc, wa = jatt.grid_attention(jnp.asarray(q), jnp.asarray(src),
                                     jnp.asarray(mask))
        gc, ga = tatt.grid_attention(t(q), t(src), t(mask))
        assert ga.dtype == torch.float32
        np.testing.assert_allclose(n(ga), n(wa), **TOL)
        np.testing.assert_allclose(n(gc), n(wc), **TOL)

    def test_grid_attention_compute_context(self):
        q, src, mask, *_ = _attn_inputs(1)
        qb = jnp.asarray(q, jnp.bfloat16)
        wc, wa = jatt.grid_attention(qb, jnp.asarray(src), jnp.asarray(mask),
                                     context_dtype=jnp.bfloat16)
        gc, ga = tatt.grid_attention(t(q).bfloat16(), t(src), t(mask),
                                     context_dtype=torch.bfloat16)
        assert gc.dtype == torch.bfloat16 and ga.dtype == torch.float32
        np.testing.assert_allclose(n(ga), n(wa), **TOL)
        np.testing.assert_allclose(n(gc), n(wc), **BF16_TOL)

    def test_object_attention(self):
        _, src, mask, oq, valid, _ = _attn_inputs(2)
        wc, wa = jatt.object_attention(jnp.asarray(oq), jnp.asarray(src),
                                       jnp.asarray(mask), jnp.asarray(valid))
        gc, ga = tatt.object_attention(t(oq), t(src), t(mask), t(valid))
        np.testing.assert_allclose(n(ga), n(wa), **TOL)
        np.testing.assert_allclose(n(gc), n(wc), **TOL)
        assert not n(ga)[0, 2].any()  # padded object: zero attention

    def test_damsm_attention(self):
        q, src, mask, *_ = _attn_inputs(4)
        valid = (~mask).astype(np.float32)
        wc, wa = jatt.damsm_attention(jnp.asarray(src), jnp.asarray(q), 4.0,
                                      jnp.asarray(valid))
        gc, ga = tatt.damsm_attention(t(src), t(q), 4.0, t(valid))
        assert gc.dtype == ga.dtype == torch.float32
        np.testing.assert_allclose(n(ga), n(wa), **TOL)
        np.testing.assert_allclose(n(gc), n(wc), **TOL)

    def test_damsm_attention_goldens(self):
        """The fp32 goldens of ``tests/golden_utils.py`` (its inputs
        remade with the same JAX keys)."""
        goldens = np.load(GOLDEN_PATH)
        ks = jax.random.split(jax.random.PRNGKey(1234), 8)
        q = jax.random.normal(ks[0], (2, 12, 16))
        s = jax.random.normal(ks[1], (2, 7, 16))
        gc, ga = tatt.damsm_attention(t(q), t(s), 4.0)
        np.testing.assert_allclose(n(ga), goldens["damsm_attn"], **TOL)
        np.testing.assert_allclose(n(gc), goldens["damsm_w"], **TOL)

    @pytest.mark.parametrize("ctx", [None, "bfloat16"])
    def test_paste_object_context(self, ctx):
        _, _, _, oq, valid, maps = _attn_inputs(3)
        jdt = jnp.bfloat16 if ctx else None
        tdt = torch.bfloat16 if ctx else None
        want = jatt.paste_object_context(jnp.asarray(oq), jnp.asarray(maps),
                                         jnp.asarray(valid),
                                         context_dtype=jdt)
        got = tatt.paste_object_context(t(oq), t(maps), t(valid),
                                        context_dtype=tdt)
        np.testing.assert_allclose(n(got), n(want),
                                   **(BF16_TOL if ctx else TOL))


class TestRasterize:
    def _boxes(self):
        r = np.random.default_rng(5)
        xy = r.uniform(0, 0.7, (2, 3, 2))
        wh = r.uniform(0.1, 0.4, (2, 3, 2))
        boxes = np.concatenate([xy, wh], -1).astype(np.float32)
        boxes[0, 0] = [0.0, 0.0, 1.0, 1.0]  # full frame: border rows
        boxes[1, 2] = [0.25, 0.5, 0.5, 0.25]  # edges on pixel boundaries
        return boxes

    def test_box_maps_exact(self):
        b = self._boxes()
        want = jras.box_maps(jnp.asarray(b), 16, 12)
        got = tras.box_maps(t(b), 16, 12)
        np.testing.assert_array_equal(n(got), n(want))

    def test_paste_masks(self):
        b = self._boxes()
        m = np.random.default_rng(6).uniform(0, 1, (2, 3, 8, 8)).astype(
            np.float32)
        want = jras.paste_masks(jnp.asarray(m), jnp.asarray(b), 16, 16)
        got = tras.paste_masks(t(m), t(b), 16, 16)
        np.testing.assert_allclose(n(got), n(want), **TOL)


    def test_layout_map(self):
        m = np.random.default_rng(7).uniform(0, 1, (2, 3, 16, 16)).astype(
            np.float32)
        valid = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
        want = jras.layout_map(jnp.asarray(m), jnp.asarray(valid))
        got = tras.layout_map(t(m), t(valid))
        assert got.shape == (2, 16, 16, 1)
        np.testing.assert_array_equal(n(got), n(want))


class TestResizeAndPadding:
    def test_nearest_2x_matches_jax_image_resize(self):
        x = np.random.default_rng(7).normal(size=(2, 5, 6, 3)).astype(
            np.float32)
        want = jax.image.resize(jnp.asarray(x), (2, 10, 12, 3), "nearest")
        got = upsample_nearest2x(t(x))
        np.testing.assert_array_equal(n(got), n(want))

    @pytest.mark.parametrize("factor", [2, 4])
    def test_bilinear_matches_jax_at_borders(self, factor):
        """F.interpolate(align_corners=False) == jax.image.resize bilinear
        for upsampling, border rows and columns included."""
        x = np.random.default_rng(8).uniform(size=(6, 8, 8, 1)).astype(
            np.float32)
        s = 8 * factor
        want = jax.image.resize(jnp.asarray(x), (6, s, s, 1), "bilinear")
        got = torch.nn.functional.interpolate(
            t(x).permute(0, 3, 1, 2), size=(s, s), mode="bilinear",
            align_corners=False).permute(0, 2, 3, 1)
        np.testing.assert_allclose(n(got), n(want), atol=1e-6)
        np.testing.assert_allclose(n(got)[:, [0, -1]], n(want)[:, [0, -1]],
                                   atol=1e-6)

    @pytest.mark.parametrize("kernel,stride,size", [
        ((4, 4), 2, 16), ((3, 3), 1, 8), ((4, 4), 2, 7),
    ])
    def test_same_padding_conv(self, kernel, stride, size):
        """flax padding="SAME": the 4x4 stride-2 convs pad (1, 1)."""
        r = np.random.default_rng(9)
        x = r.normal(size=(2, size, size, 5)).astype(np.float32)
        jmod = nn.Conv(6, kernel, strides=(stride, stride), padding="SAME",
                       use_bias=False)
        params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
        want = jmod.apply(params, jnp.asarray(x))
        tmod = Conv(5, 6, kernel, stride=stride)
        bridge.load_jax_params(tmod, jax.device_get(params))
        got = tmod(t(x))
        np.testing.assert_allclose(n(got), n(want), **TOL)
