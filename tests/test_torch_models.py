"""Parity of the port's models with the JAX package on the same params and
inputs: the DAMSM text encoder, Stage A's sampler, Stage B's generator and
Stage C's GNet (both UP_MODEs), plus the traps the port has to keep (stage
dtypes, InitStageG's flat GroupNorm grouping).

Tolerances: modules fp32 atol 1e-5 rtol 1e-5; the conv stacks (GNet
images, Stage B's U-Net logits) fp32 atol 1e-4, since many convs deep the
summation order shows; GNet at bf16 atol 5e-2 as set out in
``torch_parity.assert_bf16_images_close`` (the frameworks round bf16 at
different points); labels and obj_valid exact."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objgan_tpu.models.box_generator import BoxGenerator as JBoxGenerator
from objgan_tpu.models.damsm import build_text_encoder as j_text_encoder
from objgan_tpu.models.generator import GNet as JGNet
from objgan_tpu.models.shape_generator import ShapeGenerator as JShapeGen
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.models.box_generator import BoxGenerator
from objgan_tpu_torch.models.damsm import build_text_encoder
from objgan_tpu_torch.models.generator import GNet, FlatGroupNorm
from objgan_tpu_torch.models.shape_generator import ShapeGenerator
from tests.torch_parity import (assert_bf16_images_close, example_batch, n,
                                 t, tiny)

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def cfg():
    return tiny("float32")


def _layout(cfg, seed=0, b=2):
    r = np.random.default_rng(seed)
    o, s = cfg.OBJ.MAX_OBJECTS, cfg.OBJ.SHAPE_SIZE
    xy = r.uniform(0, 0.6, (b, o, 2))
    wh = r.uniform(0.15, 0.4, (b, o, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    valid = np.array([[1, 1, 0], [1, 0, 0]], np.float32)[:b, :o]
    labels = (r.integers(1, cfg.OBJ.NUM_CLASSES, (b, o)) * valid).astype(
        np.int32)
    shapes = r.uniform(0, 1, (b, o, s, s)).astype(np.float32)
    return labels, boxes, valid, shapes


def test_text_encoder(cfg):
    caps, lens = example_batch(cfg)
    jm = j_text_encoder(cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(caps),
                     jnp.asarray(lens))
    w_words, w_sent = jm.apply(params, jnp.asarray(caps), jnp.asarray(lens))
    tm = build_text_encoder(cfg)
    bridge.load_jax_params(tm, jax.device_get(params))
    g_words, g_sent = tm(t(caps), t(lens))
    np.testing.assert_allclose(n(g_words), n(w_words), **TOL)
    np.testing.assert_allclose(n(g_sent), n(w_sent), **TOL)


def test_shape_generator(cfg):
    labels, boxes, valid, _ = _layout(cfg, 1)
    lab_emb = np.random.default_rng(2).normal(
        size=(*labels.shape, cfg.OBJ.LABEL_DIM)).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    jm = JShapeGen(cfg)
    args = (jnp.asarray(boxes), jnp.asarray(lab_emb), jnp.asarray(valid))
    params = jm.init(jax.random.PRNGKey(0), *args, rng)
    want = jm.apply(params, *args, rng)
    z = jax.random.normal(rng, (*labels.shape, 1, 1, cfg.SHAPE.GF_DIM))
    tm = ShapeGenerator(cfg)
    bridge.load_jax_params(tm, jax.device_get(params))
    got = tm(t(boxes), t(lab_emb), t(valid), t(z))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), atol=1e-4)


def test_box_generator_sample(cfg):
    caps, lens = example_batch(cfg, batch=4, seed=3)
    jm = JBoxGenerator(cfg)
    b, o = 4, cfg.OBJ.MAX_OBJECTS
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(caps),
                     jnp.asarray(lens), jnp.zeros((b, o), jnp.int32),
                     jnp.zeros((b, o, 4)), jnp.zeros((b, o)))
    rng = jax.random.PRNGKey(7)
    want = jm.apply(params, jnp.asarray(caps), jnp.asarray(lens), rng,
                    method=JBoxGenerator.sample)
    lg, cg, bn = [], [], []
    for step in jax.random.split(rng, cfg.BOX.MAX_SEQ_LENGTH):
        k1, k2 = jax.random.split(step)
        lg.append(jax.random.gumbel(k1, (b, cfg.OBJ.NUM_CLASSES)))
        k_rng, g_rng = jax.random.split(k2)
        cg.append(jax.random.gumbel(k_rng, (b, cfg.OBJ.GMM_COMPONENTS)))
        bn.append(jax.random.normal(g_rng, (b, 4)))
    tm = BoxGenerator(cfg)
    bridge.load_jax_params(tm, jax.device_get(params))
    got = tm.sample(t(caps), t(lens), t(jnp.stack(lg)), t(jnp.stack(cg)),
                    t(jnp.stack(bn)))
    np.testing.assert_array_equal(n(got["labels"]), n(want["labels"]))
    np.testing.assert_array_equal(n(got["obj_valid"]), n(want["obj_valid"]))
    np.testing.assert_allclose(n(got["boxes"]), n(want["boxes"]), **TOL)
    assert n(got["obj_valid"]).sum() > 0


def _gnet_case(cfg, params=None, seed=0):
    b = 2
    caps, lens = example_batch(cfg, b, seed)
    labels, boxes, valid, shapes = _layout(cfg, seed + 1, b)
    r = np.random.default_rng(seed + 2)
    tw, d = cfg.TEXT.WORDS_NUM, cfg.TEXT.EMBEDDING_DIM
    words = r.normal(size=(b, tw, d)).astype(np.float32)
    sent = r.normal(size=(b, d)).astype(np.float32)
    mask = np.arange(tw)[None] >= lens[:, None]
    lab_emb = r.normal(size=(b, labels.shape[1],
                             cfg.OBJ.LABEL_DIM)).astype(np.float32) * 0.3
    z = r.normal(size=(b, cfg.GAN.Z_DIM)).astype(np.float32)
    rng = jax.random.PRNGKey(seed + 3)
    args = [jnp.asarray(a) for a in (z, sent, words, mask, lab_emb, boxes,
                                     shapes, valid)]
    jm = JGNet(cfg)
    if params is None:
        params = jax.device_get(jm.init({"params": jax.random.PRNGKey(9)},
                                        *args, rng))
    want = jm.apply(params, *args, rng)
    eps = jax.random.normal(rng, (b, cfg.GAN.CONDITION_DIM), jnp.float32)
    tm = GNet(cfg)
    bridge.load_jax_params(tm, params)
    with torch.no_grad():
        got = tm(t(z), t(sent), t(words), t(mask), t(lab_emb), t(boxes),
                 t(shapes), t(valid), t(eps))
    return params, got, want


@pytest.fixture(scope="module")
def gnet_params(cfg):
    params, got, want = _gnet_case(cfg)
    return params, got, want


def test_gnet_fp32(gnet_params):
    _, got, want = gnet_params
    assert len(got["images"]) == 3
    for g, w in zip(got["images"], want["images"]):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(n(g), n(w), atol=1e-4)
    for key in ("grid_attn", "obj_attn"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(n(g), n(w), atol=1e-4)
    np.testing.assert_allclose(n(got["mu"]), n(want["mu"]), **TOL)


def test_gnet_bf16(gnet_params):
    """cfg.DTYPE bfloat16: same params, GNet computes in bf16."""
    params, _, want32 = gnet_params
    cfg16 = tiny("bfloat16")
    _, got, want = _gnet_case(cfg16, params)
    assert GNet(cfg16).dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got["images"])  # tanh head
    assert_bf16_images_close(got["images"], want["images"],
                             want32["images"])
    for g, w in zip(got["obj_attn"], want["obj_attn"]):
        assert g.dtype == torch.float32  # maps stay fp32
        np.testing.assert_allclose(n(g), n(w), atol=5e-2)


def test_gnet_subpixel_and_compute_paste():
    cfg = tiny("float32", GAN={"UP_MODE": "subpixel",
                               "OBJ_PASTE_DTYPE": "compute"})
    _, got, want = _gnet_case(cfg, seed=4)
    for g, w in zip(got["images"], want["images"]):
        np.testing.assert_allclose(n(g), n(w), atol=1e-4)


def test_init_stage_flat_groupnorm_grouping():
    """InitStageG normalises the flat (B, 4*4*2ngf) fc output with
    GroupNorm(32) over consecutive features (NHWC flatten order); grouping
    after an NCHW reshape would put other channels in each group."""
    r = np.random.default_rng(6)
    f = 4 * 4 * 8
    x = (r.normal(size=(3, f)) * np.linspace(0.1, 3, f)).astype(np.float32)
    scale = r.uniform(0.5, 1.5, f).astype(np.float32)
    bias = r.normal(size=f).astype(np.float32)
    jm = fnn.GroupNorm(num_groups=32)
    want = jm.apply({"params": {"scale": scale, "bias": bias}},
                    jnp.asarray(x))
    tm = FlatGroupNorm(f, 32, torch.float32)
    bridge.load_jax_params(tm, {"scale": scale, "bias": bias})
    np.testing.assert_allclose(n(tm(t(x))), n(want), **TOL)
    # the trap: grouping the NCHW-transposed features gives other numbers
    nchw = t(x).reshape(3, 4, 4, 8).permute(0, 3, 1, 2).reshape(3, f)
    wrong = tm(nchw).reshape(3, 8, 4, 4).permute(0, 2, 3, 1).reshape(3, f)
    assert np.abs(n(wrong) - n(want)).max() > 1e-2


def test_stage_dtypes_stay_fp32_under_bf16_config():
    """Only GNet follows cfg.DTYPE; the text encoder, Stage A and Stage B
    run fp32 through their module defaults."""
    cfg16 = tiny("bfloat16")
    caps, lens = example_batch(cfg16)
    words, sent = build_text_encoder(cfg16)(t(caps), t(lens))
    assert words.dtype == sent.dtype == torch.float32
    tm = ShapeGenerator(cfg16)
    b, o = 2, cfg16.OBJ.MAX_OBJECTS
    for p in tm.parameters():
        torch.nn.init.normal_(p, std=0.1)
    logits = tm(torch.rand(b, o, 4) * 0.5, torch.randn(b, o, 16),
                torch.ones(b, o), torch.randn(b, o, 1, 1, 8))
    assert logits.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in GNet(cfg16).parameters())
