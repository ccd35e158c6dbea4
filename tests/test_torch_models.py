"""Parity of the port's models with the JAX package on the same params and
inputs: the DAMSM text and image encoders, Stage A's sampler, Stage B's
generator, Stage C's GNet (both UP_MODEs) and discriminators (``DNet``'s
trunk, heads and whole, ``ObjectDNet``), plus the traps the port has to
keep (stage dtypes, InitStageG's flat GroupNorm grouping).

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
from objgan_tpu.models import discriminator as jdisc
from objgan_tpu.models.damsm import build_image_encoder as j_image_encoder
from objgan_tpu.models.damsm import build_text_encoder as j_text_encoder
from objgan_tpu.models.generator import GNet as JGNet
from objgan_tpu.models.shape_generator import ShapeGenerator as JShapeGen
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.models.box_generator import BoxGenerator
from objgan_tpu_torch.models import discriminator as tdisc
from objgan_tpu_torch.models.damsm import (build_image_encoder,
                                           build_text_encoder)
from objgan_tpu_torch.models.generator import GNet, FlatGroupNorm
from objgan_tpu_torch.models.shape_generator import ShapeGenerator
from tests.torch_parity import (assert_bf16_images_close, example_batch, n,
                                 port_cfg, t, tiny)

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
    tm = build_text_encoder(port_cfg(cfg))
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
    tm = ShapeGenerator(port_cfg(cfg))
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
    tm = BoxGenerator(port_cfg(cfg))
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
    tm = GNet(port_cfg(cfg))
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
    assert GNet(port_cfg(cfg16)).dtype == torch.bfloat16
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
    cfg16 = port_cfg(tiny("bfloat16"))
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


def _images(size, b=2, seed=10):
    return np.random.default_rng(seed).uniform(
        -1, 1, (b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("size", [16, 32, 64, 128])
def test_dnet_trunk_heads_and_whole(cfg, size):
    """Both branches of the trunk (with and without the 3x3 block above
    64 px); the 4x4 stride-1 logit convs pad (1, 2) like flax "SAME"."""
    r = np.random.default_rng(size)
    img = _images(size)
    lay = r.uniform(0, 1, (2, size, size, 1)).astype(np.float32)
    sent = r.normal(size=(2, cfg.TEXT.EMBEDDING_DIM)).astype(np.float32)
    jm = jdisc.DNet(cfg.GAN.DF_DIM, size)
    params = jm.init(jax.random.PRNGKey(size), jnp.asarray(img),
                     jnp.asarray(sent), jnp.asarray(lay))
    w_trunk = jm.apply(params, jnp.asarray(img), jnp.asarray(lay),
                       method="trunk")
    w_heads = jm.apply(params, w_trunk, jnp.asarray(sent), method="heads")
    w_uncond = jm.apply(params, w_trunk, method="heads")
    w_whole = jm.apply(params, jnp.asarray(img), jnp.asarray(sent),
                       jnp.asarray(lay))
    tm = tdisc.DNet(cfg.GAN.DF_DIM, size, cfg.TEXT.EMBEDDING_DIM)
    bridge.load_jax_params(tm, jax.device_get(params))
    g_trunk = tm.trunk(t(img), t(lay))
    assert g_trunk.shape == w_trunk.shape
    np.testing.assert_allclose(n(g_trunk), n(w_trunk), atol=1e-4)
    g_heads = tm.heads(t(w_trunk), t(sent))
    assert set(tm.heads(t(w_trunk))) == set(w_uncond) == {"uncond"}
    g_whole = tm(t(img), t(sent), t(lay))
    for got, want in ((g_heads, w_heads), (g_whole, w_whole)):
        assert set(got) == set(want) == {"uncond", "cond"}
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(n(got[k]), n(want[k]), atol=1e-4)


def _obj_case(cfg, seed=11, b=2):
    labels, boxes, valid, _ = _layout(cfg, seed, b)
    boxes[~valid.astype(bool)] = 0.0  # padded objects carry zero boxes
    lab_emb = np.random.default_rng(seed).normal(
        size=(*labels.shape, cfg.OBJ.LABEL_DIM)).astype(np.float32)
    return _images(cfg.branch_sizes[-1], b, seed), boxes, lab_emb


def test_object_dnet(cfg):
    img, boxes, lab_emb = _obj_case(cfg)
    args = [jnp.asarray(a) for a in (img, boxes, lab_emb)]
    jm = jdisc.ObjectDNet(cfg)
    params = jm.init(jax.random.PRNGKey(3), *args)
    want = jm.apply(params, *args)
    tm = tdisc.ObjectDNet(port_cfg(cfg))
    bridge.load_jax_params(tm, jax.device_get(params))
    got = tm(t(img), t(boxes), t(lab_emb))
    assert got["obj"].shape == (2, cfg.OBJ.MAX_OBJECTS)
    assert got["cls"].shape == (2, cfg.OBJ.MAX_OBJECTS, cfg.OBJ.NUM_CLASSES)
    for k in ("obj", "cls"):
        np.testing.assert_allclose(n(got[k]), n(want[k]), atol=1e-4)


def test_object_dnet_bf16_logits_are_fp32():
    cfg = tiny("bfloat16")
    tm = tdisc.ObjectDNet(port_cfg(cfg), torch.bfloat16)
    img, boxes, lab_emb = _obj_case(cfg)
    out = tm(t(img), t(boxes), t(lab_emb))
    assert out["obj"].dtype == out["cls"].dtype == torch.float32
    # one DNet per scale (16, 32, 64 px), each down to 4x4
    dnets = tdisc.build_discriminators(port_cfg(cfg), torch.bfloat16)
    assert [d.n_down for d in dnets] == [2, 3, 4]
    assert all(d.dtype == torch.bfloat16 for d in dnets)


def test_image_encoder(cfg):
    img = _images(cfg.branch_sizes[-1], seed=12)
    jm = j_image_encoder(cfg)
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(img))
    w_reg, w_glob = jm.apply(params, jnp.asarray(img))
    tm = build_image_encoder(port_cfg(cfg))
    bridge.load_jax_params(tm, jax.device_get(params))
    g_reg, g_glob = tm(t(img))
    assert g_reg.shape == w_reg.shape and g_glob.shape == w_glob.shape
    np.testing.assert_allclose(n(g_reg), n(w_reg), atol=1e-4)
    np.testing.assert_allclose(n(g_glob), n(w_glob), atol=1e-4)


def test_inception_backbone_is_refused():
    """No longer refused: ``inception`` builds the Inception-v3 encoder
    with its backbone frozen (``tests/test_torch_inception.py`` holds it
    to JAX)."""
    from objgan_tpu_torch.models.inception_v3 import InceptionEncoder

    cfg = port_cfg(tiny("float32", TEXT={"CNN_BACKBONE": "inception"}))
    enc = build_image_encoder(cfg)
    assert isinstance(enc, InceptionEncoder)
    assert not any(p.requires_grad for p in enc.backbone.parameters())
    assert all(p.requires_grad for name, p in enc.named_parameters()
               if not name.startswith("backbone."))
