"""The slice as a whole: ``objgan_tpu.pipeline_e2e.ObjGanPipeline.generate``
against the port's ``ObjGanPipeline.generate`` on the same params, with the
noise replayed from JAX's key chain (tests/torch_parity.py::replay_noise).

Tolerances: labels and obj_valid exact; boxes and masks fp32 atol 1e-5
(Stage A and B are fp32 under either compute dtype); images fp32 atol 1e-4,
bf16 as set out in ``torch_parity.assert_bf16_images_close`` (atol 5e-2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objgan_tpu.pipeline_e2e import ObjGanPipeline as JPipeline
from objgan_tpu_torch.pipeline_e2e import ObjGanPipeline, draw_noise
from tests.torch_parity import (assert_bf16_images_close, example_batch,
                                jax_stage_params, jax_states, n,
                                port_cfg, replay_noise, t, tiny, ttiny)

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
SEED = 3  # a key whose layouts hold valid objects in both rows


@pytest.fixture(scope="module")
def params():
    return jax_stage_params(tiny("float32"))


def _run(dtype, params):
    cfg = tiny(dtype)
    caps, lens = example_batch(cfg, batch=2, seed=1)
    rng = jax.random.PRNGKey(SEED)
    jpipe = JPipeline(cfg)
    states = jax_states(params)
    want = jax.jit(lambda c, l, r: jpipe.generate(states, c, l, r))(
        jnp.asarray(caps), jnp.asarray(lens), rng)
    pipe = ObjGanPipeline(port_cfg(cfg))
    pipe.load_jax_params(params["box"], params["shape_g"],
                         params["shape_label_table"], params["gan_g"],
                         params["text"], params["gan_label_table"])
    got = pipe.generate(t(caps), t(lens), replay_noise(cfg, rng, 2))
    return cfg, got, want


@pytest.fixture(scope="module")
def fp32_run(params):
    return _run("float32", params)


def test_generate_fp32(fp32_run):
    cfg, got, want = fp32_run
    o = cfg.OBJ.MAX_OBJECTS
    # the tiny config decodes 4 steps and keeps 3 objects (truncation)
    assert cfg.BOX.MAX_SEQ_LENGTH > o and got["labels"].shape == (2, o)
    np.testing.assert_array_equal(n(got["labels"]), n(want["labels"]))
    np.testing.assert_array_equal(n(got["obj_valid"]), n(want["obj_valid"]))
    assert n(got["obj_valid"]).sum() >= 1
    np.testing.assert_allclose(n(got["boxes"]), n(want["boxes"]), **TOL)
    np.testing.assert_allclose(n(got["masks"]), n(want["masks"]), **TOL)
    for key in ("grid_attn", "obj_attn"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(n(g), n(w), atol=1e-4)
    for g, w in zip(got["images"], want["images"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(n(g), n(w), atol=1e-4)


def test_generate_bf16(params, fp32_run):
    _, _, want32 = fp32_run
    cfg, got, want = _run("bfloat16", params)
    np.testing.assert_array_equal(n(got["labels"]), n(want["labels"]))
    np.testing.assert_array_equal(n(got["obj_valid"]), n(want["obj_valid"]))
    assert got["masks"].dtype == torch.float32  # Stage B stays fp32
    np.testing.assert_allclose(n(got["boxes"]), n(want["boxes"]), **TOL)
    np.testing.assert_allclose(n(got["masks"]), n(want["masks"]), **TOL)
    assert_bf16_images_close(got["images"], want["images"],
                             want32["images"])


def test_each_stage_keeps_its_own_label_table(params):
    """At 7 classes the shape and gan stages carry different random label
    tables; the port loads each into its own stage."""
    assert not np.allclose(params["shape_label_table"],
                           params["gan_label_table"])
    pipe = ObjGanPipeline(ttiny("float32"))
    pipe.load_jax_params(params["box"], params["shape_g"],
                         params["shape_label_table"], params["gan_g"],
                         params["text"], params["gan_label_table"])
    np.testing.assert_array_equal(n(pipe.shape.label_table),
                                  params["shape_label_table"])
    np.testing.assert_array_equal(n(pipe.gan.label_table),
                                  params["gan_label_table"])


def test_draw_noise_shapes_and_determinism():
    cfg = ttiny("bfloat16")
    a = draw_noise(cfg, 3, torch.Generator().manual_seed(5), "cpu")
    b = draw_noise(cfg, 3, torch.Generator().manual_seed(5), "cpu")
    want = {
        "label_gumbel": (cfg.BOX.MAX_SEQ_LENGTH, 3, cfg.OBJ.NUM_CLASSES),
        "comp_gumbel": (cfg.BOX.MAX_SEQ_LENGTH, 3, cfg.OBJ.GMM_COMPONENTS),
        "box_normal": (cfg.BOX.MAX_SEQ_LENGTH, 3, 4),
        "shape_z": (3, cfg.OBJ.MAX_OBJECTS, 1, 1, cfg.SHAPE.GF_DIM),
        "z": (3, cfg.GAN.Z_DIM),
        "ca_eps": (3, cfg.GAN.CONDITION_DIM),
    }
    assert {k: tuple(v.shape) for k, v in a.items()} == want
    for k in a:
        assert a[k].dtype == torch.float32  # fp32 even under bf16 compute
        assert torch.equal(a[k], b[k])
        assert torch.isfinite(a[k]).all()


def test_fresh_pipeline_generates_finite_images():
    cfg = ttiny("bfloat16")
    pipe = ObjGanPipeline.fresh(cfg, seed=0, device="cpu")
    caps, lens = example_batch(cfg, batch=2)
    out = pipe.generate(t(caps), t(lens),
                        draw_noise(cfg, 2, torch.Generator().manual_seed(0),
                                   "cpu"))
    sizes = [16, 32, 64]
    for img, s in zip(out["images"], sizes):
        assert img.shape == (2, s, s, 3)
        assert torch.isfinite(img).all() and img.abs().max() <= 1.0
