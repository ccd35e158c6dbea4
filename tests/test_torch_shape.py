"""Stage B in the port against the JAX package, at the tiny fp32 config:
the same numpy inputs, JAX's noise injected and JAX's states carried
across by ``core.bridge.load_jax_state``.

* ``ShapeDiscriminator``: logits and the three trunk features, atol 1e-5.
* ``shape_d_loss`` and ``shape_g_loss`` on the same logits, features and
  masks: atol 1e-6.
* ``ShapeTrainer``: the first step's metrics and every G and D gradient
  (one backward, JAX's stop-gradients) within 2e-5 of the tensor's
  largest magnitude (and at least 2e-5 absolute); after two steps every
  parameter and Adam moment within 1e-5.
* ``utils/shape_eval.py::heldout_mask_metrics`` equals JAX's with JAX's
  per-batch noise.
* ``SHAPE.PERCEPTUAL: vgg`` builds a frozen VGG-16; another mode is
  refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objgan_tpu.data import synthetic as jsyn
from objgan_tpu.losses import gan_loss as jloss
from objgan_tpu.train.shape import ShapeTrainer as JShapeTrainer
from objgan_tpu.utils import shape_eval as jshape_eval
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.losses.gan_loss import shape_d_loss, shape_g_loss
from objgan_tpu_torch.models.shape_generator import ShapeDiscriminator
from objgan_tpu_torch.train.shape import ShapeTrainer
from objgan_tpu_torch.utils import shape_eval
from tests.torch_parity import (n, port_cfg, replay_shape_z, t, tiny,
                                to_numpy_tree, ttiny)

torch.set_num_threads(2)

TOL = dict(rtol=0, atol=1e-5)


def _jax_batch(cfg, seed):
    return jax.device_get(jsyn.synthetic_batch(
        cfg, jax.random.PRNGKey(seed), with_images=False))


def _port_batch(batch):
    return {k: t(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_shape():
    """JAX's Stage B at tiny fp32: a state, two batches and step keys, the
    first step's metrics and gradients, and the state after two steps."""
    cfg = tiny("float32")
    jt = JShapeTrainer(cfg)
    batches = [_jax_batch(cfg, s) for s in (1, 2)]
    keys = [jax.random.PRNGKey(s) for s in (21, 22)]
    state = jax.jit(jt.init_state)(jax.random.PRNGKey(0), batches[0])
    (gg, dg), aux = jax.jit(jax.grad(
        lambda g, d: jt._losses(g, d, state, batches[0], keys[0]),
        argnums=(0, 1), has_aux=True))(state.g_params, state.d_params)
    grads = {}
    for prefix, tree in (("g.", gg), ("d.", dg)):
        grads.update({prefix + k: v for k, v in bridge.jax_to_torch(
            jax.device_get(tree)).items()})
    step = jax.jit(jt.train_step)
    s, metrics = state, []
    for b, k in zip(batches, keys):
        s, m = step(s, b, k)
        metrics.append({k_: float(v) for k_, v in m.items()})
    b = batches[0]["labels"].shape[0]
    return {
        "cfg": cfg, "jt": jt, "state": to_numpy_tree(state),
        "batches": batches, "zs": [replay_shape_z(cfg, k, b) for k in keys],
        "aux": {k: float(v) for k, v in aux.items()}, "grads": grads,
        "metrics": metrics, "final": to_numpy_tree(s),
    }


def _trainer(jax_shape, state=None):
    trainer = ShapeTrainer(port_cfg(jax_shape["cfg"]))
    bridge.load_jax_state(trainer, state or jax_shape["state"])
    return trainer


def test_shape_discriminator_matches_jax(jax_shape):
    jt, state = jax_shape["jt"], jax_shape["state"]
    batch = jax_shape["batches"][1]
    labels_emb = np.asarray(state.label_table)[batch["labels"]]
    want_logits, want_feats = jt.d.apply(state.d_params, batch["shapes"],
                                         batch["boxes"], labels_emb)
    d = ShapeDiscriminator(port_cfg(jax_shape["cfg"]))
    bridge.load_jax_params(d, state.d_params)
    with torch.no_grad():
        logits, feats = d(t(batch["shapes"]), t(batch["boxes"]),
                          t(labels_emb))
    assert logits.shape == batch["labels"].shape and len(feats) == 3
    np.testing.assert_allclose(n(logits), n(want_logits), **TOL)
    for g, w in zip(feats, want_feats):
        assert g.shape == w.shape
        np.testing.assert_allclose(n(g), n(w), **TOL)


def test_shape_losses_match_jax():
    r = np.random.default_rng(0)
    b, o, s = 2, 3, 8

    def f32(*shape):
        return r.normal(size=shape).astype(np.float32)

    real_logits, fake_logits = f32(b, o), f32(b, o)
    real_feats = [f32(b, o, 12), f32(b, o, 6), f32(b, o, 3)]
    fake_feats = [f32(b, o, 12), f32(b, o, 6), f32(b, o, 3)]
    gt = (r.uniform(size=(b, o, s, s)) > 0.5).astype(np.float32)
    mask_logits = f32(b, o, s, s)
    valid = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
    np.testing.assert_allclose(
        float(shape_d_loss(t(real_logits), t(fake_logits), t(valid))),
        float(jloss.shape_d_loss(real_logits, fake_logits, valid)),
        rtol=0, atol=1e-6)
    want, want_aux = jloss.shape_g_loss(fake_logits, real_feats, fake_feats,
                                        gt, mask_logits, valid, 10.0)
    got, got_aux = shape_g_loss(t(fake_logits), [t(x) for x in real_feats],
                                [t(x) for x in fake_feats], t(gt),
                                t(mask_logits), t(valid), 10.0)
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)
    for k, v in want_aux.items():
        np.testing.assert_allclose(float(got_aux[k]), float(v), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_shape_step_matches_jax(jax_shape):
    """The first step's metrics and every G and D gradient: D's terms see
    the fakes detached, G's run through a detached D, the real features
    are constants, all in one backward."""
    trainer = _trainer(jax_shape)
    grads, metrics = trainer.grads(_port_batch(jax_shape["batches"][0]),
                                   jax_shape["zs"][0])
    for k, w in jax_shape["aux"].items():
        np.testing.assert_allclose(float(metrics[k]), w, rtol=2e-5, atol=0,
                                   err_msg=k)
    assert set(grads) == set(jax_shape["grads"])
    for k, w in jax_shape["grads"].items():
        scale = max(float(np.abs(w).max()), 1.0)
        assert np.abs(n(grads[k]) - w).max() <= 2e-5 * scale, k


def test_shape_two_steps_match_jax(jax_shape):
    """Two train steps (Adam b1 0.5 on G and D): each step's metrics, then
    every parameter, Adam moment and the step count."""
    trainer = _trainer(jax_shape)
    for batch, z, want in zip(jax_shape["batches"], jax_shape["zs"],
                              jax_shape["metrics"]):
        got = trainer.train_step(_port_batch(batch), z)
        for k, w in want.items():
            np.testing.assert_allclose(float(got[k]), w, rtol=2e-5, atol=0,
                                       err_msg=k)
    final = jax_shape["final"]
    assert trainer.step == int(final.step) == 2
    want = {}
    for prefix, params, opt in (("g.", final.g_params, final.g_opt),
                                ("d.", final.d_params, final.d_opt)):
        want.update({prefix + k: v for k, v in
                     bridge.jax_to_torch(params).items()})
        adam = bridge._scale_by_adam(opt)
        for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            want.update({f"optim.{prefix}{k}.{key}": v
                         for k, v in bridge.jax_to_torch(tree).items()})
    sd = trainer.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(n(sd[k]), w, rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(n(sd["label_table"]),
                                  np.asarray(final.label_table))


def test_shape_eval_matches_jax(jax_shape):
    cfg, jt = jax_shape["cfg"], jax_shape["jt"]
    batches = jax_shape["batches"]
    rng = jax.random.PRNGKey(6)
    state = jax.tree.map(jnp.asarray, jax_shape["final"])
    want = jshape_eval.heldout_mask_metrics(jt, state, batches, rng)
    trainer = _trainer(jax_shape, jax_shape["final"])
    zs = [replay_shape_z(cfg, jax.random.fold_in(rng, i),
                         b["labels"].shape[0])
          for i, b in enumerate(batches)]
    got = shape_eval.heldout_mask_metrics(
        trainer, [_port_batch(b) for b in batches], zs)
    assert set(got) == set(want) and got["n_objects"] > 0
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)


def test_vgg_perceptual_is_not_ported():
    """``vgg`` is ported now (``tests/test_torch_vgg.py`` holds its step
    to JAX): it builds a frozen VGG-16; an unknown mode is still refused."""
    trainer = ShapeTrainer(ttiny("float32", SHAPE={"PERCEPTUAL": "vgg"}))
    assert trainer.vgg is not None
    assert not any(p.requires_grad for p in trainer.vgg.parameters())
    assert ShapeTrainer(ttiny("float32")).vgg is None
    with pytest.raises(ValueError, match="PERCEPTUAL"):
        ShapeTrainer(ttiny("float32", SHAPE={"PERCEPTUAL": "lpips"}))


def test_shape_step_on_cpu_moves_g_and_d_and_launches_nothing():
    from objgan_tpu_torch.data.synthetic import synthetic_batch
    from objgan_tpu_torch.ops import groupnorm
    from objgan_tpu_torch.train.shape import shape_noise

    cfg = ttiny("float32")
    trainer = ShapeTrainer(cfg).init_state(torch.Generator().manual_seed(0))
    table = trainer.label_table.clone()
    before = {k: v.detach().clone() for k, v in trainer.named_parameters()}
    gen = torch.Generator().manual_seed(1)
    batch = synthetic_batch(cfg, gen, with_images=False)
    k1 = groupnorm.launches
    metrics = trainer.train_step(batch, shape_noise(cfg, 2, gen, "cpu"))
    assert groupnorm.launches == k1 and trainer.step == 1
    assert set(metrics) == {"shape_adv", "shape_fm", "shape_recon",
                            "shape_d", "shape_g"}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    after = dict(trainer.named_parameters())
    assert all(not torch.equal(after[k], v) for k, v in before.items())
    assert torch.equal(trainer.label_table, table)


@pytest.mark.parametrize("stage,params", [("gan", 117), ("damsm", 33),
                                          ("shape", 35)])
def test_tiny_step_comparison_on_the_cpu(stage, params):
    """``train/card_check.py``, which the card tests run against the CPU,
    compares every metric and gradient: on the CPU against itself it reads
    no error."""
    from objgan_tpu_torch.train import card_check

    r = card_check.tiny_step_on_card(stage, "cpu")
    assert r["grads"] == params and r["metrics"] >= 5
    assert r["metric_err"] == 0.0 and r["grad_err"] == 0.0
