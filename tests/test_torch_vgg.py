"""VGG-16 in the port against the JAX package, and Stage B's ``vgg``
perceptual mode.

* ``VGG16`` with JAX's weights carried across by ``core.bridge``: every
  tap (``stop_at="relu4_3"`` at 16 px, all five at 32 px) within 1e-4 of
  its largest magnitude (fp32), and ``vgg_perceptual_loss`` on the same
  masks within 1e-5 relative.
* ``load_torchvision_vgg16`` from a torchvision-keyed replica (built as
  ``tests/test_vgg.py`` builds one; torchvision is not installed): the
  taps and the logits of the 224 px classifier (``classifier.0``'s
  columns permuted from (C, H, W) to (H, W, C)) equal the replica's within
  1e-4 relative; entries past ``stop_at`` are skipped; ``torch_name_map``
  names what JAX's names.
* One tiny fp32 Stage-B step in ``vgg`` mode from JAX's state: the metrics
  (the perceptual term among them) within 2e-5 relative, every G and D
  gradient within 2e-5 of the tensor's largest magnitude (and at least
  2e-5 absolute), as ``tests/test_torch_shape.py`` holds the ``fm`` step;
  VGG gets no gradient, no Adam state and does not move.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objgan_tpu.data import synthetic as jsyn
from objgan_tpu.models.vgg import VGG16 as JVGG16
from objgan_tpu.models.vgg import torch_name_map as jname_map
from objgan_tpu.models.vgg import vgg_perceptual_loss as jperceptual
from objgan_tpu.train.shape import ShapeTrainer as JShapeTrainer
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.models.vgg import (VGG16, load_torchvision_vgg16,
                                         torch_name_map, vgg_perceptual_loss)
from objgan_tpu_torch.train.shape import ShapeTrainer
from tests.test_vgg import _torch_vgg16
from tests.torch_parity import n, port_cfg, replay_shape_z, t, tiny

torch.set_num_threads(2)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(n(got) - want).max() <= rel * max(float(np.abs(want).max()),
                                                   1e-6)


@pytest.mark.parametrize("size,stop_at", [(16, "relu4_3"), (32, "relu5_3")])
def test_vgg_taps_match_jax(size, stop_at):
    jm = JVGG16(stop_at=stop_at)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(size), jnp.zeros((1, size, size, 3))))
    tm = VGG16(stop_at=stop_at)
    bridge.load_jax_params(tm, params)
    x = np.random.default_rng(size).uniform(0, 1, (2, size, size, 3)
                                            ).astype(np.float32)
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(t(x))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    if stop_at == "relu4_3":
        r = np.random.default_rng(1)
        fake, real = (r.uniform(0, 1, (3, size, size)).astype(np.float32)
                      for _ in range(2))
        np.testing.assert_allclose(
            n(vgg_perceptual_loss(tm, t(fake), t(real))),
            np.asarray(jperceptual(jm, params, jnp.asarray(fake),
                                   jnp.asarray(real))), rtol=1e-5)


@pytest.fixture(scope="module")
def replica():
    torch.manual_seed(0)
    return _torch_vgg16().eval()


def test_load_torchvision_vgg16(replica):
    sd = replica.state_dict()
    names = torch_name_map(sd)
    for src, path in jname_map(list(sd)).items():
        mod, leaf = path.split("/")
        name = bridge._to_torch(leaf, np.zeros((1, 1)))[0]
        assert names[src] == f"{mod}.{name}"
    vgg = load_torchvision_vgg16(VGG16(with_classifier=True), sd)
    x = torch.rand(1, 224, 224, 3, generator=torch.Generator().manual_seed(2))
    mean = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
    xn = (x.permute(0, 3, 1, 2) - mean) / std
    with torch.no_grad():
        got = vgg(x)
        feats = {}
        h = xn
        for i, layer in enumerate(replica.features):
            h = layer(h)
            if i in (3, 8, 15, 22, 29):  # the ReLU after each named conv
                feats[{3: "relu1_2", 8: "relu2_2", 15: "relu3_3",
                       22: "relu4_3", 29: "relu5_3"}[i]] = h
        logits = replica(xn)
    for k, v in feats.items():
        _close(got[k], n(v.permute(0, 2, 3, 1)))
    _close(got["logits"], n(logits))
    # entries past stop_at (block 5, the classifier) are skipped
    small = load_torchvision_vgg16(VGG16(stop_at="relu4_3"), sd)
    assert torch.equal(small.features_21.weight, vgg.features_21.weight)
    with pytest.raises(KeyError, match="lacks"):
        load_torchvision_vgg16(VGG16(stop_at="relu4_3"), {
            k: v for k, v in sd.items() if not k.startswith("features.0.")})


def test_shape_step_in_vgg_mode_matches_jax():
    cfg = tiny("float32", SHAPE={"PERCEPTUAL": "vgg"})
    jt = JShapeTrainer(cfg)
    batch = jax.device_get(jsyn.synthetic_batch(
        cfg, jax.random.PRNGKey(1), with_images=False))
    key = jax.random.PRNGKey(21)
    state = jax.jit(jt.init_state)(jax.random.PRNGKey(0), batch)
    (gg, dg), aux = jax.jit(jax.grad(
        lambda g, d: jt._losses(g, d, state, batch, key),
        argnums=(0, 1), has_aux=True))(state.g_params, state.d_params)
    state, gg, dg = jax.device_get((state, gg, dg))
    assert "shape_perceptual" in aux

    trainer = ShapeTrainer(port_cfg(cfg))
    bridge.load_jax_state(trainer, state)
    z = replay_shape_z(cfg, key, batch["labels"].shape[0])
    grads, metrics = trainer.grads({k: t(v) for k, v in batch.items()}, z)
    assert set(metrics) == set(aux)
    for k, w in aux.items():
        np.testing.assert_allclose(float(metrics[k]), float(w), rtol=2e-5,
                                   atol=0, err_msg=k)
    want = {}
    for prefix, tree in (("g.", gg), ("d.", dg)):
        want.update({prefix + k: v for k, v in
                     bridge.jax_to_torch(tree).items()})
    assert set(grads) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1.0)
        assert np.abs(n(grads[k]) - w).max() <= 2e-5 * scale, k
    before = {k: v.clone() for k, v in trainer.vgg.state_dict().items()}
    trainer.apply_grads(grads)
    assert all(torch.equal(before[k], v)
               for k, v in trainer.vgg.state_dict().items())
    assert not [k for k in trainer.state_dict() if k.startswith("optim.vgg.")]
