"""Inception-v3 in the port against the JAX package, and the inception
DAMSM backbone.

* ``InceptionV3`` with JAX's ``PRNGKey(0)`` weights carried across by
  ``core.bridge``: ``mixed_6e``, ``pool`` and ``logits`` within 1e-4 of
  each tensor's largest magnitude (fp32; measured ~3e-6), at batch 1 from
  64 px and 256 px (bilinear to 299 px, no antialias), and the explicit
  pads, the VALID stride-2 convs and the pools on the way.
* The torchvision converter: JAX's own torchvision-layout state dict
  (``tests/test_inception.py``) loaded by ``load_torchvision_checkpoint``
  equals the bridge's weights; ``torchvision_state_dict`` round-trips;
  ``torch_name_map`` names what JAX's names.
* One DAMSM step with ``TEXT.CNN_BACKBONE: inception`` at the tiny fp32
  config, from JAX's state (with its masked Adam state): the loss terms
  within 1e-5 relative, every text and projection gradient within 1e-4 of
  the tensor's largest magnitude plus 1e-6; no gradient, no Adam state and
  no move for the backbone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objgan_tpu.data import synthetic as jsyn
from objgan_tpu.models.inception_v3 import InceptionV3 as JInceptionV3
from objgan_tpu.models.inception_v3 import torch_name_map as jname_map
from objgan_tpu.train.damsm import DamsmTrainer as JDamsmTrainer
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.models.inception_v3 import (InceptionEncoder,
                                                  InceptionV3,
                                                  load_torchvision_checkpoint,
                                                  torch_name_map,
                                                  torchvision_state_dict)
from objgan_tpu_torch.train.damsm import DamsmTrainer
from tests.test_inception import _fake_torch_state_dict
from tests.test_torch_damsm import _jax_keep_mask
from tests.torch_parity import n, port_cfg, t, tiny

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_inception():
    model = JInceptionV3()
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 299, 299, 3)))
    return model, jax.device_get(params)


def _port_inception(params):
    model = InceptionV3()
    bridge.load_jax_params(model, params)
    return model


@pytest.mark.parametrize("size", [64, 256])
def test_inception_matches_jax(jax_inception, size):
    model, params = jax_inception
    x = np.random.default_rng(size).uniform(-1, 1, (1, size, size, 3)
                                            ).astype(np.float32)
    want = jax.jit(model.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = _port_inception(params)(t(x))
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape, k
        scale = float(np.abs(w).max())
        assert scale > 0, k
        assert np.abs(n(got[k]) - w).max() <= 1e-4 * scale, k


def test_torchvision_converter(jax_inception):
    _, params = jax_inception
    sd = _fake_torch_state_dict(params)  # JAX's own torchvision replica
    carried = _port_inception(params)
    other = InceptionV3()
    sd_aux = dict(sd, **{"AuxLogits.fc.weight": torch.zeros(1000, 768),
                         "Mixed_5b.branch1x1.bn.num_batches_tracked":
                         torch.tensor(0)})
    load_torchvision_checkpoint(other, sd_aux)
    for k, p in carried.named_parameters():
        assert torch.equal(p, dict(other.named_parameters())[k]), k
    # the inverse, and the encoder's backbone as the target
    back = torchvision_state_dict(other)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    enc = InceptionEncoder(8)
    load_torchvision_checkpoint(enc, back)
    assert torch.equal(enc.backbone.fc.weight, carried.fc.weight)
    # torch_name_map names the parameter JAX's map names (as a flax path)
    names = torch_name_map(sd_aux)
    assert set(names) == set(sd)
    for src, path in jname_map(list(sd)).items():
        *mods, leaf = path.split("/")
        want = ".".join(mods + [bridge._to_torch(leaf, np.zeros((1, 1)))[0]])
        assert names[src] == want, src
    with pytest.raises(KeyError, match="missing"):
        load_torchvision_checkpoint(InceptionV3(), {
            k: v for k, v in sd.items() if not k.startswith("fc.")})


# -- the inception DAMSM backbone --------------------------------------------


def _jax_batch(cfg):
    b = jax.device_get(jsyn.synthetic_batch(cfg, jax.random.PRNGKey(1)))
    b["images"] = [b["images"][-1]]
    return b


def test_damsm_step_with_the_inception_backbone_matches_jax():
    cfg = tiny("float32", TEXT={"CNN_BACKBONE": "inception"})
    jt = JDamsmTrainer(cfg)
    batch = _jax_batch(cfg)
    state = jax.jit(jt.init_state)(jax.random.PRNGKey(0), batch)
    (_, aux), (tg, ig) = jax.jit(jax.value_and_grad(
        lambda tp, ip: jt.loss(tp, ip, batch, jax.random.PRNGKey(5)),
        argnums=(0, 1), has_aux=True))(state.text_params, state.img_params)
    state, tg, ig = jax.device_get((state, tg, ig))
    # JAX's reference: optax.masked leaves the backbone's update zero
    upd, _ = jt.img_tx.update(ig, state.img_opt, state.img_params)
    assert all(not np.any(np.asarray(v)) for k, v in bridge.jax_to_torch(
        upd).items() if k.startswith("backbone."))

    trainer = DamsmTrainer(port_cfg(cfg))
    assert isinstance(trainer.img_enc, InceptionEncoder)
    bridge.load_jax_state(trainer, state)
    batch_t = {k: ([t(x) for x in v] if isinstance(v, list) else t(v))
               for k, v in batch.items()}
    keep = _jax_keep_mask(jt, state.text_params, batch, jax.random.PRNGKey(5))
    grads, metrics = trainer.grads(batch_t, keep)
    for k, w in aux.items():
        np.testing.assert_allclose(float(metrics[k]), float(w), rtol=1e-5,
                                   atol=0, err_msg=k)
    want = {}
    for prefix, tree in (("text_enc.", tg), ("img_enc.", ig)):
        want.update({prefix + k: v for k, v in
                     bridge.jax_to_torch(tree).items()})
    trained = {k for k in want if not k.startswith("img_enc.backbone.")}
    assert set(grads) == trained
    assert {"img_enc.emb_features.weight", "img_enc.emb_cnn_code.weight",
            "img_enc.emb_cnn_code.bias"} <= trained
    for k in trained:
        w = want[k]
        scale = float(np.abs(w).max())
        assert np.abs(n(grads[k]) - w).max() <= 1e-4 * scale + 1e-6, k
    before = {k: v.clone() for k, v in trainer.img_enc.backbone.state_dict()
              .items()}
    trainer.apply_grads(grads)
    after = trainer.img_enc.backbone.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    sd = trainer.state_dict()
    assert not [k for k in sd if k.startswith("optim.img_enc.backbone.")]
    assert "optim.img_enc.emb_cnn_code.bias.exp_avg" in sd

