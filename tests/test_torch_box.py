"""Stage A in the port against the JAX package, at the tiny fp32 config:
the same numpy inputs, JAX's noise injected and JAX's states carried
across by ``core.bridge.load_jax_state``.

* ``ops/gmm.py``: ``log_prob``, ``nll`` and ``mean`` in both covariance
  modes, atol 1e-5.
* ``BoxGenerator.teacher_forced`` with and without scheduled-sampling
  flips (JAX's ``bernoulli`` draws), and ``box_loss``: atol 1e-5.
* ``beam_sample`` at K = 1 and 3: labels and validity exact, boxes and
  ``beam_scores`` atol 1e-5.
* ``BoxTrainer``: the first step's metrics and every gradient within 2e-5
  of the tensor's largest magnitude (and at least 2e-5 absolute); after
  two steps every parameter and Adam moment within 1e-5.
* ``utils/box_eval.py``: ``heldout_nll`` and ``layout_stats`` (temperature
  sampling with JAX's per-batch noise, and beam search) equal JAX's.
* ``cli.sample_box`` against JAX's, which pads the batch to a power of
  two: the port does not pad and takes the padded batch's noise sliced to
  the real rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objgan_tpu import cli as jcli
from objgan_tpu.data import synthetic as jsyn
from objgan_tpu.models.box_generator import BoxGenerator as JBoxGenerator
from objgan_tpu.models.box_generator import box_loss as jbox_loss
from objgan_tpu.ops import gmm as jgmm
from objgan_tpu.train.box import BoxTrainer as JBoxTrainer
from objgan_tpu.utils import box_eval as jbox_eval
from objgan_tpu_torch import cli
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.core.checkpoint import CheckpointManager
from objgan_tpu_torch.models.box_generator import box_loss
from objgan_tpu_torch.ops import gmm
from objgan_tpu_torch.train.box import BoxTrainer, ss_flips
from objgan_tpu_torch.utils import box_eval
from tests.torch_parity import (example_batch, n, port_cfg,
                                replay_box_noise, t, tiny, to_numpy_tree,
                                ttiny)

torch.set_num_threads(2)

TOL = dict(rtol=0, atol=1e-5)
SS_PROB = 0.5


def _jax_batch(cfg, seed):
    return jax.device_get(jsyn.synthetic_batch(
        cfg, jax.random.PRNGKey(seed), with_images=False))


def _port_batch(batch):
    return {k: t(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_box():
    """JAX's Stage A at tiny fp32: a state, two batches, the first step's
    metrics and gradients, and the state after two train steps."""
    cfg = tiny("float32")
    jt = JBoxTrainer(cfg)
    batches = [_jax_batch(cfg, s) for s in (1, 2)]
    state = jax.jit(jt.init_state)(jax.random.PRNGKey(0), batches[0])
    (_, aux), grads = jax.jit(jax.value_and_grad(jt.loss, has_aux=True))(
        state.params, batches[0])
    step = jax.jit(jt.train_step)
    s, metrics = state, []
    for b in batches:
        s, m = step(s, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {
        "cfg": cfg, "jt": jt, "state": to_numpy_tree(state),
        "batches": batches, "aux": {k: float(v) for k, v in aux.items()},
        "grads": {"model." + k: v for k, v in bridge.jax_to_torch(
            jax.device_get(grads)).items()},
        "metrics": metrics, "final": to_numpy_tree(s),
    }


def _trainer(jax_box, **over):
    trainer = BoxTrainer(port_cfg(jax_box["cfg"]).merged(over))
    bridge.load_jax_state(trainer, jax_box["state"])
    return trainer


# -- ops/gmm.py -----------------------------------------------------------


@pytest.mark.parametrize("mode", ["diag", "corr"])
def test_gmm_log_prob_nll_mean_match_jax(mode):
    r = np.random.default_rng(0)
    k = 5
    params = r.normal(size=(3, 4, jgmm.param_size(k, mode))).astype(
        np.float32)
    box = r.uniform(0, 1, (3, 4, 4)).astype(np.float32)
    valid = (r.uniform(size=(3, 4)) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        n(gmm.log_prob(t(params), t(box), k, mode)),
        n(jgmm.log_prob(params, box, k, mode)), **TOL)
    for v in (None, valid):
        np.testing.assert_allclose(
            float(gmm.nll(t(params), t(box), k,
                          None if v is None else t(v), mode)),
            float(jgmm.nll(params, box, k, v, mode)), **TOL)
    np.testing.assert_allclose(n(gmm.mean(t(params), k, mode)),
                               n(jgmm.mean(params, k, mode)), **TOL)
    assert gmm.param_size(k, mode) == jgmm.param_size(k, mode)


# -- the model ------------------------------------------------------------


@pytest.mark.parametrize("scheduled", [False, True])
def test_teacher_forced_and_box_loss_match_jax(jax_box, scheduled):
    cfg, jt, state = jax_box["cfg"], jax_box["jt"], jax_box["state"]
    batch = jax_box["batches"][0]
    args = (batch["captions"], batch["cap_lens"], batch["labels"],
            batch["boxes"], batch["obj_valid"])
    flips = None
    kw = {}
    if scheduled:
        rng = jax.random.PRNGKey(7)
        o, b = batch["labels"].shape[1], batch["labels"].shape[0]
        # teacher_forced's draws: split(rng, O + 1), bernoulli per step
        flips = torch.stack([t(jax.random.bernoulli(r, SS_PROB, (b,)))
                             for r in jax.random.split(rng, o + 1)])
        assert 0 < int(flips.sum()) < flips.numel()
        kw = dict(ss_prob=SS_PROB, rng=rng)
    want = jt.model.apply(state.params, *args, **kw)
    model = _trainer(jax_box).model
    got = model.teacher_forced(t(batch["captions"]), t(batch["cap_lens"]),
                               t(batch["labels"]), t(batch["boxes"]), flips)
    for key in ("label_logits", "box_params", "alphas"):
        np.testing.assert_allclose(n(got[key]), n(want[key]), **TOL,
                                   err_msg=key)
    c = jax_box["cfg"].OBJ
    w_total, w_aux = jbox_loss(want, batch["labels"], batch["boxes"],
                               batch["obj_valid"], c.GMM_COMPONENTS,
                               c.GMM_MODE)
    g_total, g_aux = box_loss(got, t(batch["labels"]), t(batch["boxes"]),
                              t(batch["obj_valid"]), c.GMM_COMPONENTS,
                              c.GMM_MODE)
    np.testing.assert_allclose(float(g_total.detach()), float(w_total),
                               **TOL)
    for k, v in w_aux.items():
        np.testing.assert_allclose(float(g_aux[k].detach()), float(v),
                                   **TOL, err_msg=k)


def test_box_loss_stop_target_sits_after_the_prefix():
    """The STOP target of each row sits at sum(obj_valid); steps after it
    carry no label loss and padded objects no box loss."""
    b, o, c, k = 2, 3, 5, 2
    labels = torch.tensor([[2, 3, 0], [4, 0, 0]])
    valid = (labels > 0).float()
    logits = torch.zeros(b, o + 1, c)
    # confident and right at every counted step, wrong after it
    for i, row in enumerate([[2, 3, 0, 1], [4, 0, 1, 1]]):
        for s, lab in enumerate(row):
            logits[i, s, lab] = 50.0
    params = torch.zeros(b, o, gmm.param_size(k, "diag"))
    boxes = torch.zeros(b, o, 4)
    _, aux = box_loss({"label_logits": logits, "box_params": params},
                      labels, boxes, valid, k, "diag")
    assert float(aux["label_loss"]) < 1e-6
    params[1, 1:] = 1e3  # garbage at the padded objects only
    _, aux2 = box_loss({"label_logits": logits, "box_params": params},
                       labels, boxes, valid, k, "diag")
    assert float(aux2["box_nll"]) == pytest.approx(float(aux["box_nll"]))


@pytest.mark.parametrize("beam", [1, 3])
def test_beam_sample_matches_jax(jax_box, beam):
    jt, state = jax_box["jt"], jax_box["state"]
    batch = jax_box["batches"][1]
    want = jt.model.apply(state.params, batch["captions"], batch["cap_lens"],
                          jax.random.PRNGKey(0), beam_size=beam,
                          method=JBoxGenerator.beam_sample)
    model = _trainer(jax_box).model
    with torch.no_grad():
        got = model.beam_sample(t(batch["captions"]), t(batch["cap_lens"]),
                                beam)
    np.testing.assert_array_equal(n(got["labels"]), n(want["labels"]))
    np.testing.assert_array_equal(n(got["obj_valid"]), n(want["obj_valid"]))
    for key in ("boxes", "beam_scores"):
        np.testing.assert_allclose(n(got[key]), n(want[key]), **TOL,
                                   err_msg=key)
    assert got["beam_scores"].shape == (batch["captions"].shape[0], beam)


def test_beam_sample_draws_nothing_and_ranks_descending(jax_box):
    """No rng is consumed: two calls agree, and the global generator is
    untouched; the final beams come out sorted by normalised score, the
    unused beams of step 1 never outranking the root's."""
    model = _trainer(jax_box).model
    batch = jax_box["batches"][0]
    state = torch.random.get_rng_state()
    with torch.no_grad():
        a = model.beam_sample(t(batch["captions"]), t(batch["cap_lens"]), 3)
        b = model.beam_sample(t(batch["captions"]), t(batch["cap_lens"]), 3)
    assert torch.equal(torch.random.get_rng_state(), state)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    scores = a["beam_scores"]
    assert bool((scores[:, :-1] >= scores[:, 1:]).all())
    assert bool((scores > -1e8).all())


def test_temperature_sample_matches_jax(jax_box):
    cfg, jt, state = jax_box["cfg"], jax_box["jt"], jax_box["state"]
    batch = jax_box["batches"][1]
    rng = jax.random.PRNGKey(4)
    want = jt.model.apply(state.params, batch["captions"], batch["cap_lens"],
                          rng, method=JBoxGenerator.sample)
    trainer = _trainer(jax_box)
    got = trainer.sample(t(batch["captions"]), t(batch["cap_lens"]),
                         replay_box_noise(cfg, rng,
                                          batch["captions"].shape[0]))
    np.testing.assert_array_equal(n(got["labels"]), n(want["labels"]))
    np.testing.assert_array_equal(n(got["obj_valid"]), n(want["obj_valid"]))
    np.testing.assert_allclose(n(got["boxes"]), n(want["boxes"]), **TOL)


# -- the trainer ----------------------------------------------------------


def test_box_step_matches_jax(jax_box):
    """The first step's metrics and every gradient (before the clip)."""
    trainer = _trainer(jax_box)
    grads, metrics = trainer.grads(_port_batch(jax_box["batches"][0]))
    for k, w in jax_box["aux"].items():
        np.testing.assert_allclose(float(metrics[k]), w, rtol=2e-5, atol=0,
                                   err_msg=k)
    assert set(grads) == set(jax_box["grads"])
    for k, w in jax_box["grads"].items():
        scale = max(float(np.abs(w).max()), 1.0)
        assert np.abs(n(grads[k]) - w).max() <= 2e-5 * scale, k


def test_box_two_steps_match_jax(jax_box):
    """Two train steps (clip by the global norm, Adam b1 0.9): each step's
    metrics, then every parameter, Adam moment and the step count."""
    trainer = _trainer(jax_box)
    for batch, want in zip(jax_box["batches"], jax_box["metrics"]):
        got = trainer.train_step(_port_batch(batch))
        for k, w in want.items():
            np.testing.assert_allclose(float(got[k]), w, rtol=2e-5, atol=0,
                                       err_msg=k)
    final = jax_box["final"]
    assert trainer.step == int(final.step) == 2
    want = {"model." + k: v for k, v in
            bridge.jax_to_torch(final.params).items()}
    adam = bridge._scale_by_adam(final.opt)
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want.update({f"optim.model.{k}.{key}": v
                     for k, v in bridge.jax_to_torch(tree).items()})
    sd = trainer.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(n(sd[k]), w, rtol=0, atol=1e-5,
                                   err_msg=k)


def test_load_box_state_carries_adam_moments(jax_box):
    trainer = BoxTrainer(port_cfg(jax_box["cfg"]))
    bridge.load_jax_state(trainer, jax_box["final"])
    sd = trainer.state_dict()
    adam = bridge._scale_by_adam(jax_box["final"].opt)
    for k, v in bridge.jax_to_torch(adam.nu).items():
        np.testing.assert_array_equal(n(sd[f"optim.model.{k}.exp_avg_sq"]),
                                      v)
        assert float(sd[f"optim.model.{k}.step"]) == 2.0
    assert trainer.step == 2


def test_scheduled_sampling_step_matches_jax(jax_box):
    """The loss with scheduled sampling: JAX's flips injected."""
    cfg = jax_box["cfg"].merged({"BOX": {
        "SCHEDULED_SAMPLING_PROB": SS_PROB}})
    jt, state = JBoxTrainer(cfg), jax_box["state"]
    batch = jax_box["batches"][1]
    rng = jax.random.PRNGKey(11)
    _, want = jt.loss(state.params, batch, rng)
    b, o = batch["labels"].shape
    flips = torch.stack([t(jax.random.bernoulli(r, SS_PROB, (b,)))
                         for r in jax.random.split(rng, o + 1)])
    trainer = _trainer(jax_box, BOX={"SCHEDULED_SAMPLING_PROB": SS_PROB})
    _, got = trainer.loss(_port_batch(batch), flips)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), **TOL, err_msg=k)


def test_ss_flips_draw_at_the_configured_rate():
    cfg = ttiny("float32")
    gen = torch.Generator().manual_seed(0)
    assert ss_flips(cfg, 3, 2, gen, "cpu") is None
    cfg = cfg.merged({"BOX": {"SCHEDULED_SAMPLING_PROB": 0.25}})
    flips = ss_flips(cfg, 399, 100, gen, "cpu")
    assert flips.shape == (400, 100) and flips.dtype == torch.bool
    assert abs(float(flips.float().mean()) - 0.25) < 0.01


# -- evaluation -----------------------------------------------------------


def test_box_eval_matches_jax(jax_box):
    cfg, jt = jax_box["cfg"], jax_box["jt"]
    state = jax.tree.map(jnp.asarray, jax_box["final"])
    batches = jax_box["batches"]
    rng = jax.random.PRNGKey(5)
    trainer = BoxTrainer(port_cfg(cfg))
    bridge.load_jax_state(trainer, jax_box["final"])
    pb = [_port_batch(b) for b in batches]
    want = jbox_eval.heldout_nll(jt, state, batches)
    got = box_eval.heldout_nll(trainer, pb)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **TOL, err_msg=k)
    noises = [replay_box_noise(cfg, jax.random.fold_in(rng, i),
                               b["captions"].shape[0])
              for i, b in enumerate(batches)]
    for beam in (False, True):
        want = jbox_eval.layout_stats(jt, state, batches, rng,
                                      cfg.OBJ.NUM_CLASSES, use_beam=beam)
        got = box_eval.layout_stats(trainer, pb, cfg.OBJ.NUM_CLASSES,
                                    noises, use_beam=beam)
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, **TOL, err_msg=k)


def test_sample_box_matches_jax_cli(jax_box, tmp_path):
    """3 captions: JAX's ``sample_box`` pads them to 4 and draws from
    PRNGKey(RNG_SEED); the port samples the 3 with that noise, sliced.
    Both from the same weights (JAX's fresh ones, saved as the port's
    Stage-A checkpoint). Beam search too."""
    cfg = jax_box["cfg"].merged({"OUTPUT_DIR": str(tmp_path / "jax")})
    caps, lens = example_batch(cfg, batch=3, seed=2)
    rng = jax.random.PRNGKey(cfg.RNG_SEED)
    jt = JBoxTrainer(cfg)
    state = jt.init_state(rng, jsyn.synthetic_batch(cfg, rng, 4,
                                                    with_images=False))
    pcfg = port_cfg(cfg).merged({"OUTPUT_DIR": str(tmp_path / "port")})
    trainer = BoxTrainer(pcfg)
    bridge.load_jax_state(trainer, to_numpy_tree(state))
    CheckpointManager(str(tmp_path / "port" / "objgan_box" / "ckpt")).save(
        0, trainer)
    noise = {k: v[:, :3] for k, v in replay_box_noise(cfg, rng, 4).items()}
    for beam in (False, True):
        want = jcli.sample_box(cfg, caps, lens, use_beam=beam)
        got = cli.sample_box(pcfg, caps, lens, use_beam=beam, device="cpu",
                             noise=noise)
        assert got["labels"] == want["labels"]
        assert got["obj_valid"] == want["obj_valid"]
        np.testing.assert_allclose(got["boxes"], want["boxes"], **TOL)
