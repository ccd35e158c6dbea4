"""DAMSM pretraining in the port against the JAX package, and the port's
pretraining and Stage-C command-line paths.

* The text encoder with dropout: JAX's keep mask, read from the captured
  ``Dropout`` output (kept where it is not zero), fed to the port's
  ``RNNEncoder``: fp32 atol 1e-5.
* One DAMSM step at the tiny fp32 config (``DamsmTrainer.grads`` against
  ``jax.value_and_grad`` of JAX's ``DamsmTrainer.loss``): the loss terms
  within 1e-5 relative, every text and image gradient within 1e-4 of the
  tensor's largest magnitude plus 1e-6; after 3 chained steps the metrics
  of each step within 1e-4 relative, at least 99.9% of each parameter's
  elements within 1e-6 and its move within 1% in norm (Adam turns
  gradient elements below the frameworks' fp32 difference into steps of
  ~lr, see the test).
* Clipping: the text encoder's gradients clipped by optax's rule, below
  and above ``RNN_GRAD_CLIP``, and Adam on both encoders, against
  ``optax``.
* Resume: 4 unbroken steps bitwise equal to 2 + resume + 2, for DAMSM and
  for Stage C, on the synthetic feed.
* The entry points: ``python -m objgan_tpu_torch.pretrain_damsm`` in a
  subprocess that imports neither JAX nor the JAX package, and
  ``gan_main`` with ``TRAIN.NET_E``.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from objgan_tpu.data import synthetic as jsyn
from objgan_tpu.train.damsm import DamsmTrainer as JDamsmTrainer
from objgan_tpu_torch import cli
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.core.checkpoint import CheckpointManager
from objgan_tpu_torch.data import synthetic as tsyn
from objgan_tpu_torch.models.damsm import build_text_encoder
from objgan_tpu_torch.train.common import clip_by_global_norm_
from objgan_tpu_torch.train.damsm import DamsmTrainer
from objgan_tpu_torch.train.gan import GanTrainer, train_noise
from tests.test_torch_data import FORBIDDEN_MODULES
from tests.torch_parity import n, t, tiny, to_numpy_tree, ttiny

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3


def _jax_batch(seed):
    b = jax.device_get(jsyn.synthetic_batch(tiny("float32"),
                                            jax.random.PRNGKey(seed)))
    b["images"] = [b["images"][-1]]
    return b


def _port_batch(batch):
    return {k: ([t(x) for x in v] if isinstance(v, list) else t(v))
            for k, v in batch.items()}


def _jax_keep_mask(jt, text_params, batch, key):
    """The keep mask JAX's dropout draws from ``key``: the captured
    ``Dropout`` output is zero exactly where a value was dropped."""
    _, inter = jt.text_enc.apply(
        text_params, batch["captions"], batch["cap_lens"],
        deterministic=False, rngs={"dropout": key},
        capture_intermediates=True, mutable=["intermediates"])
    out = np.asarray(inter["intermediates"]["Dropout_0"]["__call__"][0])
    return torch.from_numpy(out != 0)


@pytest.fixture(scope="module")
def jax_damsm():
    """JAX's DAMSM trainer at tiny fp32: the initial state, three batches
    and dropout keys, the first step's loss terms and gradients, every
    step's metrics and the parameters after the three steps."""
    cfg = tiny("float32")
    jt = JDamsmTrainer(cfg)
    batches = [_jax_batch(s) for s in range(1, STEPS + 1)]
    state = jt.init_state(jax.random.PRNGKey(0), batches[0])
    keys = jax.random.split(jax.random.PRNGKey(5), STEPS)
    masks = [_jax_keep_mask(jt, state.text_params, b, k)
             for b, k in zip(batches, keys)]
    (_, aux), (tg, ig) = jax.jit(jax.value_and_grad(
        jt.loss, argnums=(0, 1), has_aux=True))(
        state.text_params, state.img_params, batches[0], keys[0])
    grads = {}
    for prefix, tree in (("text_enc.", tg), ("img_enc.", ig)):
        grads.update({prefix + k: v for k, v in
                      bridge.jax_to_torch(jax.device_get(tree)).items()})
    step = jax.jit(jt.train_step)
    s, metrics = state, []
    for b, k in zip(batches, keys):
        s, m = step(s, b, k)
        metrics.append({k_: float(v) for k_, v in m.items()})
    return {
        "jt": jt, "state": to_numpy_tree(state), "batches": batches,
        "masks": masks, "aux": {k: float(v) for k, v in aux.items()},
        "grads": grads, "metrics": metrics, "final": to_numpy_tree(s),
    }


def _port_trainer(state):
    trainer = DamsmTrainer(ttiny("float32"))
    bridge.load_jax_state(trainer, state)
    return trainer


def test_text_encoder_dropout_matches_jax(jax_damsm):
    jt, state = jax_damsm["jt"], jax_damsm["state"]
    batch, mask = jax_damsm["batches"][0], jax_damsm["masks"][0]
    assert 0.3 < float(mask.float().mean()) < 0.7
    enc = build_text_encoder(ttiny("float32"))
    bridge.load_jax_params(enc, state.text_params)
    key = jax.random.split(jax.random.PRNGKey(5), STEPS)[0]
    want = jt.text_enc.apply(state.text_params, batch["captions"],
                             batch["cap_lens"], deterministic=False,
                             rngs={"dropout": key})
    got = enc(t(batch["captions"]), t(batch["cap_lens"]), mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), rtol=0, atol=1e-5)
    # without a mask the encoder is deterministic (Stage C, serving)
    want = jt.text_enc.apply(state.text_params, batch["captions"],
                             batch["cap_lens"])
    got = enc(t(batch["captions"]), t(batch["cap_lens"]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), rtol=0, atol=1e-5)


def test_keep_mask_draws_one_minus_drop_prob():
    enc = build_text_encoder(ttiny("float32"))
    caps = torch.ones(64, 6, dtype=torch.int32)
    mask = enc.keep_mask(caps, torch.Generator().manual_seed(0))
    assert mask.shape == (64, 6, 16) and mask.dtype == torch.bool
    assert abs(float(mask.float().mean()) - 0.5) < 0.03


def test_damsm_step_matches_jax(jax_damsm):
    """The first step's loss terms and every text and image gradient."""
    trainer = _port_trainer(jax_damsm["state"])
    grads, metrics = trainer.grads(_port_batch(jax_damsm["batches"][0]),
                                   jax_damsm["masks"][0])
    want = jax_damsm["aux"]
    for k, w in want.items():
        np.testing.assert_allclose(float(metrics[k]), w, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(metrics["damsm_total"]),
                               sum(want.values()), rtol=1e-5)
    assert set(grads) == set(jax_damsm["grads"])
    for k, w in jax_damsm["grads"].items():
        # relative to the tensor's scale: elements that cancel to ~1e-3 of
        # it differ by more than 1e-4 of themselves (measured: at most
        # 8.3e-06 against max |w| >= 0.21, norm-relative <= 3.5e-06)
        scale = np.abs(w).max()
        assert scale > 0, k  # every parameter gets a gradient
        assert np.abs(n(grads[k]) - w).max() <= 1e-4 * scale + 1e-6, k


def test_damsm_three_steps_match_jax(jax_damsm):
    """Three chained train steps (text gradients clipped, Adam on both
    encoders): the metrics of each step and every parameter after them."""
    trainer = _port_trainer(jax_damsm["state"])
    for batch, mask, want in zip(jax_damsm["batches"], jax_damsm["masks"],
                                 jax_damsm["metrics"]):
        got = trainer.train_step(_port_batch(batch), mask)
        for k, w in want.items():
            np.testing.assert_allclose(float(got[k]), w, rtol=1e-4, err_msg=k)
    assert trainer.step == STEPS
    final, start = jax_damsm["final"], jax_damsm["state"]
    sd = trainer.state_dict()
    for prefix, field in (("text_enc.", "text_params"),
                          ("img_enc.", "img_params")):
        w0 = bridge.jax_to_torch(getattr(start, field))
        for k, w in bridge.jax_to_torch(getattr(final, field)).items():
            # Adam moves an element by ~lr whatever its gradient, so an
            # element whose gradient is below the two frameworks' fp32
            # difference (~1e-5 here) moves by ~lr either way, with a
            # sign of its own: such elements (at most 1.3e-4 of a tensor,
            # measured) may differ by up to 3 lr; the move as a whole
            # agrees to 1% in norm (measured <= 2.3e-3)
            err = np.abs(n(sd[prefix + k]) - w)
            assert (err > 1e-6).mean() <= 1e-3, prefix + k
            assert (np.linalg.norm(err)
                    <= 1e-2 * np.linalg.norm(w - w0[k])), prefix + k


@pytest.mark.parametrize("scale", [1e-3, 30.0])
def test_clip_by_global_norm_matches_optax(scale):
    r = np.random.default_rng(0)
    grads = [r.normal(size=s).astype(np.float32) * scale
             for s in ((3, 4), (5,), (2, 2, 2))]
    tx = optax.clip_by_global_norm(0.25)
    want, _ = tx.update(grads, tx.init(grads))
    got = [t(g) for g in grads]
    norm = clip_by_global_norm_(got, 0.25)
    assert (float(norm) > 0.25) == (scale > 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), rtol=1e-6, atol=0)


@pytest.mark.parametrize("scale", [1.0, 1e3])
def test_apply_grads_matches_optax(jax_damsm, scale):
    """Given gradients, scaled so that at 1e3 the text encoder's global
    norm is far beyond RNN_GRAD_CLIP: the port's update (clip the text
    gradients, Adam on both) against JAX's ``text_tx`` and ``img_tx``."""
    jt, state = jax_damsm["jt"], jax_damsm["state"]
    r = np.random.default_rng(1)
    tg = jax.tree.map(lambda p: r.normal(size=p.shape).astype(np.float32)
                      * scale * 1e-3, state.text_params)
    ig = jax.tree.map(lambda p: r.normal(size=p.shape).astype(np.float32),
                      state.img_params)
    norm = float(optax.global_norm(tg))
    assert (norm > 0.25) == (scale > 1), norm
    t_upd, _ = jt.text_tx.update(tg, jt.text_tx.init(state.text_params),
                                 state.text_params)
    i_upd, _ = jt.img_tx.update(ig, jt.img_tx.init(state.img_params),
                                state.img_params)
    trainer = _port_trainer(state)
    grads = {}
    for prefix, tree in (("text_enc.", tg), ("img_enc.", ig)):
        grads.update({prefix + k: t(v) for k, v in
                      bridge.jax_to_torch(tree).items()})
    trainer.apply_grads(grads)
    sd = trainer.state_dict()
    for prefix, params, upd in (
            ("text_enc.", state.text_params, t_upd),
            ("img_enc.", state.img_params, i_upd)):
        want = bridge.jax_to_torch(jax.device_get(
            optax.apply_updates(params, upd)))
        for k, w in want.items():
            np.testing.assert_allclose(n(sd[prefix + k]), w, rtol=0,
                                       atol=1e-6, err_msg=prefix + k)


def test_damsm_step_on_cpu_moves_every_parameter_and_launches_nothing():
    from objgan_tpu_torch.ops import groupnorm

    cfg = ttiny("float32")
    trainer = DamsmTrainer(cfg).init_state(torch.Generator().manual_seed(0))
    before = {k: v.detach().clone() for k, v in trainer.named_parameters()}
    gen = torch.Generator().manual_seed(1)
    batch = tsyn.synthetic_batch(cfg, gen)
    k1 = groupnorm.launches
    metrics = trainer.train_step(batch, trainer.text_enc.keep_mask(
        batch["captions"], gen))
    assert groupnorm.launches == k1 and trainer.step == 1
    assert all(np.isfinite(float(v)) for v in metrics.values())
    after = dict(trainer.named_parameters())
    assert all(not torch.equal(after[k], v) for k, v in before.items())


def test_load_damsm_state_copies_both_encoders(jax_damsm):
    state = jax_damsm["state"]
    trainer = _port_trainer(state)
    sd = trainer.state_dict()
    for prefix, tree in (("text_enc.", state.text_params),
                         ("img_enc.", state.img_params)):
        for k, v in bridge.jax_to_torch(tree).items():
            np.testing.assert_array_equal(sd[prefix + k].numpy(), v)
    assert trainer.step == 0
    assert all(not v.any() for k, v in sd.items() if k.startswith("optim."))


# -- resume -------------------------------------------------------------------


def _assert_states_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_damsm_trainer_resume_is_bitwise(tmp_path):
    """Four steps, or two, a save, a restore into a fresh trainer and two
    more: the same state to the bit."""
    cfg = ttiny("float32")

    def fresh():
        return DamsmTrainer(cfg).init_state(torch.Generator().manual_seed(0))

    def run(trainer, steps):
        for s in steps:
            gen = torch.Generator().manual_seed(100 + s)
            batch = tsyn.synthetic_batch(cfg, gen)
            trainer.train_step(batch, trainer.text_enc.keep_mask(
                batch["captions"], gen))

    unbroken = fresh()
    run(unbroken, range(4))
    first = fresh()
    run(first, range(2))
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    assert manager.save(first.step, first)
    resumed = fresh()
    assert manager.restore_latest(resumed) == 2
    run(resumed, range(2, 4))
    _assert_states_equal(unbroken.state_dict(), resumed.state_dict())


def _saved(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _tiny_cfg(tmp_path, **train):
    return ttiny("float32", OUTPUT_DIR=str(tmp_path),
                 TRAIN={"BATCH_SIZE": 2, "SNAPSHOT_STEPS": 2, **train})


@pytest.mark.parametrize("stage", ["damsm", "gan"])
def test_cli_resume_equals_an_unbroken_run(tmp_path, stage):
    """``pretrain_damsm`` / ``train_gan`` to step 4 in one run, or to step 2
    and then, resumed from its checkpoint, to step 4: the same checkpoint
    at step 4, to the bit, and the same metrics at steps 3 and 4 (the noise
    and the synthetic batches are drawn from (RNG_SEED, step))."""
    run = cli.pretrain_damsm if stage == "damsm" else cli.train_gan
    rows = {}
    for name, stops in (("unbroken", (4,)), ("resumed", (2, 4))):
        cfg = _tiny_cfg(tmp_path / name)
        for stop in stops:
            run(cfg, max_steps=stop, device="cpu", log_every=1)
        out = tmp_path / name / f"objgan_{stage}"
        rows[name] = (out / f"{stage}_metrics.csv").read_text().splitlines()
    a = _saved(tmp_path / "unbroken" / f"objgan_{stage}" / "ckpt" / "4" /
               "state.pt")
    b = _saved(tmp_path / "resumed" / f"objgan_{stage}" / "ckpt" / "4" /
               "state.pt")
    _assert_states_equal(a, b)
    assert int(a["step"]) == 4

    def metrics(lines):  # without wall_s and steps_per_sec
        head = lines[0].split(",")
        keep = [i for i, k in enumerate(head)
                if k not in ("wall_s", "steps_per_sec")]
        return [[ln.split(",")[i] for i in keep] for ln in lines]

    assert metrics(rows["unbroken"]) == metrics(rows["resumed"])
    assert len(rows["unbroken"]) == 5  # the header and steps 1-4


def test_cli_skips_a_stage_already_trained(tmp_path, capsys):
    cfg = _tiny_cfg(tmp_path)
    assert cli.pretrain_damsm(cfg, max_steps=1, device="cpu") is not None
    assert cli.pretrain_damsm(cfg, max_steps=1, device="cpu") is None
    assert "checkpoint at step 1 >= max_steps 1; nothing to do" in \
        capsys.readouterr().out


def test_train_gan_loads_net_e_and_sample_gan_reads_net_g(tmp_path, capsys):
    """Stage C from DAMSM pretraining's encoders (``TRAIN.NET_E``): the
    trainer's frozen encoders equal the DAMSM checkpoint's; sampling reads
    the generator of ``TRAIN.NET_G``."""
    damsm = cli.pretrain_damsm(_tiny_cfg(tmp_path / "d"), max_steps=2,
                               device="cpu")
    net_e = tmp_path / "d" / "objgan_damsm" / "ckpt"
    cfg = _tiny_cfg(tmp_path / "g", NET_E=str(net_e))
    trainer = cli.train_gan(cfg, max_steps=1, device="cpu")
    out = capsys.readouterr()
    assert f"loaded pretrained DAMSM encoders from {net_e} (step 2)" in \
        out.out
    assert "UNTRAINED" not in out.err
    sd, want = trainer.state_dict(), damsm.state_dict()
    for prefix in ("text_enc.", "img_enc."):
        keys = [k for k in want if k.startswith(prefix)]
        assert keys and all(torch.equal(sd[k], want[k]) for k in keys)
    # G and the discriminators start from RNG_SEED as without NET_E
    fresh = GanTrainer(cfg).init_state(torch.Generator().manual_seed(
        cfg.RNG_SEED))
    assert not torch.equal(fresh.text_enc.embedding.weight,
                           trainer.text_enc.embedding.weight)

    net_g = tmp_path / "g" / "objgan_gan" / "ckpt"
    sample_cfg = cfg.merged({"TRAIN": {"FLAG": False, "NET_G": str(net_g)}})
    cli.sample_gan(sample_cfg, num_batches=1, device="cpu")
    out = capsys.readouterr().out
    assert "no generator checkpoint" not in out and "wrote 2 samples" in out
    cli.sample_gan(sample_cfg.merged({"TRAIN": {"NET_G": str(tmp_path)}}),
                   num_batches=1, device="cpu")
    assert "no generator checkpoint found" in capsys.readouterr().out


def test_gan_trainer_init_state_takes_pretrained_encoders():
    cfg = ttiny("float32")
    enc = DamsmTrainer(cfg).init_state(torch.Generator().manual_seed(9))
    plain = GanTrainer(cfg).init_state(torch.Generator().manual_seed(0))
    loaded = GanTrainer(cfg).init_state(
        torch.Generator().manual_seed(0), enc.text_enc.state_dict(),
        enc.img_enc.state_dict())
    a, b = plain.state_dict(), loaded.state_dict()
    for k, v in enc.state_dict().items():
        if k.startswith(("text_enc.", "img_enc.")):
            assert torch.equal(b[k], v), k
    for k in a:
        if not k.startswith(("text_enc.", "img_enc.")):
            assert torch.equal(a[k], b[k]), k


def test_step_noise_depends_on_the_step_only():
    cfg = ttiny("float32")
    from objgan_tpu_torch.train.common import step_generator

    a = train_noise(cfg, 2, step_generator(100, 7, "cpu"), "cpu")
    b = train_noise(cfg, 2, step_generator(100, 7, "cpu"), "cpu")
    c = train_noise(cfg, 2, step_generator(100, 8, "cpu"), "cpu")
    assert torch.equal(a["z"], b["z"]) and not torch.equal(a["z"], c["z"])


# -- the entry points ---------------------------------------------------------


def _tiny_yml(path, **train):
    cfg = {
        "OUTPUT_DIR": str(path.parent / "out"),
        "TRAIN": {"FLAG": True, "BATCH_SIZE": 2, "SNAPSHOT_STEPS": 2,
                  **train},
        "TREE": {"BASE_SIZE": 16},
        "GAN": {"DF_DIM": 8, "GF_DIM": 8, "Z_DIM": 16, "CONDITION_DIM": 16},
        "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": 6, "VOCAB_SIZE": 50,
                 "HIDDEN_DIM": 16, "GLOVE_DIM": 16},
        "OBJ": {"MAX_OBJECTS": 3, "NUM_CLASSES": 7, "ROI_SIZE": 4,
                "LABEL_DIM": 16, "GMM_COMPONENTS": 4, "SHAPE_SIZE": 16},
    }
    path.write_text(yaml.safe_dump(cfg))
    return path


def _run_module(module, args):
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['{module}'] + sys.argv[1:]\n"
        f"runpy.run_module('{module}', run_name='__main__')\n"
        + FORBIDDEN_MODULES)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_pretrain_damsm_entry_point_without_jax(tmp_path):
    """Checkpoints, the metrics CSV and an attention grid, then a rerun
    that resumes, in processes that import no JAX module."""
    yml = _tiny_yml(tmp_path / "tiny.yml")
    args = ["--cfg", str(yml), "--log_every", "1", "--device", "cpu"]
    proc = _run_module("objgan_tpu_torch.pretrain_damsm",
                       args + ["--max_steps", "2"])
    assert [ln.split("]")[0] for ln in proc.stdout.splitlines()
            if ln.startswith("[step")] == ["[step 1", "[step 2"]
    out = tmp_path / "out" / "objgan_damsm"
    assert sorted(os.listdir(out / "ckpt")) == ["2"]
    assert (out / "attn_step2.png").stat().st_size > 0
    assert len((out / "damsm_metrics.csv").read_text().splitlines()) == 3
    proc = _run_module("objgan_tpu_torch.pretrain_damsm",
                       args + ["--max_steps", "3"])
    assert "resumed from step 2" in proc.stdout
    assert sorted(os.listdir(out / "ckpt")) == ["2", "3"]
    assert len((out / "damsm_metrics.csv").read_text().splitlines()) == 4


def test_gan_main_loads_net_e_without_jax(tmp_path):
    cli.pretrain_damsm(_tiny_cfg(tmp_path / "d"), max_steps=1, device="cpu")
    net_e = tmp_path / "d" / "objgan_damsm" / "ckpt"
    yml = _tiny_yml(tmp_path / "tiny.yml", NET_E=str(net_e))
    proc = _run_module("objgan_tpu_torch.gan_main",
                       ["--cfg", str(yml), "--max_steps", "1", "--device",
                        "cpu"])
    assert (f"loaded pretrained DAMSM encoders from {net_e} (step 1)"
            in proc.stdout)
    assert "UNTRAINED" not in proc.stderr
    assert os.listdir(tmp_path / "out" / "objgan_gan" / "ckpt") == ["1"]


def test_pretrain_damsm_help_names_what_waits(capsys):
    from objgan_tpu_torch import pretrain_damsm

    with pytest.raises(SystemExit):
        pretrain_damsm.main(["--help"])
    assert "--wire" in capsys.readouterr().out
