"""The trainers and entry points of the port on wire batches, at the tiny
fp32 config on a 12-record procedural manifest (64 px).

* One DAMSM step and one Stage-B step on a wire batch of JAX's
  ``CocoFeed(wire=True)``, port against JAX: the loss terms and every
  gradient, then the metrics and the parameters after the step, at the
  tolerances of ``tests/test_torch_damsm.py`` and
  ``tests/test_torch_shape.py``.
* Stage C: the port's ``train_step`` on a wire batch equals, to the bit,
  its step on ``from_wire`` of it.
* The entry points with the feed flags: ``gan_main --wire --grain`` (in a
  process that imports neither JAX, Grain nor the JAX package), and
  ``gan_main``, ``pretrain_damsm`` (a snapshot at step 1: its grid from
  ``image_u8``), ``box_train`` and ``shape_main`` with ``--wire`` take 2
  steps; ``shape_main --eval --wire`` scores classic batches; ``eval
  --grain`` one batch; ``profile_feed --wire --device cpu`` prints its
  stages.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from objgan_tpu.data import pipeline as jpipe
from objgan_tpu.data.tokenizer import Vocab as JVocab
from objgan_tpu.train.damsm import DamsmTrainer as JDamsmTrainer
from objgan_tpu.train.shape import ShapeTrainer as JShapeTrainer
from objgan_tpu_torch import cli
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.data import pipeline as tpipe
from objgan_tpu_torch.data.procedural import build_manifest
from objgan_tpu_torch.data.tokenizer import Vocab as TVocab
from objgan_tpu_torch.data.wire import from_wire
from objgan_tpu_torch.train.damsm import DamsmTrainer
from objgan_tpu_torch.train.gan import GanTrainer
from objgan_tpu_torch.train.shape import ShapeTrainer
from tests.test_torch_damsm import _jax_keep_mask
from tests.test_torch_data import FORBIDDEN_MODULES
from tests.torch_parity import (n, port_cfg, replay_shape_z, tiny,
                                to_numpy_tree)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    return build_manifest(str(tmp_path_factory.mktemp("proc")), n_images=12,
                          size=64, seed=0)


def _cfg(manifest):
    return tiny("float32", DATA_DIR=os.path.dirname(manifest),
                OBJ={"NUM_CLASSES": 81}, TEXT={"VOCAB_SIZE": 500})


def _jax_wire_batch(manifest, **kw):
    cfg = _cfg(manifest)
    records = jpipe.load_records_json(manifest)
    vocab = JVocab.build(c for r in records for c in r["captions"])
    batch = next(iter(jpipe.CocoFeed(cfg, records, vocab, seed=1, wire=True,
                                     **kw)))
    return cfg, batch


def _on_cpu(batch):
    """The batch as the port's trainers get it (``cli.to_device``)."""
    return cli.to_device(batch, "cpu")


def test_damsm_step_on_a_wire_batch_matches_jax(manifest):
    cfg, batch = _jax_wire_batch(manifest, with_masks=False)
    assert "image_u8" in batch and "images" not in batch
    jt = JDamsmTrainer(cfg)
    state = jt.init_state(jax.random.PRNGKey(0), batch)
    key = jax.random.PRNGKey(5)
    mask = _jax_keep_mask(jt, state.text_params, batch, key)
    (_, aux), (tg, ig) = jax.jit(jax.value_and_grad(
        jt.loss, argnums=(0, 1), has_aux=True))(
        state.text_params, state.img_params, batch, key)
    stepped, metrics = jax.jit(jt.train_step)(state, batch, key)

    trainer = DamsmTrainer(port_cfg(cfg))
    bridge.load_jax_state(trainer, to_numpy_tree(state))
    grads, got = trainer.grads(_on_cpu(batch), mask)
    for k, w in aux.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-5,
                                   err_msg=k)
    want = {}
    for prefix, tree in (("text_enc.", tg), ("img_enc.", ig)):
        want.update({prefix + k: v for k, v in
                     bridge.jax_to_torch(jax.device_get(tree)).items()})
    assert set(grads) == set(want)
    for k, w in want.items():
        scale = np.abs(w).max()
        assert scale > 0, k
        assert np.abs(n(grads[k]) - w).max() <= 1e-4 * scale + 1e-6, k

    trainer = DamsmTrainer(port_cfg(cfg))
    bridge.load_jax_state(trainer, to_numpy_tree(state))
    got = trainer.train_step(_on_cpu(batch), mask)
    for k, w in metrics.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-4,
                                   err_msg=k)
    sd, final = trainer.state_dict(), to_numpy_tree(stepped)
    for prefix, field in (("text_enc.", "text_params"),
                          ("img_enc.", "img_params")):
        w0 = bridge.jax_to_torch(getattr(to_numpy_tree(state), field))
        for k, w in bridge.jax_to_torch(getattr(final, field)).items():
            err = np.abs(n(sd[prefix + k]) - w)
            assert (err > 1e-6).mean() <= 1e-3, prefix + k
            assert (np.linalg.norm(err)
                    <= 1e-2 * np.linalg.norm(w - w0[k])), prefix + k


def test_shape_step_on_a_wire_batch_matches_jax(manifest):
    cfg, batch = _jax_wire_batch(manifest, with_images=False)
    assert "shapes_u8" in batch and "shapes" not in batch
    jt = JShapeTrainer(cfg)
    state = jax.jit(jt.init_state)(jax.random.PRNGKey(0), batch)
    key = jax.random.PRNGKey(21)
    (gg, dg), aux = jax.jit(jax.grad(
        lambda g, d: jt._losses(g, d, state, batch, key),
        argnums=(0, 1), has_aux=True))(state.g_params, state.d_params)
    stepped, metrics = jax.jit(jt.train_step)(state, batch, key)
    z = replay_shape_z(cfg, key, batch["labels"].shape[0])

    trainer = ShapeTrainer(port_cfg(cfg))
    bridge.load_jax_state(trainer, to_numpy_tree(state))
    grads, got = trainer.grads(_on_cpu(batch), z)
    for k, w in aux.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=2e-5,
                                   atol=0, err_msg=k)
    want = {}
    for prefix, tree in (("g.", gg), ("d.", dg)):
        want.update({prefix + k: v for k, v in bridge.jax_to_torch(
            jax.device_get(tree)).items()})
    assert set(grads) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1.0)
        assert np.abs(n(grads[k]) - w).max() <= 2e-5 * scale, k

    trainer = ShapeTrainer(port_cfg(cfg))
    bridge.load_jax_state(trainer, to_numpy_tree(state))
    got = trainer.train_step(_on_cpu(batch), z)
    for k, w in metrics.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=2e-5,
                                   atol=0, err_msg=k)
    final = to_numpy_tree(stepped)
    want = {}
    for prefix, params, opt in (("g.", final.g_params, final.g_opt),
                                ("d.", final.d_params, final.d_opt)):
        want.update({prefix + k: v for k, v in
                     bridge.jax_to_torch(params).items()})
        adam = bridge._scale_by_adam(opt)
        for key_, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            want.update({f"optim.{prefix}{k}.{key_}": v
                         for k, v in bridge.jax_to_torch(tree).items()})
    sd = trainer.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(n(sd[k]), w, rtol=0, atol=1e-5,
                                   err_msg=k)


def test_gan_step_on_a_wire_batch_equals_the_expanded_batch(manifest):
    cfg = port_cfg(_cfg(manifest))
    records = tpipe.load_records_json(manifest)
    vocab = TVocab.build(c for r in records for c in r["captions"])
    wire = _on_cpu(next(iter(tpipe.CocoFeed(cfg, records, vocab, seed=2,
                                            wire=True))))
    assert {"image_u8", "shapes_u8"} <= set(wire)
    gen = torch.Generator().manual_seed(3)
    z, eps = torch.randn(2, 16, generator=gen), torch.randn(2, 16,
                                                            generator=gen)
    results = []
    for batch in (wire, from_wire(cfg, wire)):
        trainer = GanTrainer(cfg).init_state(torch.Generator().manual_seed(1))
        metrics = trainer.train_step(batch, z, eps)
        results.append((metrics, trainer.state_dict()))
    (m_wire, sd_wire), (m_classic, sd_classic) = results
    assert set(m_wire) == set(m_classic)
    for k in m_wire:
        assert torch.equal(m_wire[k], m_classic[k]), k
    for k in sd_wire:
        assert torch.equal(sd_wire[k], sd_classic[k]), k


# -- the entry points with --wire / --grain -----------------------------------


def _yml(tmp_path, manifest, **train):
    cfg = {
        "OUTPUT_DIR": str(tmp_path / "out"), "CONFIG_NAME": "w",
        "DATA_DIR": os.path.dirname(manifest), "WORKERS": 1,
        "TRAIN": {"FLAG": True, "BATCH_SIZE": 2, **train},
        "TREE": {"BASE_SIZE": 16},
        "GAN": {"DF_DIM": 8, "GF_DIM": 8, "Z_DIM": 16, "CONDITION_DIM": 16},
        "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": 6, "VOCAB_SIZE": 200,
                 "HIDDEN_DIM": 16, "GLOVE_DIM": 16},
        "OBJ": {"MAX_OBJECTS": 3, "NUM_CLASSES": 81, "ROI_SIZE": 4,
                "LABEL_DIM": 16, "GMM_COMPONENTS": 4, "SHAPE_SIZE": 16},
        "BOX": {"RNN_SIZE": 32, "INPUT_ENCODING_SIZE": 16,
                "ATT_HID_SIZE": 16, "MAX_SEQ_LENGTH": 4},
        "SHAPE": {"GF_DIM": 8, "DF_DIM": 8, "HIDDEN_DIM": 8},
    }
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _steps(out):
    return [ln.split("]")[0] for ln in out.splitlines()
            if ln.startswith("[step")]


def test_gan_main_wire_grain_without_jax(tmp_path, manifest):
    """``--wire --grain``: wire batches from a worker process, two steps."""
    yml = _yml(tmp_path, manifest)
    code = (
        "import runpy, sys\n"
        "sys.argv = ['gan_main'] + sys.argv[1:]\n"
        "runpy.run_module('objgan_tpu_torch.gan_main', run_name='__main__')\n"
        + FORBIDDEN_MODULES)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--cfg", yml, "--manifest", manifest,
         "--wire", "--grain", "--max_steps", "2", "--log_every", "1",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert _steps(proc.stdout) == ["[step 1", "[step 2"]


@pytest.mark.parametrize("module", ["gan_main", "pretrain_damsm",
                                    "box_train", "shape_main"])
def test_trainer_entry_point_with_wire(tmp_path, manifest, module, capsys):
    import importlib

    main = importlib.import_module(f"objgan_tpu_torch.{module}").main
    main(["--cfg", _yml(tmp_path, manifest, SNAPSHOT_STEPS=1),
          "--manifest", manifest, "--wire", "--max_steps", "2",
          "--log_every", "1", "--device", "cpu"])
    assert _steps(capsys.readouterr().out) == ["[step 1", "[step 2"]
    stage = {"gan_main": "gan", "pretrain_damsm": "damsm",
             "box_train": "box", "shape_main": "shape"}[module]
    out = tmp_path / "out" / f"w_{stage}"
    assert sorted(os.listdir(out / "ckpt")) == ["1", "2"]
    if module in ("gan_main", "pretrain_damsm"):
        # the snapshots' grids: DAMSM's background from image_u8
        assert "attn_step1.png" in os.listdir(out)
        assert "attn_step2.png" in os.listdir(out)


def test_shape_eval_with_wire_reads_classic_batches(tmp_path, manifest,
                                                    capsys):
    from objgan_tpu_torch import shape_main

    shape_main.main(["--cfg", _yml(tmp_path, manifest), "--manifest",
                     manifest, "--wire", "--eval", "--num_batches", "2",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert "mask_iou:" in out and "n_objects:" in out


def test_eval_grain_one_batch(tmp_path, manifest, capsys):
    from objgan_tpu_torch import eval as eval_main

    eval_main.main(["--cfg", _yml(tmp_path, manifest, FLAG=False),
                    "--manifest", manifest, "--grain", "--num_batches", "1",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "eval over 2 samples" in out
    fid = [ln for ln in out.splitlines() if ln.startswith("FID: ")]
    assert len(fid) == 1 and np.isfinite(float(fid[0].split()[1]))


def test_profile_feed_wire_on_cpu(tmp_path, manifest, capsys):
    from objgan_tpu_torch.tools import profile_feed

    profile_feed.main(["--cfg", _yml(tmp_path, manifest), "--manifest",
                       manifest, "--wire", "--reps", "1", "--device",
                       "cpu"])
    out = capsys.readouterr().out
    for stage in ("1. record transform", "2. batch assembly",
                  "3. K=1 stack", "4. host->device (cpu)"):
        assert stage in out, (stage, out)
    # a wire batch of 2: 2 x 64 x 64 x 3 image bytes and 2 x 3 x 16 x 16
    # mask bytes, far below the fp32 pyramid's 2 x (16² + 32² + 64²) x 12
    mb = float(out.split(" MB -> ")[0].rsplit(" ", 1)[1])
    assert 0.02 < mb < 0.05
