"""The slice as a whole: the three stages trained in both frameworks and
served from the port's checkpoints, and the port's new entry points.

* Two steps of Stage A, B and C in each framework from the same start
  (JAX's fresh states, carried across by ``core.bridge``), on the same
  batches and noise. The port's trainers are saved as its CLIs save them
  and restored by ``ObjGanPipeline.load_states``: every stage restored, no
  untrained warning. ``run_serve`` with ``output_dir`` serves exactly what
  that pipeline's ``generate`` gives for the same noise, and that matches
  JAX's ``generate`` on its own trained states: labels and validity exact,
  boxes and masks atol 1e-5, images atol 1e-4 (on a key whose layouts are
  not empty; see the test), and on JAX's trained states in both on a key
  that leaves a layout empty.
* ``load_states`` without checkpoints (fresh weights, a warning per
  stage), with ``TRAIN.NET_G``, and with a checkpoint that does not fit.
* A finite feed ends ``train_gan``, ``pretrain_damsm``, ``train_box`` and
  ``train_shape`` with its last step saved.
* ``box_train``, ``box_sample``, ``shape_main`` and ``sample_pipeline`` run
  in subprocesses that import neither JAX nor the JAX package. ``--wire``
  is no longer refused (the wire feed is ported, ``tests/test_torch_wire.py``
  runs it), nor is a JAX (Orbax) checkpoint: their help says they read one.
"""

import csv
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objgan_tpu.data import synthetic as jsyn
from objgan_tpu.pipeline_e2e import ObjGanPipeline as JPipeline
from objgan_tpu.train.box import BoxTrainer as JBoxTrainer
from objgan_tpu.train.gan import GanTrainer as JGanTrainer
from objgan_tpu.train.shape import ShapeTrainer as JShapeTrainer
from objgan_tpu_torch import cli
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.core.checkpoint import CheckpointManager, latest_step_in
from objgan_tpu_torch.data import synthetic as tsyn
from objgan_tpu_torch.data.tokenizer import Vocab
from objgan_tpu_torch.pipeline_e2e import ObjGanPipeline, draw_noise
from objgan_tpu_torch.serving import run_serve
from objgan_tpu_torch.train.box import BoxTrainer
from objgan_tpu_torch.train.gan import GanTrainer
from objgan_tpu_torch.train.shape import ShapeTrainer
from tests.test_torch_data import FORBIDDEN_MODULES
from tests.test_torch_train import _tiny_yml
from tests.torch_parity import (example_batch, jax_states, n, port_cfg,
                                replay_noise, replay_shape_z, t, tiny,
                                to_numpy_tree, torch_to_jax, ttiny)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2
CAPTIONS = ["two dogs play in a park", "a man riding a wave",
            "a cat on a red bus"]


def _port_batch(batch):
    return {k: ([t(x) for x in v] if isinstance(v, list) else t(v))
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Each stage from JAX's fresh state, two steps in each framework; the
    port's trainers saved under ``out`` as the CLIs save them."""
    cfg = tiny("float32")
    out = str(tmp_path_factory.mktemp("compose"))
    pcfg = port_cfg(cfg).merged({"OUTPUT_DIR": out})
    batches = [jax.device_get(jsyn.synthetic_batch(
        cfg, jax.random.PRNGKey(s))) for s in range(1, STEPS + 1)]
    keys = [jax.random.PRNGKey(30 + s) for s in range(STEPS)]
    b = batches[0]["captions"].shape[0]
    layouts = [{k: v for k, v in x.items() if k != "images"}
               for x in batches]
    trained_states = {}
    for name, jt, port in (
            ("box", JBoxTrainer(cfg), BoxTrainer(pcfg)),
            ("shape", JShapeTrainer(cfg), ShapeTrainer(pcfg)),
            ("gan", JGanTrainer(cfg), GanTrainer(pcfg))):
        feed = layouts if name != "gan" else batches
        state = jax.jit(jt.init_state)(jax.random.PRNGKey(0), feed[0])
        bridge.load_jax_state(port, jax.device_get(state))
        step = jax.jit(jt.train_step)
        for batch, key in zip(feed, keys):
            if name == "box":
                state, _ = step(state, batch)
                port.train_step(_port_batch(batch))
            elif name == "shape":
                state, _ = step(state, batch, key)
                port.train_step(_port_batch(batch),
                                replay_shape_z(cfg, key, b))
            else:
                state, _ = step(state, batch, key)
                k_z, k_ca = jax.random.split(key)
                port.train_step(
                    _port_batch(batch),
                    t(jax.random.normal(k_z, (b, cfg.GAN.Z_DIM))),
                    t(jax.random.normal(k_ca, (b, cfg.GAN.CONDITION_DIM))))
        trained_states[name] = state
        CheckpointManager(os.path.join(out, f"objgan_{name}", "ckpt")).save(
            port.step, port)
    generate = jax.jit(lambda p, c, l, r: JPipeline(cfg).generate(
        jax_states(p), c, l, r))
    return {"cfg": cfg, "pcfg": pcfg, "out": out, "jax": trained_states,
            "generate": generate}


def test_load_states_restores_every_stage(trained, capsys):
    pipe = ObjGanPipeline.load_states(trained["pcfg"], device="cpu")
    got = capsys.readouterr()
    assert "UNTRAINED" not in got.err
    for name in ("box", "shape", "gan"):
        assert f"restored the {name} stage from" in got.out
        assert f"(step {STEPS})" in got.out
    # each stage's modules hold its trainer's weights (gan: the EMA G)
    out = trained["out"]
    for name, module, prefix in (("box", pipe.box, "model."),
                                 ("shape", pipe.shape.g, "g."),
                                 ("gan", pipe.gan.g_net, "ema_g.")):
        saved = torch.load(os.path.join(out, f"objgan_{name}", "ckpt",
                                        str(STEPS), "state.pt"),
                           weights_only=True)
        for k, v in module.state_dict().items():
            assert torch.equal(v, saved[prefix + k]), (name, k)


def test_served_images_come_from_the_checkpoints(trained, tmp_path,
                                                 monkeypatch):
    """``run_serve`` with ``output_dir`` serves what ``load_states``'
    pipeline generates for the same noise, to the bit."""
    pcfg = trained["pcfg"].merged({"OUTPUT_DIR": str(tmp_path / "none")})
    vocab = Vocab.build(CAPTIONS)
    outs = []
    generate = ObjGanPipeline.generate

    def recording(self, *args, **kwargs):
        out = generate(self, *args, **kwargs)
        outs.append(out)
        return out

    monkeypatch.setattr(ObjGanPipeline, "generate", recording)
    responses = []
    stats = run_serve(pcfg, vocab, [{"id": i, "caption": c}
                                    for i, c in enumerate(CAPTIONS)],
                      str(tmp_path / "served"), batch_size=2,
                      emit=responses.append, device="cpu",
                      output_dir=trained["out"])
    monkeypatch.undo()
    assert stats["requests"] == 3 and len(outs) == 2
    assert all(os.path.getsize(r["image"]) > 0 for r in responses)
    pipe = ObjGanPipeline.load_states(pcfg, trained["out"], "cpu")
    ids, lens = vocab.encode_batch(CAPTIONS[:2], pcfg.TEXT.WORDS_NUM)
    noise = draw_noise(pcfg, 2, torch.Generator().manual_seed(
        pcfg.RNG_SEED), "cpu")
    want = pipe.generate(torch.from_numpy(ids).long(),
                         torch.from_numpy(lens).long(), noise)
    for key in ("labels", "boxes", "obj_valid", "masks"):
        assert torch.equal(outs[0][key], want[key]), key
    for g, w in zip(outs[0]["images"], want["images"]):
        assert torch.equal(g, w)
    labels, valid = n(want["labels"]), n(want["obj_valid"])
    assert [lab for lab, _ in responses[0]["objects"]] == [
        int(lab) for lab, v in zip(labels[0], valid[0]) if v]


def _jax_params(states):
    """The parts of JAX's stage states that ``generate`` reads, as numpy
    trees in ``torch_parity.jax_states``' layout."""
    return to_numpy_tree({
        "box": states["box"].params, "shape_g": states["shape"].g_params,
        "shape_label_table": states["shape"].label_table,
        "gan_g": states["gan"].ema_g_params,
        "text": states["gan"].text_params,
        "gan_label_table": states["gan"].label_table})


def _port_params(pipe, template):
    """The port pipeline's weights as JAX trees shaped like
    ``template`` (``_jax_params``' layout)."""
    return {
        "box": torch_to_jax(pipe.box, template["box"]),
        "shape_g": torch_to_jax(pipe.shape.g, template["shape_g"]),
        "shape_label_table": n(pipe.shape.label_table),
        "gan_g": torch_to_jax(pipe.gan.g_net, template["gan_g"]),
        "text": torch_to_jax(pipe.gan.text_enc, template["text"]),
        "gan_label_table": n(pipe.gan.label_table)}


def _generate_both(trained, pipe, seed, params=None):
    """(port, JAX) outputs of ``generate`` for example captions and JAX's
    noise from PRNGKey(seed), JAX on ``params`` (``_jax_params``' layout;
    its own trained states by default), and whether the port's layout
    canvas (the input of Stage C's layout encoder) is empty, per row."""
    cfg = trained["cfg"]
    caps, lens = example_batch(cfg, batch=2, seed=4)
    rng = jax.random.PRNGKey(seed)
    if params is None:
        params = _jax_params(trained["jax"])
    want = trained["generate"](params, jnp.asarray(caps), jnp.asarray(lens),
                               rng)
    canvases = []
    hook = pipe.gan.g_net.layout_enc.register_forward_pre_hook(
        lambda mod, args: canvases.append(args[0].detach().clone()))
    try:
        got = pipe.generate(t(caps), t(lens), replay_noise(cfg, rng, 2))
    finally:
        hook.remove()
    empty = [not bool(c.any()) for c in canvases[0]]
    return got, want, empty


def _assert_outputs_close(got, want, image_atol=1e-4):
    np.testing.assert_array_equal(n(got["labels"]), n(want["labels"]))
    np.testing.assert_array_equal(n(got["obj_valid"]), n(want["obj_valid"]))
    assert n(got["obj_valid"]).sum() >= 1
    for key in ("boxes", "masks"):
        np.testing.assert_allclose(n(got[key]), n(want[key]), rtol=0,
                                   atol=1e-5, err_msg=key)
    for g, w in zip(got["images"], want["images"]):
        np.testing.assert_allclose(n(g), n(w), rtol=0, atol=image_atol)


def _image_gap(a, b):
    return max(float(np.abs(n(x) - n(y)).max())
               for x, y in zip(a["images"], b["images"]))


def test_trained_pipeline_matches_jax(trained):
    """The port's pipeline from its trained checkpoints against JAX's
    ``generate`` on JAX's trained states, with JAX's noise, on a key whose
    layout canvases are not empty. (An empty canvas is ill-conditioned in
    the reference itself: the next test.)"""
    pipe = ObjGanPipeline.load_states(trained["pcfg"], device="cpu")
    got, want, empty = _generate_both(trained, pipe, seed=1)
    assert not any(empty)
    _assert_outputs_close(got, want)


def test_trained_pipeline_on_empty_canvases(trained):
    """On a key that leaves a row's layout canvas empty (its boxes off the
    canvas or of zero area, which the two-step Stage A of this tiny config
    emits), Stage C's layout encoder normalises groups of variance far
    below GroupNorm's eps, and its output follows GroupNorm biases of
    ~1e-7. The two frameworks' trained weights lie within the step tests'
    1e-5 of each other, yet their images there lie beyond 1e-4. Witnesses
    that the gap is the reference's own response to that weight
    difference, not the port's:

    * JAX's ``generate`` on the port's trained weights (carried back by
      ``torch_to_jax``) gives the port's outputs to 1e-4: the same function
      on the same weights;
    * JAX's images from its own trained weights lie no farther from the
      port's than JAX's own images move, in JAX alone, between the two
      sets of weights (plus 1e-4)."""
    pipe = ObjGanPipeline.load_states(trained["pcfg"], device="cpu")
    own = _jax_params(trained["jax"])
    ported = _port_params(pipe, own)
    weight_gap = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(ported), jax.tree.leaves(own)))
    assert weight_gap <= 1e-5
    got, want, empty = _generate_both(trained, pipe, seed=8)
    assert any(empty)
    _, want_ported, _ = _generate_both(trained, pipe, 8, ported)
    _assert_outputs_close(got, want_ported)
    _assert_outputs_close(got, want, image_atol=np.inf)
    gap, moved = _image_gap(got, want), _image_gap(want_ported, want)
    print(f"weights {weight_gap:.3g} apart; images: port vs JAX {gap:.3g}, "
          f"JAX on the port's weights vs JAX {moved:.3g}")
    assert gap <= moved + 1e-4


def test_pipeline_on_jax_trained_states_matches_jax(trained):
    """JAX's trained states in the port's pipeline: the same function as
    JAX's ``generate``, on a key that leaves a row's canvas empty."""
    states = {k: to_numpy_tree(v) for k, v in trained["jax"].items()}
    pipe = ObjGanPipeline(trained["pcfg"])
    pipe.load_jax_params(states["box"].params, states["shape"].g_params,
                         states["shape"].label_table,
                         states["gan"].ema_g_params,
                         states["gan"].text_params,
                         states["gan"].label_table)
    got, want, empty = _generate_both(trained, pipe, seed=8)
    assert any(empty)
    _assert_outputs_close(got, want)


def test_load_states_without_checkpoints_warns_per_stage(tmp_path, capsys):
    cfg = ttiny("float32", OUTPUT_DIR=str(tmp_path))
    pipe = ObjGanPipeline.load_states(cfg, device="cpu")
    err = capsys.readouterr().err
    for name in ("box", "shape", "gan"):
        assert f"no {name} checkpoint under" in err
    assert err.count("UNTRAINED") == 3
    fresh = ObjGanPipeline.fresh(cfg, cfg.RNG_SEED, "cpu")
    for k, v in fresh.state_dict().items():
        assert torch.equal(pipe.state_dict()[k], v), k


def test_load_states_reads_net_g_and_refuses_a_misfit(trained, tmp_path,
                                                      capsys):
    """The gan stage from ``TRAIN.NET_G``; a box checkpoint of another
    width is not loaded, and the stage says so."""
    pcfg = trained["pcfg"].merged({
        "OUTPUT_DIR": str(tmp_path),
        "TRAIN": {"NET_G": os.path.join(trained["out"], "objgan_gan",
                                        "ckpt")}})
    wide = BoxTrainer(pcfg.merged({"BOX": {"RNN_SIZE": 48}}))
    CheckpointManager(str(tmp_path / "objgan_box" / "ckpt")).save(1, wide)
    ObjGanPipeline.load_states(pcfg, device="cpu")
    got = capsys.readouterr()
    assert "restored the gan stage from" in got.out
    assert "the box checkpoint at step 1" in got.err
    assert "does not fit" in got.err
    assert "no shape checkpoint under" in got.err


# -- a bounded feed -------------------------------------------------------


@pytest.mark.parametrize("stage", ["gan", "damsm", "box", "shape"])
def test_finite_feed_ends_the_run_with_its_last_step_saved(tmp_path, stage):
    cfg = ttiny("float32", OUTPUT_DIR=str(tmp_path),
                TRAIN={"SNAPSHOT_STEPS": 100})
    with_images = stage in ("gan", "damsm")
    feed = iter([tsyn.synthetic_batch(cfg, torch.Generator().manual_seed(s),
                                      with_images=with_images)
                 for s in range(3)])
    run = {"gan": cli.train_gan, "damsm": cli.pretrain_damsm,
           "box": cli.train_box, "shape": cli.train_shape}[stage]
    trainer = run(cfg, feed, max_steps=10, device="cpu", log_every=10)
    assert trainer.step == 3
    assert latest_step_in(str(tmp_path / f"objgan_{stage}" / "ckpt")) == 3
    # rows at the first step and at the saved last one, between log_every
    with open(tmp_path / f"objgan_{stage}" / f"{stage}_metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [1, 3]


# -- the entry points -----------------------------------------------------


def _entry_args(name, yml, tmp_path):
    return {
        "box_train": ["--cfg", yml, "--max_steps", "2", "--log_every", "1"],
        "box_sample": ["--cfg", yml, "--caption", "two dogs",
                       "--beam_size", "2"],
        "shape_main": ["--cfg", yml, "--max_steps", "2", "--log_every",
                       "1"],
        "sample_pipeline": ["--cfg", yml, "--caption", "two dogs",
                            "--out", str(tmp_path / "pipe")],
    }[name] + ["--device", "cpu"]


@pytest.mark.parametrize("name", ["box_train", "box_sample", "shape_main",
                                  "sample_pipeline"])
def test_entry_point_runs_without_jax(tmp_path, name):
    yml = str(_tiny_yml(tmp_path / "tiny.yml", True))
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{name!r}] + sys.argv[1:]\n"
        f"runpy.run_module('objgan_tpu_torch.{name}', run_name='__main__')\n"
        + FORBIDDEN_MODULES)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", code, *_entry_args(name, yml, tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    if name in ("box_train", "shape_main"):
        lines = [ln for ln in out.splitlines() if ln.startswith("[step")]
        assert [ln.split("]")[0] for ln in lines] == ["[step 1", "[step 2"]
        stage = "box" if name == "box_train" else "shape"
        assert latest_step_in(str(tmp_path / "out" / f"objgan_{stage}" /
                                  "ckpt")) == 2
    elif name == "box_sample":
        assert "'two dogs' -> [" in out
        assert "no box checkpoint under" in out
    else:
        assert os.listdir(tmp_path / "pipe") == ["pipe_0.png"]
        assert "'two dogs' ->" in out and "UNTRAINED" in proc.stderr


@pytest.mark.parametrize("module", ["box_train", "box_sample",
                                    "shape_main"])
def test_wire_is_refused(module, capsys):
    """``--wire`` is accepted now, and nothing is refused: the help's
    epilog says the stage resumes from the port's step or a JAX run's Orbax
    step, and writes the port's only."""
    import importlib

    main = importlib.import_module(f"objgan_tpu_torch.{module}").main
    with pytest.raises(SystemExit) as exc:
        main(["--wire", "--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "compact uint8 wire batches" in out
    assert "refused" not in out and "wire feed" not in out
    assert "ROADMAP.md" not in out and "Not ported" not in out
    words = " ".join(out.split())
    assert "JAX run's Orbax step" in words and "writes state.pt only" in words


def test_box_sample_eval_and_shape_eval_run_on_cpu(tmp_path, capsys):
    """``box_sample --eval`` and ``shape_main --eval`` on synthetic
    batches print their metrics."""
    from objgan_tpu_torch import box_sample, shape_main

    yml = str(_tiny_yml(tmp_path / "tiny.yml", True))
    box_sample.main(["--cfg", yml, "--eval", "--num_batches", "2",
                     "--device", "cpu"])
    shape_main.main(["--cfg", yml, "--eval", "--num_batches", "2",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    for key in ("heldout_box_nll", "sample_matched_iou", "beam_match_rate",
                "mask_iou", "area_ratio"):
        assert f"{key}: " in out
