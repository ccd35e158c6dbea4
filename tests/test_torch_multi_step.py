"""``TRAIN.STEPS_PER_EXECUTION`` in the port: K train steps per execution
(``train/common.py::MultiStep``), the K-step loop and its prefetching feed
(``cli._run_loop``, ``cli.PrefetchFeed``), on the CPU at the tiny fp32
config.

* Each trainer's ``multi_train_step`` against the JAX package's, from the
  same state (the stage's tiny Orbax step of
  ``tests/data/orbax_fixtures.tar.xz``, restored by each package), on the
  same K = 2 stacked batches, with JAX's inner keys (``split`` of the
  execution's key) replayed as the port's injected noise: every entry of
  the state dict after it (each parameter, Adam moment and count, the
  step) within 1e-5 element by element or within the stage's
  relative-norm limit (``card_check.STATE_RTOL``: 2e-3 Stage C, 1e-4 the
  others), as a restored step is held in ``tests/test_torch_orbax.py``;
  each K-meaned metric within 1e-5 relative, Stage C's within its
  single-step limit 1e-4. Both are tighter than JAX's own
  scan-against-sequential test (``tests/test_train.py``: rtol 3e-3, atol
  1e-4). Stage C runs at learning rates of 1e-8 here: at its configured
  2e-4 the two packages' G Adam moments part past the one-step limit
  within two steps, one K = 2 execution or two single steps alike
  (Adam's sign-like step moves each weight by about the learning rate,
  and the tiled fixture's large G gradients, moments ~700 as
  ``tests/test_torch_orbax.py`` notes, answer that move by more than the
  one-step limit); at 1e-8 the second step's
  gradients come from the first step's iterate within the one-step
  limits, and what is compared is the K-step machinery: the inner steps'
  order, batches and noise, Adam's bias corrections at two counts, the
  EMA twice and the metric means.
* The K-axis mean, as ``tests/test_runner_loop.py`` holds JAX's.
* ``cli._run_loop`` against JAX's ``_run_loop`` with the same K, feed
  length, ``max_steps`` and ``SNAPSHOT_STEPS``, on counting trainers: the
  final step, the saved steps, the snapshot steps; the ragged tail stops
  at ``max_steps``, a bounded feed's partial stack is not dropped, and a
  resume continues the count. A K-step run draws each step's noise as
  single steps do.
* Through ``cli.train_box`` and ``cli.train_shape``: a K = 4 run's
  ``state.pt`` resumed by a K = 1 run equals an unbroken K = 1 run, and a
  resume in the middle of an execution equals an unbroken K = 4 run, to
  the bit.
* ``PrefetchFeed``: a raising feed reaches the consumer as
  ``RuntimeError`` from its error within a timeout; an early stop ends
  the thread and leaves the feed the caller's.
* ``box_train`` with K = 2 in a process that imports neither JAX nor the
  JAX package; ``profile_feed``'s K-stack line.

The file runs in about a minute on 2 threads (the four JAX K-step
programs compile once each, module-scoped)."""

import os
import shutil
import subprocess
import sys
import threading
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import yaml

from objgan_tpu_torch import cli
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.core.checkpoint import CheckpointManager, load_latest
from objgan_tpu_torch.data import synthetic as tsyn
from objgan_tpu_torch.train import card_check
from objgan_tpu_torch.train.common import MultiStep, Trainer
from tests.make_orbax_fixtures import jax_trainer
from tests.test_torch_damsm import _jax_keep_mask
from tests.test_torch_data import FORBIDDEN_MODULES
from tests.test_torch_orbax import (METRIC_RTOL, STEP, _tiny_step,  # noqa
                                    fixtures)
from tests.torch_parity import replay_shape_z, tiny, to_numpy_tree, ttiny

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 2
STAGES = ("gan", "damsm", "box", "shape")
# each K-meaned metric against JAX's, relative: 1e-5, and Stage C's
# single-step limit (tests/test_torch_train.py), which no mean of its steps
# can beat
K_METRIC_RTOL = {"gan": METRIC_RTOL["gan"], "damsm": 1e-5, "box": 1e-5,
                 "shape": 1e-5}
# Stage C's learning rates in this comparison (see the module docstring)
GAN_LR = 1e-8


def _cfgs(stage):
    over = ({"TRAIN": {"GENERATOR_LR": GAN_LR, "DISCRIMINATOR_LR": GAN_LR}}
            if stage == "gan" else {})
    return tiny("float32", **over), ttiny("float32", **over)


# -- each trainer's K steps against JAX's multi_train_step ---------------------


def _batches(stage, tcfg):
    """K synthetic batches of ``stage`` (the port's generator, seeded),
    as numpy; DAMSM's with its finest scale only."""
    out = []
    for i in range(K):
        b = tsyn.synthetic_batch(tcfg, torch.Generator().manual_seed(40 + i),
                                 with_images=stage in ("gan", "damsm"))
        b = {k: ([x.numpy() for x in v] if isinstance(v, list) else
                 v.numpy()) for k, v in b.items()}
        if stage == "damsm":
            b["images"] = [b["images"][-1]]
        out.append(b)
    return out


def _inner_noise(stage, jt, state, batch, key):
    """The noise JAX's train_step draws from ``key``, as the port's
    ``train_step`` arguments."""
    cfg, b = jt.cfg, batch["captions"].shape[0]
    if stage == "gan":
        k_z, k_ca = jax.random.split(key)
        return (torch.from_numpy(np.asarray(jax.random.normal(
                    k_z, (b, cfg.GAN.Z_DIM)))),
                torch.from_numpy(np.asarray(jax.random.normal(
                    k_ca, (b, cfg.GAN.CONDITION_DIM)))))
    if stage == "damsm":
        return (_jax_keep_mask(jt, state.text_params, batch, key),)
    if stage == "shape":
        return (replay_shape_z(cfg, key, b),)
    return (None,)  # Stage A: no scheduled sampling at the tiny config


@pytest.fixture(scope="module")
def jax_multi(fixtures, tmp_path_factory):
    """stage -> (port trainer, stacked batches, stacked noise, JAX's state
    dict after its K-step execution, JAX's metrics), both packages starting
    from the stage's tiny Orbax step (step 1000, moments of a trained
    run's size), restored by each."""
    from objgan_tpu.core import checkpoint as jckpt

    done = {}

    def run(stage):
        if stage in done:
            return done[stage]
        cfg, tcfg = _cfgs(stage)
        batches = _batches(stage, tcfg)
        jt = jax_trainer(stage, cfg)
        template = jax.eval_shape(jt.init_state, jax.random.PRNGKey(0),
                                  batches[0])
        d = tmp_path_factory.mktemp(f"jax_{stage}") / "ckpt"
        shutil.copytree(_tiny_step(fixtures, stage).parent, d)
        state = jckpt.restore_latest(jckpt.make_manager(str(d)), template)
        trainer = card_check._orbax_trainer(stage, tcfg)
        assert CheckpointManager(str(_tiny_step(fixtures, stage).parent)
                                 ).restore_latest(trainer) == STEP
        stacked = jax.tree.map(lambda *xs: np.stack(xs), *batches)
        rng = jax.random.PRNGKey(9)
        new, metrics = jt.jitted_multi_step(donate=False)(state, stacked,
                                                          rng)
        # the scan body's key chain: key, sub = split(key) per inner step
        noises, key = [], rng
        for b in batches:
            key, sub = jax.random.split(key)
            noises.append(_inner_noise(stage, jt, state, b, sub))
        want = bridge.jax_state_dict(card_check._orbax_trainer(stage, tcfg),
                                     to_numpy_tree(new))
        done[stage] = (trainer, cli.stack_batches(batches),
                       cli.stack_noise(noises), want,
                       {k: float(v) for k, v in metrics.items()})
        return done[stage]

    return run


@pytest.mark.parametrize("stage", STAGES)
def test_multi_train_step_matches_jax(jax_multi, stage):
    trainer, batches, noises, want, want_m = jax_multi(stage)
    metrics = trainer.multi_train_step(batches, noises)
    assert trainer.step == STEP + K
    assert set(metrics) == set(want_m)
    for k, w in want_m.items():
        assert metrics[k].shape == () and metrics[k].dtype == torch.float32
        np.testing.assert_allclose(float(metrics[k]), w,
                                   rtol=K_METRIC_RTOL[stage], atol=1e-7,
                                   err_msg=k)
    got = trainer.state_dict()
    assert sorted(got) == sorted(want)
    err = card_check.state_errors(stage, got, want)
    assert not err["misfits"], err
    assert int(got["step"]) == STEP + K


# -- the executor on its own -----------------------------------------------------


class Counting(Trainer):
    """A trainer that counts: its step's metric is the batch's value, its
    noise a uniform draw, every call recorded."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(1))
        self.seen = []

    def optimizers(self):
        return []

    def step_noise(self, batch, generator):
        return (torch.rand((), generator=generator,
                           device=generator.device),)

    def train_step(self, batch, u):
        self.seen.append((self.step, float(np.asarray(batch["x"])[0, 0]),
                          float(u)))
        self.step += 1
        return {"loss": torch.as_tensor(np.asarray(batch["x"])).float()
                .mean()}


def test_multi_step_metrics_are_k_axis_mean():
    """Mirror of ``tests/test_runner_loop.py``'s JAX case."""
    tr = Counting()
    x = torch.arange(4, dtype=torch.float32)[:, None, None].expand(4, 1, 1)
    metrics = MultiStep(tr)({"x": x}, (torch.zeros(4),))
    assert tr.step == 4
    np.testing.assert_allclose(float(metrics["loss"]), 1.5)  # mean(0..3)
    assert metrics["loss"].dtype == torch.float32


def test_multi_step_refuses_another_layout():
    tr = Counting()
    ms = tr.multi_step()
    ms({"x": torch.zeros(2, 1, 1)}, (torch.zeros(2),))
    assert ms.fits({"x": torch.ones(2, 1, 1)}, (torch.zeros(2),))
    other = ({"x": torch.zeros(2, 3, 1)}, (torch.zeros(2),))
    assert not ms.fits(*other)
    with pytest.raises(ValueError, match="single steps"):
        ms(*other)


# -- the loop against JAX's ------------------------------------------------------


class _JState(NamedTuple):
    step: jnp.ndarray


def _jax_run(cfg, start, n_feed, max_steps, monkeypatch):
    """JAX's ``_run_loop`` on counting step functions: (final step, saved
    steps, snapshot steps, metric-row steps)."""
    from objgan_tpu import cli as jcli

    saved, snaps, rows = [], [], []

    class Manager:
        def latest_step(self):
            return saved[-1] if saved else None

    monkeypatch.setattr(jcli.ckpt, "save",
                        lambda mgr, step, state: saved.append(int(step)))
    monkeypatch.setattr(jcli.ckpt, "wait", lambda mgr: None)

    class Writer:
        def write(self, step, metrics):
            rows.append(step)

    def step_fn(state, batch, rng):
        return _JState(state.step + 1), {"loss": jnp.float32(0.0)}

    def multi_fn(state, batches, rng):
        k = jax.tree.leaves(batches)[0].shape[0]
        return _JState(state.step + k), {"loss": jnp.float32(0.0)}

    feed = ({"x": np.full((8, 2), i, np.float32)}
            for i in range(start, start + n_feed))
    end = jcli._run_loop(cfg, "t", _JState(jnp.int32(start)), step_fn, feed,
                         Writer(), Manager(), max_steps,
                         snapshot_hook=lambda s, step: snaps.append(step),
                         multi_step_fn=multi_fn)
    return int(end.step), saved, snaps, rows


class _Manager:
    def __init__(self):
        self.saved = []

    def save(self, step, module):
        if not self.saved or self.saved[-1] != step:
            self.saved.append(step)


class _Writer:
    def __init__(self):
        self.rows = []

    def write(self, step, metrics):
        self.rows.append((step, metrics))

    def close(self):
        pass


def _port_run(k, snapshot_steps, start, n_feed, max_steps):
    cfg = ttiny("float32", TRAIN={"STEPS_PER_EXECUTION": k,
                                  "SNAPSHOT_STEPS": snapshot_steps})
    tr = Counting()
    tr.step = start
    mgr, writer, snaps = _Manager(), _Writer(), []
    feed = ({"x": np.full((8, 2), i, np.float32)}
            for i in range(start, start + n_feed))
    cli._run_loop(cfg, tr, feed, writer, mgr, max_steps, "cpu",
                  snapshot_hook=snaps.append)
    return tr, mgr.saved, snaps, writer.rows


# (K, SNAPSHOT_STEPS, start step, feed length, max_steps)
LOOPS = [
    (2, 1, 0, 5, 10 ** 9),   # a bounded feed: 2 executions + its tail
    (2, 1, 5, 3, 10 ** 9),   # resumed at 5: the count continues
    (4, 1, 0, 12, 6),        # the ragged tail stops at max_steps
    (4, 5, 0, 40, 22),       # saves at the execution passing each multiple
    (3, 4, 2, 7, 10 ** 9),   # resumed mid-way, a partial last stack
    (4, 3, 0, 13, 10),       # K > SNAPSHOT_STEPS, ragged tail
]


@pytest.mark.parametrize("k,snap,start,n_feed,max_steps", LOOPS)
def test_run_loop_matches_jax(k, snap, start, n_feed, max_steps, tiny_cfg,
                              monkeypatch):
    jcfg = tiny_cfg.replace(DTYPE="float32").merged(
        {"TRAIN": {"STEPS_PER_EXECUTION": k, "SNAPSHOT_STEPS": snap,
                   "BATCH_SIZE": 8}})
    j_end, j_saved, j_snaps, _ = _jax_run(jcfg, start, n_feed, max_steps,
                                          monkeypatch)
    tr, saved, snaps, rows = _port_run(k, snap, start, n_feed, max_steps)
    assert tr.step == j_end == min(start + n_feed, max_steps)
    assert saved == j_saved
    assert snaps == j_snaps
    # every batch of the feed taken once, in order, at its own step
    assert [s for s, _, _ in tr.seen] == list(range(start, tr.step))
    assert [x for _, x, _ in tr.seen] == list(range(start, tr.step))
    # the port's rows: the first execution, max_steps, the feed's end
    assert rows[-1][0] == tr.step


def test_k_step_noise_equals_single_steps():
    """Each step's noise from (RNG_SEED, step), stacked or single: the K = 3
    run draws what the K = 1 run draws, ragged tail included."""
    a = _port_run(3, 1, 0, 8, 10 ** 9)[0].seen
    b = _port_run(1, 1, 0, 8, 10 ** 9)[0].seen
    assert a == b and len(a) == 8


# -- resuming through the entry points ------------------------------------------


def _train(stage, out, k, max_steps):
    fn = {"box": cli.train_box, "shape": cli.train_shape}[stage]
    cfg = ttiny("float32", OUTPUT_DIR=str(out),
                TRAIN={"STEPS_PER_EXECUTION": k, "SNAPSHOT_STEPS": 100})
    fn(cfg, max_steps=max_steps, device="cpu", log_every=100)
    return load_latest(os.path.join(str(out), f"{cfg.CONFIG_NAME}_{stage}",
                                    "ckpt"))


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("stage", ["box", "shape"])
def test_resumes_across_k_are_bitwise_unbroken(stage, tmp_path):
    # K = 4 for 8 steps, then K = 1 on to 10, against K = 1 unbroken
    _train(stage, tmp_path / "a", 4, 8)
    step, sd = _train(stage, tmp_path / "a", 1, 10)
    want_step, want = _train(stage, tmp_path / "b", 1, 10)
    assert step == want_step == 10
    _equal(sd, want)
    # K = 4 stopped in the middle of an execution (4 + 2), resumed to 10,
    # against K = 4 unbroken (4 + 4 + 2)
    _train(stage, tmp_path / "c", 4, 6)
    step, sd = _train(stage, tmp_path / "c", 4, 10)
    want_step, want4 = _train(stage, tmp_path / "d", 4, 10)
    assert step == want_step == 10
    _equal(sd, want4)
    _equal(sd, want)  # and both equal K = 1 on the CPU


# -- the prefetching feed --------------------------------------------------------


def _noise(batch, step):
    return (torch.full((), float(step)),)


def test_prefetch_feed_raises_the_feeds_error():
    def feed():
        yield {"x": np.zeros((2, 1))}
        yield {"x": np.zeros((2, 1))}
        raise OSError("disk gone")

    pf = cli.PrefetchFeed(feed(), 2, 0, _noise, "cpu")
    t0 = time.monotonic()
    got = []
    with pytest.raises(RuntimeError, match="prefetch feed failed") as e:
        for item in pf:
            got.append(item[0])
    assert time.monotonic() - t0 < 10
    assert isinstance(e.value.__cause__, OSError)
    assert got == ["exec"]
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetch_feed_early_stop_ends_the_thread():
    """The thread ends; the feed stays the caller's, open and readable,
    as at K = 1."""
    def feed():
        for i in range(10 ** 6):
            yield {"x": np.full((2, 1), i)}

    it = feed()
    pf = cli.PrefetchFeed(it, 3, 7, _noise, "cpu")
    kind, (batches, noises) = next(iter(pf))
    assert kind == "exec" and batches["x"].shape == (3, 2, 1)
    assert [float(n) for n in noises[0]] == [7.0, 8.0, 9.0]
    pf.close(timeout=10)
    assert not pf._thread.is_alive()
    assert "prefetch-feed" not in [t.name for t in threading.enumerate()]
    assert next(it)["x"].shape == (2, 1)


def test_prefetch_feed_tail_and_layout_changes_are_singles():
    sizes = [2, 2, 2, 3, 2, 2]  # batch 4 has another layout

    def feed():
        for i, b in enumerate(sizes):
            yield {"x": np.full((b, 1), i)}

    kinds = [(k, v[0]["x"].shape[0] if k == "exec" else int(v["x"][0, 0]))
             for k, v in cli.PrefetchFeed(feed(), 2, 0, _noise, "cpu")]
    # [0, 1] stack; 2 pending meets 3's layout: both single; [4, 5] stack
    assert kinds == [("exec", 2), ("single", 2), ("single", 3),
                     ("exec", 2)]


# -- the entry point and the feed profiler ----------------------------------------


def test_box_train_with_k_steps_imports_no_jax(tmp_path):
    yml = tmp_path / "tiny.yml"
    cfg = ttiny("float32")
    yml.write_text(yaml.safe_dump({
        "CONFIG_NAME": "k2", "OUTPUT_DIR": str(tmp_path / "out"),
        "TRAIN": {"FLAG": True, "BATCH_SIZE": 2, "STEPS_PER_EXECUTION": 2},
        "TEXT": {"EMBEDDING_DIM": cfg.TEXT.EMBEDDING_DIM,
                 "HIDDEN_DIM": cfg.TEXT.HIDDEN_DIM, "WORDS_NUM": 6,
                 "VOCAB_SIZE": cfg.TEXT.VOCAB_SIZE},
        "OBJ": {"MAX_OBJECTS": 3, "NUM_CLASSES": cfg.OBJ.NUM_CLASSES,
                "LABEL_DIM": cfg.OBJ.LABEL_DIM},
        "BOX": {"RNN_SIZE": 16, "INPUT_ENCODING_SIZE": 16,
                "ATT_HID_SIZE": 16, "MAX_SEQ_LENGTH": 4}}))
    code = ("import runpy, sys\n"
            "sys.argv = ['box_train', '--cfg', sys.argv[1], '--max_steps', "
            "'5', '--log_every', '1', '--device', 'cpu']\n"
            "runpy.run_module('objgan_tpu_torch.box_train', "
            "run_name='__main__')\n" + FORBIDDEN_MODULES)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, str(yml)], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert sorted(os.listdir(tmp_path / "out" / "k2_box" / "ckpt")) == ["5"]


def test_profile_feed_k_stack_line(tmp_path, capsys):
    from objgan_tpu_torch.data.procedural import build_manifest
    from objgan_tpu_torch.tools import profile_feed

    manifest = build_manifest(str(tmp_path), n_images=6, size=64, seed=0)
    yml = tmp_path / "pf.yml"
    yml.write_text("CONFIG_NAME: pf_test\n"
                   "TRAIN: {BATCH_SIZE: 2, STEPS_PER_EXECUTION: 2}\n")
    profile_feed.main(["--cfg", str(yml), "--manifest", manifest, "--wire",
                       "--reps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith(
        "3. K=2 stack: "))
    k_mb = float(line.split(" for ")[1].split(" MB")[0])
    one_mb = float(out.split(" MB -> ")[0].rsplit(" ", 1)[1])
    assert abs(k_mb - 2 * one_mb) < 0.011  # two wire batches, rounded
    assert "3. K=2 stack host->device (cpu) rep 0" in out


@pytest.mark.parametrize("yml", [None, "coco_objgan.yml", "damsm_coco.yml",
                                 "shape_coco.yml", "tiny"])
def test_agreement_process_reads_the_config_it_was_given(yml):
    """``card_check.deterministic_agreement`` hands each stage's config to
    its process as ``dataclasses.asdict``, and the process merges it over
    ``Config()``: the configs of ``chip_smoke.py``'s four trainers and the
    card test's tiny one arrive equal."""
    import dataclasses
    import json

    from objgan_tpu_torch.core.config import (Config, cfg_from_file,
                                              tiny_test_config)

    cfg = (Config() if yml is None else
           tiny_test_config().merged({"DTYPE": "bfloat16"}) if yml == "tiny"
           else cfg_from_file(os.path.join(REPO, "cfg", yml)))
    sent = json.loads(json.dumps(dataclasses.asdict(cfg)))
    assert Config().merged(sent) == cfg


def test_agreement_process_without_stages():
    """The process starts, takes its arguments and prints its one JSON line
    (on the CPU no stage can be captured)."""
    assert card_check.deterministic_agreement({}, 2) == {}
