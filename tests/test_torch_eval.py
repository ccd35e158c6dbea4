"""Stage C's evaluation in the port against the JAX package, at the tiny
fp32 config (``gan/eval.py`` and ``objgan_tpu_torch.eval``).

* ``utils/eval_metrics.py``, the port's copy: every function equal to the
  original on fixed inputs (the probe bitwise, retrieval ties in JAX's
  order).
* ``utils/fid_runner.py``'s host helpers equal JAX's (``primary_labels``,
  ``unique_epoch_batches``, ``save_stats_atomic``); the real-stats cache
  key differs from JAX's for the same manifest and mode.
* The lite extractor and the image encoder with JAX's weights carried
  across: features within 1e-5.
* The frozen extractor on ``assets/frozen_lite.npz``: JAX's features within
  1e-5, at 64 px (upsampled) and at 320 px (downsampled, antialias on);
  an artifact the port writes loads in JAX's ``load_frozen_artifact``.
* The slice: ``cli.evaluate`` on 2 batches with JAX's state carried across,
  JAX's lite weights and JAX's per-batch noise, against the JAX functions
  ``gan/eval.py`` calls, in its order: every metric within 1e-4 relative
  (the rank metrics equal).
* The entry points in subprocesses that import no JAX module: ``python -m
  objgan_tpu_torch.eval`` in paired mode and in ``--real_stats all`` mode
  on a procedural manifest (the second run reads both caches), and
  ``python -m objgan_tpu_torch.freeze_probe`` from a DAMSM checkpoint.
"""

import contextlib
import io
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from objgan_tpu.data import pipeline as jpipe
from objgan_tpu.data import synthetic as jsyn
from objgan_tpu.data.tokenizer import Vocab as JVocab
from objgan_tpu.tools import freeze_probe as jfreeze
from objgan_tpu.train.gan import GanTrainer as JGanTrainer
from objgan_tpu.utils import eval_metrics as jem
from objgan_tpu.utils import fid_runner as jfid
from objgan_tpu_torch import cli
from objgan_tpu_torch import freeze_probe as tfreeze
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.core.checkpoint import CheckpointManager
from objgan_tpu_torch.train.gan import GanTrainer
from objgan_tpu_torch.utils import eval_metrics as tem
from objgan_tpu_torch.utils import fid_runner as tfid
from tests.test_torch_data import FORBIDDEN_MODULES
from tests.torch_parity import n, port_cfg, t, tiny, ttiny

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FROZEN = os.path.join(REPO, "assets", "frozen_lite.npz")
FEAT_TOL = dict(rtol=0, atol=1e-5)
METRIC_RTOL = 1e-4


def _cfg():
    return tiny("float32", TRAIN={"BATCH_SIZE": 4})


def _images(size, b=4, seed=0):
    r = np.random.default_rng(seed)
    return r.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)


# -- the copied metrics ------------------------------------------------------


def _metric_cases():
    r = np.random.default_rng(0)
    a, b = r.normal(size=(40, 6)), r.normal(1.0, 2.0, size=(30, 6))
    probs = r.dirichlet(np.ones(5), size=23)
    labels = r.integers(0, 5, 40)
    s = r.normal(size=(12, 4))
    g = s + 0.5 * r.normal(size=(12, 4))
    tied = np.ones((12, 4))  # a collapsed encoder: every similarity ties
    return {
        "activation_stats": lambda m: m.activation_stats(a),
        "frechet_from_stats": lambda m: m.frechet_from_stats(
            *m.activation_stats(a), *m.activation_stats(b)),
        "frechet_distance": lambda m: m.frechet_distance(a, b),
        "inception_score": lambda m: m.inception_score(probs),
        "fit_class_probe": lambda m: m.fit_class_probe(a, labels, 5),
        "probe_probs": lambda m: m.probe_probs(
            m.fit_class_probe(a, labels, 5), b),
        "retrieval_stats": lambda m: m.retrieval_stats(s, g),
        "retrieval_stats_tied": lambda m: m.retrieval_stats(s, tied),
        "r_precision": lambda m: m.r_precision(s, g, n_mismatched=5),
        "r_precision_tied": lambda m: m.r_precision(s, tied),
    }


@pytest.mark.parametrize("name", sorted(_metric_cases()))
def test_eval_metrics_copy_matches_original(name):
    case = _metric_cases()[name]
    got, want = case(tem), case(jem)

    def flat(x):
        if isinstance(x, dict):
            return {k: flat(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(flat(v) for v in x)
        return np.asarray(x)

    got, want = flat(got), flat(want)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    elif isinstance(want, tuple):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)


# -- the host helpers --------------------------------------------------------


def test_primary_labels_and_unique_epoch_batches_match_jax():
    cfg = _cfg()
    batches = [jax.device_get(jsyn.synthetic_batch(cfg, jax.random.PRNGKey(s)))
               for s in range(3)]
    for b in batches:
        np.testing.assert_array_equal(tfid.primary_labels(b),
                                      jfid.primary_labels(b))
    empty = dict(batches[0], obj_valid=np.zeros_like(batches[0]["obj_valid"]))
    np.testing.assert_array_equal(tfid.primary_labels(empty),
                                  jfid.primary_labels(empty))
    # 10 unique images from batches of 4: the third batch is cut to 2 rows
    got = list(tfid.unique_epoch_batches(iter(batches), 10))
    want = list(jfid.unique_epoch_batches(iter(batches), 10))
    assert [len(i) for i, _ in got] == [len(i) for i, _ in want] == [4, 4, 2]
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_save_stats_atomic_round_trips_like_jax(tmp_path):
    """``save_stats_atomic`` writes what JAX's writes (``mu``, ``cov``),
    in place of an older file, and leaves no temporary file behind."""
    r = np.random.default_rng(0)
    mu, cov = r.normal(size=8), r.normal(size=(8, 8))
    got, want = tmp_path / "port.npz", tmp_path / "jax.npz"
    got.write_bytes(b"an older, truncated cache")
    tfid.save_stats_atomic(str(got), mu, cov)
    jfid.save_stats_atomic(str(want), mu, cov)
    with np.load(got) as g, np.load(want) as w:
        assert sorted(g.files) == sorted(w.files) == ["cov", "mu"]
        for k in ("mu", "cov"):
            np.testing.assert_array_equal(g[k], w[k])
    assert sorted(os.listdir(tmp_path)) == ["jax.npz", "port.npz"]


def test_real_stats_cache_key_differs_from_jax(tmp_path):
    """The port's extractors draw other weights than JAX's, so the same
    manifest, mode and kind must give another cache file than JAX's; the
    key still moves with the mode and the class count, as JAX's does."""
    manifest = tmp_path / "manifest.json"
    manifest.write_text("[]")
    cfg = _cfg()
    args = (str(manifest), 10, "lite (framework encoder)")
    for kw in ({}, {"kind": "lite_probe", "n_classes": 7}):
        got = tfid.real_stats_cache_path(port_cfg(cfg), *args, **kw)
        want = jfid.real_stats_cache_path(cfg, *args, **kw)
        assert os.path.dirname(got) == os.path.dirname(want)
        assert os.path.basename(got).startswith(
            f".fid_{kw.get('kind', 'real_stats')}_")
        assert got != want
    base = tfid.real_stats_cache_path(port_cfg(cfg), *args)
    assert tfid.real_stats_cache_path(port_cfg(cfg), str(manifest), 10,
                                      "strict-inception") != base
    assert tfid.real_stats_cache_path(
        port_cfg(cfg), *args, kind="lite_probe", n_classes=7) != \
        tfid.real_stats_cache_path(port_cfg(cfg), *args, kind="lite_probe",
                                   n_classes=8)


# -- the extractors ----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_lite():
    """JAX's lite extractor (PRNGKey(0) weights) and its parameters."""
    extract, params = jfid.make_lite_extractor(_cfg())
    return extract, jax.device_get(params)


def _port_lite(params):
    extract, enc = tfid.make_lite_extractor(port_cfg(_cfg()), device="cpu")
    bridge.load_jax_params(enc, params)
    return extract, enc


def test_lite_extractor_and_img_enc_match_jax(jax_lite):
    jextract, params = jax_lite
    extract, enc = _port_lite(params)
    x = _images(64)
    want_f, want_p = jextract(jnp.asarray(x))
    got_f, got_p = extract(x)
    np.testing.assert_allclose(n(got_f), np.asarray(want_f), **FEAT_TOL)
    np.testing.assert_allclose(n(got_p), np.asarray(want_p), **FEAT_TOL)
    from objgan_tpu.models.damsm import build_image_encoder

    want_r, want_g = build_image_encoder(_cfg()).apply(params, jnp.asarray(x))
    with torch.no_grad():
        got_r, got_g = enc(t(x))
    np.testing.assert_allclose(n(got_r), np.asarray(want_r), **FEAT_TOL)
    np.testing.assert_allclose(n(got_g), np.asarray(want_g), **FEAT_TOL)


@pytest.mark.parametrize("size", [64, 320])
def test_frozen_extractor_matches_jax(size):
    """64 px images are upsampled to the artifact's 256 px (antialias makes
    no difference), 320 px ones downsampled with antialias, as
    ``jax.image.resize`` by default."""
    jextract, jprobe, jmeta = jfreeze.make_frozen_extractor(FROZEN)
    extract, probe, meta = tfreeze.make_frozen_extractor(FROZEN, "cpu")
    assert meta == jmeta == {"embedding_dim": 256, "image_size": 256,
                             "n_classes": 81, "backbone": "lite"}
    assert set(probe) == set(jprobe)
    for k in probe:
        np.testing.assert_array_equal(probe[k], jprobe[k])
    x = _images(size, b=2, seed=size)
    np.testing.assert_allclose(n(extract(x)), np.asarray(jextract(x)),
                               **FEAT_TOL)


def test_frozen_artifact_written_by_the_port_loads_in_jax(tmp_path):
    params, probe, meta = tfreeze.load_frozen_artifact(FROZEN)
    jparams, _, _ = jfreeze.load_frozen_artifact(FROZEN)
    assert bridge.jax_to_torch(params).keys() == \
        bridge.jax_to_torch(jparams).keys()
    from objgan_tpu_torch.models.damsm import CNNEncoder

    enc = CNNEncoder(meta["embedding_dim"], base_width=32)
    bridge.load_jax_params(enc, params)
    path = str(tmp_path / "frozen.npz")
    tfreeze.save_frozen_artifact(
        path, {"params": bridge.torch_to_jax(enc)}, probe,
        **{k: meta[k] for k in ("embedding_dim", "image_size", "n_classes")})
    with np.load(path) as mine, np.load(FROZEN) as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        for k in theirs.files:
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    jextract, jprobe, jmeta = jfreeze.make_frozen_extractor(path)
    assert jmeta == meta
    x = _images(256, b=1, seed=3)
    np.testing.assert_allclose(
        np.asarray(jextract(x)),
        n(tfreeze.make_frozen_extractor(FROZEN, "cpu")[0](x)), **FEAT_TOL)


# -- the slice: cli.evaluate against gan/eval.py's sequence ------------------


def _jax_noise(cfg, i, b):
    """The z and ca_eps JAX's ``GanTrainer.sample`` draws from
    fold_in(PRNGKey(RNG_SEED), 1000 + i)."""
    k_z, k_ca = jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(cfg.RNG_SEED), 1000 + i))
    return {"z": t(jax.random.normal(k_z, (b, cfg.GAN.Z_DIM))),
            "ca_eps": t(jax.random.normal(k_ca, (b, cfg.GAN.CONDITION_DIM),
                                          jnp.float32))}


def _jax_eval(cfg, state, batches, lite, manifest=None):
    """``gan/eval.py``'s lite-mode body with its functions, in its order
    (the frozen probe at its default path): paired real statistics, or
    with ``manifest`` those of one augmentation-free pass over it."""
    jt = JGanTrainer(cfg)
    sample_jit = jt.jitted_sample()
    extractor = lite
    fr_extract, fr_probe, _ = jfreeze.make_frozen_extractor(FROZEN)
    text_apply = jax.jit(jt.text_enc.apply)
    img_apply = jax.jit(jt.img_enc.apply)
    rng = jax.random.PRNGKey(cfg.RNG_SEED)
    fake_acts, real_acts, real_labels, frozen = [], [], [], []
    sents, globals_, globals_real = [], [], []
    for i, batch in enumerate(batches):
        out = sample_jit(state, batch, jax.random.fold_in(rng, 1000 + i),
                         use_ema=True)
        fa, _ = extractor(out["images"][-1])
        fake_acts.append(np.asarray(fa))
        frozen.append(np.asarray(fr_extract(out["images"][-1])))
        if manifest is None:
            ra, _ = extractor(batch["images"][-1])
            real_acts.append(np.asarray(ra))
            real_labels.append(jfid.primary_labels(batch))
        _, sent = text_apply(state.text_params, batch["captions"],
                             batch["cap_lens"])
        sents.append(np.asarray(sent))
        globals_.append(np.asarray(img_apply(state.img_params,
                                             out["images"][-1])[1]))
        globals_real.append(np.asarray(img_apply(state.img_params,
                                                 batch["images"][-1])[1]))
    if manifest is None:
        real_stats = jem.activation_stats(np.concatenate(real_acts))
        probe = jem.fit_class_probe(np.concatenate(real_acts),
                                    np.concatenate(real_labels),
                                    cfg.OBJ.NUM_CLASSES)
    else:
        records = jpipe.load_records_json(manifest)
        vocab = JVocab.build(c for r in records for c in r["captions"])
        full = jpipe.CocoFeed(cfg, records, vocab, seed=cfg.RNG_SEED,
                              augment=False, with_masks=False)
        real_stats, probe = jfid.real_stats_and_probe(
            jfid.unique_epoch_batches(full, len(records)), extractor,
            cfg.OBJ.NUM_CLASSES)
    fake_all = np.concatenate(fake_acts)
    fid, (is_m, is_s) = jfid.compute_fid_is(
        [], [], extractor, real_stats=real_stats,
        fake_activations=(fake_all, jem.probe_probs(probe, fake_all)))
    s = np.concatenate(sents)
    fz_m, fz_s = jem.inception_score(jem.probe_probs(
        fr_probe, np.concatenate(frozen)))
    rs_fake = jem.retrieval_stats(s, np.concatenate(globals_))
    rs_real = jem.retrieval_stats(s, np.concatenate(globals_real))
    return {"fid": fid, "is_mean": is_m, "is_std": is_s, "n": len(fake_all),
            "frozen_is_mean": fz_m, "frozen_is_std": fz_s,
            "r_precision": jem.r_precision(s, np.concatenate(globals_)),
            "r_precision_real": jem.r_precision(
                s, np.concatenate(globals_real)),
            **{f"retrieval_{k}": v for k, v in rs_fake.items()},
            **{f"retrieval_real_{k}": v for k, v in rs_real.items()}}


@pytest.mark.parametrize("mode", ["paired", "all"])
def test_evaluate_matches_gan_eval(tmp_path, monkeypatch, jax_lite, manifest,
                                   mode):
    """Paired mode on synthetic batches; ``--real_stats all`` on the
    held-out feed of a procedural manifest (JAX's ``CocoFeed`` batches to
    both; the port's full-manifest pass reads its own ``CocoFeed``, held
    bitwise equal to JAX's by ``tests/test_torch_data.py``)."""
    if mode == "paired":
        cfg = _cfg()
        batches = [jax.device_get(jsyn.synthetic_batch(
            cfg, jax.random.PRNGKey(s))) for s in (1, 2)]
        path = None
    else:
        # a copy of the manifest: the caches land beside it, in tmp_path
        path = str(tmp_path / "manifest.json")
        shutil.copy(manifest, path)
        cfg = _cfg().merged({"DATA_DIR": os.path.dirname(manifest),
                             "OBJ": {"NUM_CLASSES": 81},
                             "TEXT": {"VOCAB_SIZE": 500},
                             "TRAIN": {"FLAG": False}})
        records = jpipe.load_records_json(path)
        vocab = JVocab.build(c for r in records for c in r["captions"])
        feed = iter(jpipe.CocoFeed(cfg, records, vocab, seed=cfg.RNG_SEED,
                                   augment=False))
        batches = [next(feed) for _ in range(2)]
    jt = JGanTrainer(cfg)
    state = jax.jit(jt.init_state)(jax.random.PRNGKey(0), batches[0])
    jextract, lite_params = jax_lite
    want = _jax_eval(cfg, state, batches, jextract, path)

    pcfg = port_cfg(cfg).merged({"OUTPUT_DIR": str(tmp_path)})
    trainer = GanTrainer(pcfg)
    bridge.load_jax_state(trainer, jax.device_get(state))
    CheckpointManager(str(tmp_path / "objgan_gan" / "ckpt")).save(3, trainer)
    make_lite = tfid.make_lite_extractor

    def lite_with_jax_weights(*a, **k):
        extract, enc = make_lite(*a, **k)
        bridge.load_jax_params(enc, lite_params)
        return extract, enc

    monkeypatch.setattr(tfid, "make_lite_extractor", lite_with_jax_weights)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = cli.evaluate(pcfg, iter(batches), 2, device="cpu",
                           real_stats=mode, manifest=path,
                           noise=lambda i, b: _jax_noise(cfg, i, b))
    text = out.getvalue()
    assert "evaluating checkpoint at step 3" in text
    assert f"FID: {got['fid']:.3f}" in text
    assert "frozen lite-IS:" in text and "R-precision (real-image ceiling)" \
        in text
    assert ("full manifest, 12 unique images" in text) == (mode == "all")
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=METRIC_RTOL, atol=0,
                                   err_msg=k)


# -- the entry points, without JAX ------------------------------------------


def _tiny_yml(path, **extra):
    cfg = {
        "OUTPUT_DIR": str(path.parent / "out"),
        "TRAIN": {"FLAG": False, "BATCH_SIZE": 4},
        "TREE": {"BASE_SIZE": 16},
        "GAN": {"DF_DIM": 8, "GF_DIM": 8, "Z_DIM": 16, "CONDITION_DIM": 16},
        "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": 6, "VOCAB_SIZE": 500,
                 "HIDDEN_DIM": 16, "GLOVE_DIM": 16},
        "OBJ": {"MAX_OBJECTS": 3, "NUM_CLASSES": 81, "ROI_SIZE": 4,
                "LABEL_DIM": 16, "GMM_COMPONENTS": 4, "SHAPE_SIZE": 16},
        **extra,
    }
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _run(module, args):
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{module!r}] + sys.argv[1:]\n"
        f"runpy.run_module({module!r}, run_name='__main__')\n"
        + FORBIDDEN_MODULES)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


_LINES = ("eval over 8 samples [lite (framework encoder)]", "NOTE: FID over",
          "FID: ", "IS: ", "frozen lite-IS: ", "R-precision: ",
          "R-precision (real-image ceiling): ",
          "Retrieval mean rank (full pool 8): ",
          "Retrieval mean rank (real-image ceiling): ",
          "[untrained encoders — meaningless until DAMSM is pretrained]")


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    from objgan_tpu_torch.data.procedural import build_manifest

    return build_manifest(str(tmp_path_factory.mktemp("proc")), n_images=12,
                          size=64, seed=0)


@pytest.mark.parametrize("mode", ["paired", "all"])
def test_eval_entry_point_without_jax(tmp_path, manifest, mode):
    yml = _tiny_yml(tmp_path / "tiny.yml")
    args = ["--cfg", yml, "--num_batches", "2", "--device", "cpu"]
    if mode == "all":
        args += ["--manifest", manifest, "--data_dir",
                 os.path.dirname(manifest), "--real_stats", "all"]
    out = _run("objgan_tpu_torch.eval", args)
    for line in _LINES:
        assert line in out, line
    assert ("real-side FID statistics: full manifest, 12 unique images"
            in out) == (mode == "all")
    if mode == "all":
        assert "cached" not in out
        again = _run("objgan_tpu_torch.eval", args)
        assert "real-side stats: cached" in again
        assert "lite-IS probe: cached" in again
        fid = [ln for ln in out.splitlines() if ln.startswith("FID: ")]
        assert fid == [ln for ln in again.splitlines()
                       if ln.startswith("FID: ")]


def test_eval_guard_rails(capsys):
    from objgan_tpu_torch.eval import main

    with pytest.raises(SystemExit) as exc:
        main(["--strict", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--inception_pth" in capsys.readouterr().err
    # --grain is accepted (the worker feed is ported): the guard that
    # remains is the manifest --real_stats all needs, with it or without
    for argv, says in ((["--grain", "--real_stats", "all"],
                        "needs --manifest"),
                       (["--real_stats", "all"], "needs --manifest")):
        with pytest.raises(SystemExit):
            main(argv + ["--device", "cpu"])
        assert says in capsys.readouterr().err


def test_freeze_probe_entry_point_without_jax(tmp_path, manifest):
    """A DAMSM checkpoint of the port -> ``python -m
    objgan_tpu_torch.freeze_probe`` -> an artifact JAX's loader reads and
    the port's eval uses."""
    yml = _tiny_yml(tmp_path / "tiny.yml")
    cli.pretrain_damsm(ttiny("float32", OUTPUT_DIR=str(tmp_path / "d"),
                             TEXT={"VOCAB_SIZE": 500},
                             OBJ={"NUM_CLASSES": 81}),
                       max_steps=1, device="cpu")
    ckpt = str(tmp_path / "d" / "objgan_damsm" / "ckpt")
    out = str(tmp_path / "frozen.npz")
    stdout = _run("objgan_tpu_torch.freeze_probe",
                  ["--cfg", yml, "--manifest", manifest, "--damsm", ckpt,
                   "--out", out, "--device", "cpu"])
    assert "frozen probe fit on 12 real images" in stdout
    params, probe, meta = jfreeze.load_frozen_artifact(out)
    assert meta == {"embedding_dim": 32, "image_size": 64, "n_classes": 81,
                    "backbone": "lite"}
    assert probe["w"].shape == (32, 81)
    jextract, _, _ = jfreeze.make_frozen_extractor(out)
    x = _images(64, b=2)
    np.testing.assert_allclose(
        n(tfreeze.make_frozen_extractor(out, "cpu")[0](x)),
        np.asarray(jextract(x)), **FEAT_TOL)
    stdout = _run("objgan_tpu_torch.eval",
                  ["--cfg", yml, "--num_batches", "1", "--device", "cpu",
                   "--frozen_probe", out])
    assert "frozen lite-IS: " in stdout and "frozen.npz" in stdout
