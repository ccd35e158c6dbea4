"""The port's JAX-free host copies (config tree, tokenizer, GloVe label
tables, PNG writer) against the JAX package's originals, the param
bridge's layout rules, and the rule that the port imports neither JAX nor
anything of the JAX package."""

import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from objgan_tpu.core import config as jconfig
from objgan_tpu.data import glove as jglove
from objgan_tpu.data.tokenizer import Vocab as JVocab
from objgan_tpu.utils import visualize as jvis
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.core import config as tconfig
from objgan_tpu_torch.data import glove as tglove
from objgan_tpu_torch.data.tokenizer import Vocab as TVocab
from objgan_tpu_torch.train.gan import _default_label_table
from objgan_tpu_torch.utils import visualize as tvis

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a subprocess that imported any of these broke the port's rule (Grain is
# not on the card's host: the worker feed is the port's own; nor are
# tensorstore, zstandard and ml_dtypes: the port reads Orbax steps itself)
FORBIDDEN_MODULES = (
    "bad = [m for m in sys.modules if m in ('jax', 'objgan_tpu', 'grain', "
    "'tensorstore', 'zstandard', 'ml_dtypes') "
    "or m.startswith(('jax.', 'flax', 'optax', 'orbax', 'objgan_tpu.', "
    "'grain.', 'tensorstore.', 'zstandard.', 'ml_dtypes.'))]\n"
    "assert not bad, bad\n")

CAPS = ["Two dogs play in the PARK.", "a man riding a wave on a surfboard",
        "unseen-words here, and a dog!"]


def test_tokenizer_ids_match():
    jv, tv = JVocab.build(CAPS[:2]), TVocab.build(CAPS[:2])
    assert jv.wordtoix == tv.wordtoix
    for max_len in (4, 12):
        with pytest.warns(UserWarning):
            j_ids, j_lens = jv.encode_batch(CAPS, max_len)
        with pytest.warns(UserWarning):
            t_ids, t_lens = tv.encode_batch(CAPS, max_len)
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_array_equal(t_lens, j_lens)
    assert tv.decode(t_ids[0]) == jv.decode(j_ids[0])


def test_label_tables_match():
    for dim in (16, 300):
        np.testing.assert_array_equal(tglove.coco_label_table(dim),
                                      jglove.coco_label_table(dim))
    assert (tglove.resolve_glove_path(tconfig.Config())
            == jglove.resolve_glove_path(jconfig.Config()))


def test_default_label_table_81_classes_is_deterministic():
    """At COCO's 81 classes both stages' tables are the same deterministic
    GloVe-or-crc32 table, whatever the generator."""
    cfg = tconfig.Config()
    a = _default_label_table(cfg, torch.Generator().manual_seed(0))
    b = _default_label_table(cfg, torch.Generator().manual_seed(1))
    assert a.shape == (81, cfg.OBJ.LABEL_DIM)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(a.numpy(), jglove.coco_label_table(300))


def test_bridge_layouts():
    tree = {"params": {
        "fc": {"kernel": np.arange(6.0).reshape(2, 3), "bias": np.zeros(3)},
        "conv": {"kernel": np.arange(24.0).reshape(1, 2, 3, 4)},
        "norm": {"scale": np.ones(4), "bias": np.zeros(4)},
        "emb": {"embedding": np.ones((5, 2))},
        "lstm": {"w_ih": np.ones((3, 8)), "w_hh": np.ones((2, 8)),
                 "b": np.arange(8.0)},
    }}
    sd = bridge.jax_to_torch(tree)
    assert sd["fc.weight"].shape == (3, 2)
    np.testing.assert_array_equal(sd["fc.weight"], tree["params"]["fc"][
        "kernel"].T)
    assert sd["conv.weight"].shape == (4, 3, 1, 2)
    assert sd["conv.weight"][1, 2, 0, 1] == \
        tree["params"]["conv"]["kernel"][0, 1, 2, 1]
    assert sd["norm.weight"].shape == (4,) and "norm.scale" not in sd
    assert sd["emb.weight"].shape == (5, 2)
    assert sd["lstm.w_ih"].shape == (3, 8)  # JAX layout, single bias
    np.testing.assert_array_equal(sd["lstm.b"], np.arange(8.0))


def test_bridge_rejects_mismatched_tree():
    from objgan_tpu_torch.core.layers import Dense

    with pytest.raises(KeyError, match="missing"):
        bridge.load_jax_params(Dense(2, 3), {"kernel": np.ones((2, 3))})
    with pytest.raises(ValueError, match="shape mismatch"):
        bridge.load_jax_params(Dense(2, 3), {"kernel": np.ones((3, 3)),
                                             "bias": np.zeros(3)})


def test_port_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import objgan_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n" + FORBIDDEN_MODULES)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("module", ["objgan_tpu_torch.parallel",
                                    "objgan_tpu_torch.parallel.sharding",
                                    "objgan_tpu_torch.parallel.dryrun"])
def test_parallel_modules_import_no_jax(module):
    """The data-parallel modules, each alone in a fresh process (the dry
    run's ``--help`` parsed as well)."""
    code = ("import importlib, runpy, sys\n"
            f"importlib.import_module({module!r})\n"
            "if sys.argv[1].endswith('dryrun'):\n"
            "    sys.argv = ['dryrun', '--help']\n"
            "    try:\n"
            f"        runpy.run_module({module!r}, run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, e.code\n" + FORBIDDEN_MODULES)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, module], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("tool", ["convert_damsm", "convert_gan",
                                  "export_damsm", "kernel_hw_check"])
def test_tools_import_no_jax(tool):
    """Each lineage and hardware tool alone in a fresh process, its
    ``--help`` parsed, imports nothing of JAX or the JAX package."""
    module = f"objgan_tpu_torch.tools.{tool}"
    code = ("import runpy, sys\n"
            "sys.argv = [sys.argv[1], '--help']\n"
            "try:\n"
            "    runpy.run_module(sys.argv[0], run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n" + FORBIDDEN_MODULES)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, module], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "usage:" in proc.stdout


def test_guard_catches_the_jax_package():
    """The guard itself: a process that imports a JAX-free module of the
    JAX package fails it."""
    code = "import sys\nimport objgan_tpu.core.config\n" + FORBIDDEN_MODULES
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "objgan_tpu.core" in proc.stderr


@pytest.mark.parametrize("name", ["defaults", "tiny"] + sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(REPO, "cfg",
                                                        "*.yml"))))
def test_config_copy_matches_original(name):
    """``objgan_tpu_torch/core/config.py`` builds the same tree as
    ``objgan_tpu/core/config.py``: the defaults, the tiny test config and
    every ``cfg/*.yml``."""
    if name == "defaults":
        got, want = tconfig.Config(), jconfig.Config()
    elif name == "tiny":
        got, want = tconfig.tiny_test_config(), jconfig.tiny_test_config()
    else:
        path = os.path.join(REPO, "cfg", name)
        got, want = tconfig.cfg_from_file(path), jconfig.cfg_from_file(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.branch_sizes == want.branch_sizes


def test_config_copy_validates_alike():
    bad = {"GAN": {"REMAT": "all"}}
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match="REMAT"):
            mod.Config().merged(bad)
        with pytest.raises(KeyError):
            mod.Config().merged({"GAN": {"NO_SUCH_KEY": 1}})


def test_png_copy_writes_identical_bytes(tmp_path):
    img = np.random.default_rng(0).uniform(-1.2, 1.2, (9, 7, 3)).astype(
        np.float32)
    u8 = tvis._to_uint8(img)
    np.testing.assert_array_equal(u8, jvis._to_uint8(img))
    tvis.save_png(str(tmp_path / "t.png"), u8)
    jvis.save_png(str(tmp_path / "j.png"), u8)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


# -- the feed, metrics and grids: copies of the JAX package's host modules ----

from objgan_tpu.core import metrics as jmetrics  # noqa: E402
from objgan_tpu.data import pipeline as jpipe  # noqa: E402
from objgan_tpu_torch.core import metrics as tmetrics  # noqa: E402
from objgan_tpu_torch.data import feed as tfeed  # noqa: E402
from objgan_tpu_torch.data import pipeline as tpipe  # noqa: E402


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """A 12-record procedural COCO manifest at 64 px (PNG files, polygon
    segmentations), written by the port's generator
    (``tests/test_torch_feed.py`` holds it equal to JAX's)."""
    from objgan_tpu_torch.data.procedural import build_manifest

    return build_manifest(str(tmp_path_factory.mktemp("proc")), n_images=12,
                          size=64, seed=0)


def _feed_cfgs(**overrides):
    over = {"OBJ": {"NUM_CLASSES": 81}, "TEXT": {"VOCAB_SIZE": 500},
            "TRAIN": {"BATCH_SIZE": 4}, **overrides}
    return jconfig.tiny_test_config().merged(over), \
        tconfig.tiny_test_config().merged(over)


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "images":
            assert len(got[k]) == len(w)
            for g, w_ in zip(got[k], w):
                assert g.dtype == w_.dtype
                np.testing.assert_array_equal(g, w_)
        else:
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def _inline(records):
    """The records with their photos inline at 96 px (area resize through
    the strided mean and PIL's box filter) instead of on disk."""
    r = np.random.default_rng(3)
    return [dict({k: v for k, v in rec.items() if k != "image_file"},
                 image=r.integers(0, 256, (96, 96, 3)).astype(np.uint8))
            for rec in records]


@pytest.mark.parametrize("source", ["file", "inline"])
@pytest.mark.parametrize("with_masks", [True, False])
@pytest.mark.parametrize("augment", [True, False])
def test_coco_feed_copy_matches_original(manifest, source, with_masks,
                                         augment):
    """Three batches of the port's ``CocoFeed`` equal the JAX package's,
    to the bit: same seed, same shuffle, captions, word dropout, flips,
    layouts, masks and image pyramids."""
    records = jpipe.load_records_json(manifest)
    assert records == tpipe.load_records_json(manifest)
    if source == "inline":
        records = _inline(records)
    jc, tc = _feed_cfgs(TEXT={"VOCAB_SIZE": 500, "WORD_DROPOUT": 0.3})
    root = os.path.dirname(manifest)
    caps = [c for rec in records for c in rec["captions"]]
    kw = dict(seed=7, with_masks=with_masks, augment=augment,
              image_root=root)
    want = iter(jpipe.CocoFeed(jc, records, JVocab.build(caps), **kw))
    got = iter(tpipe.CocoFeed(tc, records, TVocab.build(caps), **kw))
    for _ in range(3):
        _assert_batches_equal(next(got), next(want))


@pytest.mark.parametrize("b_validation,train", [(False, True), (True, True),
                                                (True, False)])
def test_build_feed_matches_gan_main(manifest, b_validation, train):
    """``data/feed.py::build_feed`` against ``gan/main.py::build_feed`` (one
    process; both read images under DATA_DIR), classic and with
    ``--wire``: the record count, the vocabulary and two batches."""
    import types

    from gan.main import build_feed as jax_build_feed

    over = {"B_VALIDATION": b_validation,
            "DATA_DIR": os.path.dirname(manifest),
            "TRAIN": {"BATCH_SIZE": 4, "FLAG": train}}
    jc, tc = _feed_cfgs(**over)
    for wire in (False, True):
        args = types.SimpleNamespace(manifest=manifest, captions_pickle=None,
                                     wire=wire)
        want_feed, want_n, want_vocab = jax_build_feed(jc, args,
                                                       with_masks=train)
        got_feed, got_n, got_vocab = tfeed.build_feed(
            tc, manifest, with_masks=train, wire=wire)
        assert got_n == want_n == (11 if b_validation and train else
                                   1 if b_validation else 12)
        assert got_vocab.wordtoix == want_vocab.wordtoix
        for _ in range(2):
            got = next(got_feed)
            assert ("image_u8" in got) == wire
            _assert_batches_equal(got, next(want_feed))
    assert tfeed.build_feed(tc, None) == (None, 0, None)


@pytest.mark.parametrize("entry", ["gan_main", "pretrain_damsm"])
def test_data_dir_resolves_images_as_the_jax_feed(manifest, tmp_path,
                                                  monkeypatch, entry):
    """The manifest copied away from its images: ``--data_dir`` (which sets
    DATA_DIR) finds them as JAX's ``CocoFeed`` does under DATA_DIR, and the
    first batches are equal; without it the port looks under DATA_DIR, not
    beside the manifest, as the JAX package does."""
    import json
    import shutil

    from objgan_tpu_torch import gan_main, pretrain_damsm

    root = os.path.dirname(manifest)
    moved = tmp_path / "elsewhere" / "manifest.json"
    moved.parent.mkdir()
    shutil.copy(manifest, moved)
    (tmp_path / "elsewhere" / "images").mkdir()  # not the photos
    yml = tmp_path / "cfg.yml"
    yml.write_text(json.dumps({"OBJ": {"NUM_CLASSES": 81},
                               "TEXT": {"VOCAB_SIZE": 500},
                               "TRAIN": {"BATCH_SIZE": 4}}))
    jc = jconfig.cfg_from_file(str(yml)).replace(DATA_DIR=root)
    records = jpipe.load_records_json(str(moved))
    caps = [c for rec in records for c in rec["captions"]]
    want = iter(jpipe.CocoFeed(jc, records, JVocab.build(caps),
                               seed=jc.RNG_SEED, augment=jc.TRAIN.FLAG,
                               with_masks=entry == "gan_main"))
    # what the entry point does with --data_dir, up to its feed
    seen, build_feed = {}, tfeed.build_feed

    def capture(cfg, *args, **kwargs):
        seen["feed"] = build_feed(cfg, *args, **kwargs)
        raise SystemExit(0)

    module = gan_main if entry == "gan_main" else pretrain_damsm
    monkeypatch.setattr(tfeed, "build_feed", capture)
    with pytest.raises(SystemExit):
        module.main(["--cfg", str(yml), "--manifest", str(moved),
                     "--data_dir", root, "--device", "cpu"])
    feed, n_records, _ = seen["feed"]
    assert n_records == 12
    _assert_batches_equal(next(feed), next(want))
    # without --data_dir the images are read under DATA_DIR, never beside
    # the manifest (whose images/ is empty)
    tc = tconfig.cfg_from_file(str(yml)).replace(
        DATA_DIR=str(tmp_path / "no"))
    feed, _, _ = build_feed(tc, str(moved))
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "no")):
        next(feed)


@pytest.mark.parametrize("n", [1, 2, 10, 37])
@pytest.mark.parametrize("seed", [0, 100])
def test_split_records_copy_matches_original(n, seed):
    records = [{"id": i} for i in range(n)]
    assert tpipe.split_records(records, seed=seed) == \
        jpipe.split_records(records, seed=seed)


def test_polygon_fill_copy_matches_original():
    r = np.random.default_rng(0)
    for _ in range(5):
        poly = r.uniform(0.1, 0.9, (7, 2))
        box = np.array([0.05, 0.1, 0.8, 0.85])
        np.testing.assert_array_equal(
            tpipe.polygon_to_box_mask(poly, box, 16),
            jpipe._numpy_polygon_fill(
                np.stack([(poly[:, 0] - 0.05) / 0.8,
                          (poly[:, 1] - 0.1) / 0.85], -1), 16))
        np.testing.assert_array_equal(
            tpipe.polygon_to_box_mask(poly, box, 16),
            jpipe.polygon_to_box_mask(poly, box, 16))
    img = r.uniform(-1, 1, (48, 40, 3)).astype(np.float32)
    for size in (8, 16, 20):
        np.testing.assert_array_equal(tpipe._resize_area(img, size),
                                      jpipe._resize_area(img, size))


@pytest.mark.parametrize("case", ["vocab", "label_zero", "label_high",
                                  "mixed_images"])
def test_validators_copy_raise_alike(case):
    jc, tc = _feed_cfgs()
    rec = {"captions": ["a dog"], "labels": [3], "boxes": [[0, 0, 1, 1]],
           "image_file": "x.png"}
    if case == "vocab":
        caps = [f"w{i}" for i in range(600)]
        with pytest.raises(ValueError, match="VOCAB_SIZE"):
            jpipe.validate_vocab(jc, JVocab.build(caps))
        with pytest.raises(ValueError, match="VOCAB_SIZE"):
            tpipe.validate_vocab(tc, TVocab.build(caps))
        return
    records = {"label_zero": [dict(rec, labels=[0])],
               "label_high": [dict(rec, labels=[81])],
               "mixed_images": [rec, dict(rec, image_file=None)]}[case]
    messages = []
    for mod, cfg in ((jpipe, jc), (tpipe, tc)):
        with pytest.raises(ValueError) as exc:
            if case == "mixed_images":
                mod.validate_image_records(records)
            else:
                mod.validate_labels(cfg, records)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


def test_metrics_writer_copy_writes_identical_csv(tmp_path, monkeypatch,
                                                  capsys):
    """The same rows (a resume-append whose new key is dropped included)
    give the same CSV bytes and the same stdout."""
    import time as time_mod

    def run(mod, directory):
        clock = iter(np.arange(0.0, 100.0, 0.25))
        monkeypatch.setattr(time_mod, "monotonic", lambda: float(next(clock)))
        w = mod.MetricsWriter(str(directory), "damsm", print_every=2)
        for step in range(1, 6):
            w.write(step, {"loss": 1.0 / step, "lr": np.float32(2e-4)})
        w.close()
        w = mod.MetricsWriter(str(directory), "damsm", print_every=2)
        w.write(6, {"loss": 0.5, "lr": 1e-4, "new_key": 3.0})
        w.close()
        return (directory / "damsm_metrics.csv").read_bytes(), \
            capsys.readouterr().out.replace(str(directory), "<dir>")

    want = run(jmetrics, tmp_path / "jax")
    got = run(tmetrics, tmp_path / "port")
    assert got == want
    assert b"new_key" not in got[0] and "new_key" in got[1]


def test_attention_grids_copy_match_original():
    r = np.random.default_rng(0)
    b, s, t, o = 3, 32, 5, 4
    images = r.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
    attn = r.uniform(0, 1, (b, 4, 4, t)).astype(np.float32)
    caps = r.integers(1, 9, (b, t)).astype(np.int32)
    lens = np.array([5, 3, 1], np.int32)
    ixtoword = {i: f"w{i}" for i in range(1, 6)}
    for kw in ({}, {"captions": caps, "cap_lens": lens,
                    "ixtoword": ixtoword}):
        np.testing.assert_array_equal(
            tvis.build_super_images(images, attn, **kw),
            jvis.build_super_images(images, attn, **kw))
    boxes = r.uniform(0, 0.6, (b, o, 4)).astype(np.float32)
    labels = r.integers(1, 81, (b, o)).astype(np.int32)
    valid = np.array([[1, 1, 0, 0], [1, 0, 0, 0], [1, 1, 1, 1]], np.float32)
    obj_attn = r.uniform(0, 1, (b, o, t)).astype(np.float32)
    for kw in ({}, {"captions": caps, "cap_lens": lens, "ixtoword": ixtoword,
                    "class_names": tglove.COCO_CLASSES}):
        np.testing.assert_array_equal(
            tvis.build_object_images(images, boxes, labels, valid, obj_attn,
                                     **kw),
            jvis.build_object_images(images, boxes, labels, valid, obj_attn,
                                     **kw))
