"""The port's worker-process feed (``data/grain_feed.py``) against the JAX
package's Grain feed.

* A row for ``(record, item seed, record id)`` equals JAX's
  ``_RecordTransform`` row to the bit, classic and wire, with and without
  images and augmentation.
* Every record appears once per epoch; batches straddle epochs; a bounded
  feed drops its remainder; the batches are bitwise equal for 0 (in the
  calling process), 1, 2 and 3 worker processes.
* Mixed image records, bad labels and an oversized vocabulary raise as
  JAX's ``grain_feed`` does.
* The wire cache keys on stable record ids across epochs, and counts every
  worker's copy against the RAM budget.
* ``build_feed(grain=True)`` is that feed; the worker side imports no CUDA
  code and neither JAX, Grain nor the JAX package.
"""

import os
import subprocess
import sys

import pytest

from objgan_tpu.data.grain_feed import _RecordTransform as JTransform
from objgan_tpu.data.grain_feed import grain_feed as jax_grain_feed
from objgan_tpu.data.tokenizer import Vocab as JVocab
from objgan_tpu_torch.data import feed as tfeed
from objgan_tpu_torch.data import grain_feed as tgrain
from objgan_tpu_torch.data import pipeline as tpipe
from objgan_tpu_torch.data.procedural import build_manifest
from objgan_tpu_torch.data.tokenizer import Vocab as TVocab
from tests.test_torch_data import (FORBIDDEN_MODULES, _assert_batches_equal,
                                   _feed_cfgs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(records, caption list) of a 12-record procedural manifest at 64 px,
    with its images' directory as DATA_DIR."""
    path = build_manifest(str(tmp_path_factory.mktemp("proc")), n_images=12,
                          size=64, seed=0)
    records = tpipe.load_records_json(path)
    return records, [c for r in records for c in r["captions"]], \
        os.path.dirname(path)


def _cfgs(root, **train):
    return _feed_cfgs(DATA_DIR=root, WORKERS=0,
                      TEXT={"VOCAB_SIZE": 500, "WORD_DROPOUT": 0.3},
                      TRAIN={"BATCH_SIZE": 4, **train})


@pytest.mark.parametrize("wire", [True, False])
@pytest.mark.parametrize("with_images", [True, False])
@pytest.mark.parametrize("augment", [True, False])
def test_row_matches_jax_record_transform(data, wire, with_images, augment):
    records, caps, root = data
    jc, tc = _cfgs(root)
    want = JTransform(jc, JVocab.build(caps), with_images, augment,
                      wire=wire, cacheable=wire)
    got = tgrain._RecordTransform(tc, TVocab.build(caps), with_images,
                                  augment, wire=wire, cacheable=wire)
    for epoch in range(2):  # the second one from the caches
        for i, rec in enumerate(records):
            item = (rec, 5 * 100003 + epoch * 12 + i, 3 + 2 * i)
            _assert_batches_equal(tgrain._collate([got(item)]),
                                  tgrain._collate([want(item)]))


def _ids(batches):
    return [int(c) for b in batches for c in b["class_ids"]]


def test_every_record_once_per_epoch_and_remainder_dropped(data):
    records, caps, root = data
    _, tc = _cfgs(root, BATCH_SIZE=5)
    batches = list(tgrain.grain_feed(tc, records, TVocab.build(caps),
                                     seed=2, num_epochs=2, wire=True))
    assert len(batches) == 4  # 24 rows: 4 batches of 5, 4 rows dropped
    ids = _ids(batches)
    assert sorted(ids[:12]) == list(range(12))  # epoch 1
    assert len(set(ids[12:])) == 8  # epoch 2 so far, straddling batch 3
    # an endless feed goes on across epochs with a new order each
    endless = tgrain.grain_feed(tc, records, TVocab.build(caps), seed=2)
    ids = _ids(next(endless) for _ in range(12))
    for e in range(5):
        assert sorted(ids[12 * e:12 * (e + 1)]) == list(range(12))
    assert ids[:12] != ids[12:24]
    endless.close()


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_same_batches_for_any_worker_count(data, workers):
    """Worker processes give the batches of the in-process feed, to the
    bit, over two epochs of the wire feed with augmentation."""
    records, caps, root = data
    _, tc = _cfgs(root)
    kw = dict(seed=4, num_epochs=2, wire=True, augment=True)
    want = list(tgrain.grain_feed(tc, records, TVocab.build(caps), **kw))
    got = list(tgrain.grain_feed(tc, records, TVocab.build(caps),
                                 worker_count=workers, **kw))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


@pytest.mark.parametrize("case", ["mixed_images", "labels", "vocab"])
def test_raises_as_jax(data, case):
    records, caps, root = data
    jc, tc = _cfgs(root)
    records = [dict(r) for r in records]
    if case == "mixed_images":
        del records[2]["image_file"]
    elif case == "labels":
        records[3]["labels"] = [0] + records[3]["labels"][1:]
    else:
        caps = caps + [f"w{i}" for i in range(600)]
    messages = []
    for fn, cfg, vocab in ((jax_grain_feed, jc, JVocab.build(caps)),
                           (tgrain.grain_feed, tc, TVocab.build(caps))):
        with pytest.raises(ValueError) as exc:
            fn(cfg, records, vocab)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


def _spy(monkeypatch):
    created = []

    class Spy(tgrain._RecordTransform):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            created.append(self)

    monkeypatch.setattr(tgrain, "_RecordTransform", Spy)
    return created


def test_wire_cache_keys_are_stable_across_epochs(data, monkeypatch):
    """Keyed by the record's global id, not the output position: after
    three epochs the cache holds exactly one entry per record."""
    records, caps, root = data
    created = _spy(monkeypatch)
    _, tc = _cfgs(root)
    for _ in tgrain.grain_feed(tc, records, TVocab.build(caps), seed=3,
                               wire=True, num_epochs=3, id_offset=1,
                               id_stride=2):
        pass
    (spy,) = created
    assert sorted(spy.feed._cache) == [1 + 2 * i for i in range(12)]


def test_wire_cache_budget_counts_every_worker(data, monkeypatch):
    records, caps, root = data
    created = _spy(monkeypatch)
    _, tc = _cfgs(root)
    per = tpipe.wire_record_bytes(tc)
    # a quarter of "RAM" holds the dataset twice, not three times
    monkeypatch.setattr(tpipe, "_physical_ram_bytes",
                        lambda: 4 * 2 * 12 * per)
    for workers in (1, 2, 3):
        tgrain.grain_feed(tc, records, TVocab.build(caps), wire=True,
                          worker_count=workers)
    assert [t.feed._cache is not None for t in created] == [True, True,
                                                           False]


def test_build_feed_grain_is_the_worker_feed(data):
    records, caps, root = data
    manifest = os.path.join(root, "manifest.json")
    _, tc = _cfgs(root, FLAG=True)
    for wire in (False, True):
        feed, n, vocab = tfeed.build_feed(tc, manifest, wire=wire,
                                          grain=True)
        assert n == 12 and vocab.wordtoix == TVocab.build(caps).wordtoix
        want = tgrain.grain_feed(tc, records, vocab, seed=tc.RNG_SEED,
                                 augment=True, wire=wire)
        for _ in range(4):
            _assert_batches_equal(next(feed), next(want))
        feed.close()
        want.close()


def test_worker_side_imports_no_cuda_code_and_no_jax(data):
    """What a worker imports to unpickle its dataset and build a row: no
    kernel build module, no CUDA initialisation, no JAX, Grain or JAX
    package; and a feed from one worker process runs in such a process."""
    records, caps, root = data
    code = (
        "import sys, torch\n"
        "from objgan_tpu_torch.data.grain_feed import (_RecordTransform,"
        " grain_feed)\n"
        "from objgan_tpu_torch.core.config import tiny_test_config\n"
        "from objgan_tpu_torch.data.pipeline import load_records_json\n"
        "from objgan_tpu_torch.data.tokenizer import Vocab\n"
        "cfg = tiny_test_config().merged({'DATA_DIR': sys.argv[1],"
        " 'OBJ': {'NUM_CLASSES': 81}, 'TEXT': {'VOCAB_SIZE': 500}})\n"
        "recs = load_records_json(sys.argv[1] + '/manifest.json')\n"
        "vocab = Vocab.build(c for r in recs for c in r['captions'])\n"
        "_RecordTransform(cfg, vocab, True, wire=True)((recs[0], 1, 0))\n"
        "assert 'objgan_tpu_torch.ops._build' not in sys.modules\n"
        "assert not torch.cuda.is_initialized()\n"
        "feed = grain_feed(cfg, recs, vocab, worker_count=1, wire=True)\n"
        "assert next(feed)['image_u8'].shape == (2, 64, 64, 3)\n"
        "feed.close()\n" + FORBIDDEN_MODULES)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, root], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_fork_server_stops_with_the_last_worker_feed(data):
    """No process outlives the worker feeds: the fork server runs while one
    is open and stops when the last one is closed or runs out; a later
    feed starts it anew."""
    records, caps, root = data
    code = (
        "import os, sys\n"
        "from objgan_tpu_torch.data.grain_feed import grain_feed\n"
        "from objgan_tpu_torch.core.config import tiny_test_config\n"
        "from objgan_tpu_torch.data.pipeline import load_records_json\n"
        "from objgan_tpu_torch.data.tokenizer import Vocab\n"
        "def servers():\n"
        "    n = 0\n"
        "    for pid in filter(str.isdigit, os.listdir('/proc')):\n"
        "        try:\n"
        "            stat = open(f'/proc/{pid}/stat').read()\n"
        "            cmd = open(f'/proc/{pid}/cmdline').read()\n"
        "        except OSError:\n"
        "            continue\n"
        "        ppid = int(stat.rsplit(')', 1)[1].split()[1])\n"
        "        n += ppid == os.getpid() and 'forkserver' in cmd\n"
        "    return n\n"
        "cfg = tiny_test_config().merged({'DATA_DIR': sys.argv[1],"
        " 'OBJ': {'NUM_CLASSES': 81}, 'TEXT': {'VOCAB_SIZE': 500}})\n"
        "recs = load_records_json(sys.argv[1] + '/manifest.json')\n"
        "vocab = Vocab.build(c for r in recs for c in r['captions'])\n"
        "a = grain_feed(cfg, recs, vocab, worker_count=1)\n"
        "b = grain_feed(cfg, recs, vocab, worker_count=1, num_epochs=1)\n"
        "next(a), next(b)\n"
        "assert servers() == 1\n"
        "a.close()\n"
        "assert servers() == 1  # b is still open\n"
        "assert len(list(b)) == 5  # runs out: 6 batches of 2 in all\n"
        "assert servers() == 0\n"
        "c = grain_feed(cfg, recs, vocab, worker_count=1)\n"
        "next(c)\n"
        "assert servers() == 1\n"
        "c.close()\n"
        "assert servers() == 0\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, root], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
