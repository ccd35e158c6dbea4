"""The port's uint8 wire feed and the data tools against the JAX package.

* ``CocoFeed(wire=True)``: seven batches (two and a third epochs) equal
  JAX's to the bit, dtypes too, for file and inline images, with and
  without masks, images and augmentation, with the record cache on
  (``cache_limit=None``, the budget allows it) and off (``cache_limit=0``):
  a row that wrote into a cached array would corrupt the second epoch.
* The cache policy: ``wire_record_bytes``, ``wire_cache_allowed`` under a
  RAM size set by the test, and ``_cgroup_mem_limit`` on fake nested v1
  and v2 cgroup trees, equal to JAX's.
* The data tools: the port's ``procedural.build_manifest`` writes the same
  ``manifest.json`` and byte-identical PNGs as JAX's for one seed, and
  ``coco_convert.convert`` gives JAX's records; their command lines run.
"""

import json
import os
import subprocess
import sys

import pytest

from objgan_tpu.core import config as jconfig
from objgan_tpu.data import pipeline as jpipe
from objgan_tpu.data.tokenizer import Vocab as JVocab
from objgan_tpu_torch.core import config as tconfig
from objgan_tpu_torch.data import pipeline as tpipe
from objgan_tpu_torch.data.procedural import build_manifest
from objgan_tpu_torch.data.tokenizer import Vocab as TVocab
from tests.test_torch_data import (FORBIDDEN_MODULES, _assert_batches_equal,
                                   _feed_cfgs, _inline)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """A 12-record procedural manifest at 64 px, from the port's tool."""
    return build_manifest(str(tmp_path_factory.mktemp("proc")), n_images=12,
                          size=64, seed=0)


@pytest.mark.parametrize("cache", ["on", "off"])
@pytest.mark.parametrize("source", ["file", "inline"])
@pytest.mark.parametrize("with_images", [True, False])
@pytest.mark.parametrize("with_masks", [True, False])
@pytest.mark.parametrize("augment", [True, False])
def test_wire_feed_matches_jax(manifest, cache, source, with_images,
                               with_masks, augment):
    records = tpipe.load_records_json(manifest)
    if source == "inline":
        records = _inline(records)
    jc, tc = _feed_cfgs(TEXT={"VOCAB_SIZE": 500, "WORD_DROPOUT": 0.3})
    caps = [c for rec in records for c in rec["captions"]]
    kw = dict(seed=7, wire=True, with_images=with_images,
              with_masks=with_masks, augment=augment,
              image_root=os.path.dirname(manifest),
              cache_limit=None if cache == "on" else 0)
    want_feed = jpipe.CocoFeed(jc, records, JVocab.build(caps), **kw)
    got_feed = tpipe.CocoFeed(tc, records, TVocab.build(caps), **kw)
    assert (got_feed._cache is None) == (want_feed._cache is None) == (
        cache == "off")
    want, got = iter(want_feed), iter(got_feed)
    for _ in range(7):  # 28 rows of 12 records
        _assert_batches_equal(next(got), next(want))
    if cache == "on":
        assert sorted(got_feed._cache) == list(range(12))


def test_wire_cache_policy_matches_jax(monkeypatch):
    """``wire_record_bytes`` for each config and flag, and the all-or-
    nothing cache decision around the budget's edge, as JAX decides it."""
    cfgs = [(jconfig.Config(), tconfig.Config()),
            (jconfig.tiny_test_config(), tconfig.tiny_test_config()),
            (jconfig.cfg_from_file(os.path.join(REPO, "cfg",
                                                "damsm_coco.yml")),
             tconfig.cfg_from_file(os.path.join(REPO, "cfg",
                                                "damsm_coco.yml")))]
    for jc, tc in cfgs:
        for flags in ((True, True), (True, False), (False, True),
                      (False, False)):
            per = tpipe.wire_record_bytes(tc, *flags)
            assert per == jpipe.wire_record_bytes(jc, *flags)
            for ram in (4 << 20, 128 << 30, 4 * per * 1000):
                monkeypatch.setattr(jpipe, "_physical_ram_bytes",
                                    lambda: ram)
                monkeypatch.setattr(tpipe, "_physical_ram_bytes",
                                    lambda: ram)
                for n in (1000, 1001, 118_000):
                    for limit in (None, 999, 200_000):
                        assert tpipe.wire_cache_allowed(
                            tc, n, limit, *flags) == \
                            jpipe.wire_cache_allowed(jc, n, limit, *flags)
    per = tpipe.wire_record_bytes(tc)
    monkeypatch.setattr(tpipe, "_physical_ram_bytes", lambda: 4 * per * 1000)
    assert tpipe.wire_cache_allowed(tc, 1000)
    assert not tpipe.wire_cache_allowed(tc, 1001)


def test_cgroup_mem_limit_matches_jax(tmp_path):
    """Nested v1 and v2 groups, a tighter ancestor, an unmapped namespace
    path, an unlimited v2 group: the same limit as JAX's reader finds."""
    v1, v2 = tmp_path / "memory", tmp_path / "unified"
    (v1 / "job" / "task7").mkdir(parents=True)
    (v2 / "slice" / "run").mkdir(parents=True)
    proc = tmp_path / "cgroup"
    (v1 / "memory.limit_in_bytes").write_text(str(1 << 62))
    (v1 / "job" / "task7" / "memory.limit_in_bytes").write_text(
        str(16 << 30))
    (v2 / "memory.max").write_text("max\n")
    (v2 / "slice" / "run" / "memory.max").write_text(str(24 << 30))

    def both():
        kw = dict(proc_file=str(proc), v2_root=str(v2), v1_root=str(v1))
        got = tpipe._cgroup_mem_limit(**kw)
        assert got == jpipe._cgroup_mem_limit(**kw)
        return got

    proc.write_text("9:memory:/job/task7\n1:cpu:/job/task7\n")
    assert both() == 16 << 30
    (v1 / "job" / "memory.limit_in_bytes").write_text(str(8 << 30))
    assert both() == 8 << 30
    proc.write_text("9:memory:/elsewhere/unmapped\n")
    assert both() == 1 << 62
    proc.write_text("0::/slice/run\n")
    assert both() == 24 << 30
    (v2 / "slice" / "run" / "memory.max").write_text("max\n")
    assert both() is None
    proc.write_text("0::/slice/run\n9:memory:/job/task7\n")
    assert both() == 8 << 30
    proc.unlink()  # /proc unreadable: the mount roots
    assert both() == 1 << 62
    assert tpipe._physical_ram_bytes() == jpipe._physical_ram_bytes()


def test_procedural_manifest_matches_jax(tmp_path):
    """Same seed: the same manifest and byte-identical PNGs."""
    from objgan_tpu.data.procedural import build_manifest as jax_build

    got = build_manifest(str(tmp_path / "port"), n_images=12, size=64,
                         seed=3)
    want = jax_build(str(tmp_path / "jax"), n_images=12, size=64, seed=3)
    with open(got, "rb") as f, open(want, "rb") as g:
        text = f.read()
        assert text == g.read()
    assert len(json.loads(text)) == 12
    images = sorted(os.listdir(tmp_path / "jax" / "images"))
    assert sorted(os.listdir(tmp_path / "port" / "images")) == images
    for name in images:
        assert (tmp_path / "port" / "images" / name).read_bytes() == \
            (tmp_path / "jax" / "images" / name).read_bytes(), name


@pytest.mark.parametrize("kw", [{}, {"min_area": 0.2}, {"max_objects": 1},
                                {"max_images": 1}])
def test_coco_convert_matches_jax(kw):
    from objgan_tpu.data.coco_convert import (COCO_ID_TO_CONTIGUOUS,
                                              convert as jax_convert)
    from objgan_tpu_torch.data.coco_convert import (
        COCO_ID_TO_CONTIGUOUS as port_ids, convert)
    from tests.test_coco_convert import _fake_coco

    assert port_ids == COCO_ID_TO_CONTIGUOUS
    got = convert(*_fake_coco(), **kw)
    assert got and got == jax_convert(*_fake_coco(), **kw)


def test_data_tool_command_lines_without_jax(tmp_path):
    """``python -m objgan_tpu_torch.data.procedural``, ``.coco_convert`` and
    ``.tools.profile_feed --wire --grain`` in a process that imports
    neither JAX, Grain nor the JAX package."""
    from tests.test_coco_convert import _fake_coco

    inst, caps = _fake_coco()
    (tmp_path / "inst.json").write_text(json.dumps(inst))
    (tmp_path / "caps.json").write_text(json.dumps(caps))
    code = (
        "import runpy, sys\n"
        "out = sys.argv[1]\n"
        "sys.argv = ['procedural', '--out', out + '/d', '--n', '3',"
        " '--size', '32']\n"
        "runpy.run_module('objgan_tpu_torch.data.procedural',"
        " run_name='__main__')\n"
        "sys.argv = ['coco_convert', '--instances', out + '/inst.json',"
        " '--captions', out + '/caps.json', '--out', out + '/m.json']\n"
        "runpy.run_module('objgan_tpu_torch.data.coco_convert',"
        " run_name='__main__')\n"
        "sys.argv = ['profile_feed', '--manifest', out + '/d/manifest.json',"
        " '--wire', '--grain', '--reps', '1', '--device', 'cpu']\n"
        "runpy.run_module('objgan_tpu_torch.tools.profile_feed',"
        " run_name='__main__')\n" + FORBIDDEN_MODULES)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "wrote 3 records" in proc.stdout
    assert "wrote 2 records" in proc.stdout
    assert "4. host->device (cpu)" in proc.stdout
    assert len(json.loads((tmp_path / "d" / "manifest.json").read_text())) \
        == 3
    assert len(os.listdir(tmp_path / "d" / "images")) == 3
