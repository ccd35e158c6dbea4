"""The port's reader of the JAX package's Orbax checkpoints
(``core/zstd.py``, ``core/ocdbt.py``, ``core/zarr.py``,
``core/checkpoint.py::read_orbax``) and every restore site on it, against
the JAX side's own tools as oracles:

* zstd: the system libzstd through ctypes equals ``zstandard`` on every
  frame of the fixtures (OCDBT manifests and nodes, zarr chunks) and on
  hypothesis-made byte strings (raw, RLE, compressible, incompressible,
  empty; with and without content size and checksum); a host without the
  library gets an error that names it;
* OCDBT: every key listed and read equal to tensorstore, on the fixtures,
  on a state written here by ``objgan_tpu.core.checkpoint.save`` and on a
  store of several B-tree levels written by tensorstore;
* the traps: zstd twice, ``bfloat16``, scalar ``"chunks": []``,
  ``value_type: "None"`` for ``EmptyState`` and ``optax.masked``, tuple
  against dict keys, both ``d/`` directories, arrays of several chunks
  (edge chunks, a missing one at ``fill_value``), truncated files raise;
* the four tiny trainer states (``tests/data/orbax_fixtures.tar.xz``, from
  ``tests/make_orbax_fixtures.py``): every leaf bit-exact against Orbax's
  own restore, restored into the port's trainers with each optimiser's
  step equal to optax's ``count``; one step after the restore against
  JAX's own step from the same Orbax step, in full: each state tensor
  within 1e-5 element by element, or relative in norm within 2e-3 for
  Stage C (its gradients' 1e-3 of ``tests/test_torch_train.py``, squared
  by Adam) and 1e-4 for the others; the goldens the card is held to
  (``tests/data/orbax_goldens.npz``, ``train/card_check.py::golden_errors``)
  agree; Adam moments swapped between two same-shaped parameters fail that
  comparison, and the DNets' Adam states rotated do not load; a
  mismatching config warned and left alone, and past a JAX step that does
  not fit, the port's newest step restored;
* a JAX run's directory (the open fault of the port it repairs): seen by
  ``latest_step_in`` and ``_already_trained``, resumed by every trainer's
  entry point with ``state.pt`` saved beside it, kept through keep-N; eval
  and ``sample_pipeline`` start from it, ``TRAIN.NET_E``, ``TRAIN.NET_G``
  and ``export_damsm`` read its steps, and ``load_states`` equals the JAX
  package's composed ``generate`` on it (kept in the goldens);
* ``read_orbax`` and a restore import neither JAX, tensorstore, zstandard
  nor ml_dtypes.
"""

import json
import os
import shutil
import subprocess
import sys
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import tensorstore as ts
import torch
import yaml
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from objgan_tpu.core import checkpoint as jckpt
from objgan_tpu_torch import cli
from objgan_tpu_torch.core import bridge, zstd
from objgan_tpu_torch.core import checkpoint as ckpt
from objgan_tpu_torch.core.ocdbt import OcdbtStore
from objgan_tpu_torch.pipeline_e2e import ObjGanPipeline
from objgan_tpu_torch.train import card_check
from objgan_tpu_torch.train.box import BoxTrainer
from objgan_tpu_torch.train.gan import GanTrainer
from tests.test_torch_compose import _assert_outputs_close
from tests.test_torch_data import FORBIDDEN_MODULES
from tests.torch_parity import (assert_bf16_images_close, example_batch, n,
                                replay_noise, t, tiny, ttiny)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHIVE = os.path.join(REPO, "tests", "data", "orbax_fixtures.tar.xz")
GOLDENS = os.path.join(REPO, "tests", "data", "orbax_goldens.npz")
STAGES = ("gan", "damsm", "box", "shape")
STEP = 1000
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
# each metric of the step after a restore against JAX's, relative: as the
# Stage-C and DAMSM step tests (1e-4), and Stage A and B's (2e-5)
METRIC_RTOL = {"gan": 1e-4, "damsm": 1e-4, "box": 2e-5, "shape": 2e-5}


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixtures")
    with tarfile.open(ARCHIVE) as tar:
        tar.extractall(root, filter="data")
    return root / "orbax"


@pytest.fixture(scope="module")
def goldens():
    return dict(np.load(GOLDENS))


def _tiny_step(root, stage):
    return root / "tiny" / f"objgan_{stage}" / "ckpt" / str(STEP)


def _step_dirs(root):
    return [root / "full" / "coco_objgan_gan" / "ckpt" / str(STEP)] + [
        _tiny_step(root, s) for s in STAGES]


def _stores(root):
    """Every OCDBT store of the fixtures: each step's top-level one and its
    process's."""
    return [d / "default" / sub for d in _step_dirs(root)
            for sub in ("", "ocdbt.process_0")]


def _tensorstore(directory):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{directory}/"}).result()
    return {k: kv.read(k).result().value for k in kv.list().result()}


def _flat(tree, path=()):
    """{Orbax name: leaf} of a nested tree, empty states left out."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {} if tree is None else {".".join(path): tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, path + (str(k),)))
    return out


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().tobytes()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16).tobytes()
    return a.astype(a.dtype.newbyteorder("<")).tobytes()


# -- zstd ---------------------------------------------------------------------


def _reference(frame):
    return zstandard.ZstdDecompressor().decompressobj().decompress(frame)


def _frames(root):
    """Every zstd frame of the fixtures: each OCDBT manifest and node body,
    and each zarr chunk (as tensorstore reads it)."""
    for path in sorted(root.rglob("*")):
        if not path.is_file() or not (path.name == "manifest.ocdbt"
                                      or path.parent.name == "d"):
            continue
        data = path.read_bytes()
        for magic in (b"\x0c\xdb\x3a\x2a", b"\x0c\xdb\x20\xde"):
            pos = data.find(magic)
            while pos >= 0:
                length = int.from_bytes(data[pos + 4:pos + 12], "little")
                body = data[pos + 14:pos + length - 4]
                if data[pos + 12:pos + 14] == b"\x00\x01" and \
                        body[:4] == ZSTD_MAGIC:
                    yield body
                pos = data.find(magic, pos + 1)
    for store in _stores(root):
        for value in _tensorstore(store).values():
            if value[:4] == ZSTD_MAGIC:
                yield value


def test_zstd_equals_zstandard_on_fixture_frames(fixtures):
    n = 0
    for frame in _frames(fixtures):
        assert zstd.decompress(frame) == _reference(frame)
        n += 1
    assert n > 2000  # 1136 chunk values of the full state alone


_DATA = st.one_of(
    st.binary(max_size=3000),  # incompressible (raw blocks), empty
    st.builds(lambda b, k: b * k, st.binary(min_size=1, max_size=1),
              st.integers(1, 300_000)),  # RLE blocks
    st.builds(lambda b, k: b * k, st.binary(min_size=2, max_size=64),
              st.integers(1, 4000)),  # long matches, repeat offsets
    st.builds(lambda seed, k, n: np.random.default_rng(seed).integers(
        0, k, n, dtype=np.uint8).tobytes(), st.integers(0, 99),
        st.sampled_from([2, 16, 200]), st.integers(1, 150_000)),  # Huffman
)


@settings(max_examples=40, deadline=None)
@given(data=_DATA, level=st.sampled_from([-5, 1, 3, 12, 19]),
       content_size=st.booleans(), checksum=st.booleans())
def test_zstd_equals_zstandard_on_generated_bytes(data, level, content_size,
                                                  checksum):
    frame = zstandard.ZstdCompressor(
        level=level, write_content_size=content_size,
        write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == data
    assert zstd.decompress(frame, size_hint=1) == data


def test_zstd_frames_bad_input_and_no_library(monkeypatch):
    """Several frames and a skippable one decode as one stream; bad input
    raises ZstdError; a host without libzstd gets a RuntimeError naming
    it."""
    frames = (zstandard.ZstdCompressor().compress(b"abc" * 999)
              + b"\x50\x2a\x4d\x18\x02\x00\x00\x00xx"
              + zstandard.ZstdCompressor(write_content_size=False).compress(
                  b"def"))
    assert zstd.decompress(frames) == b"abc" * 999 + b"def"
    assert zstd.version().startswith("libzstd 1.")
    for bad in (b"", b"\x28\xb5\x2f\xfd\x00", frames[:-2]):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(bad)
    monkeypatch.setattr(zstd.ctypes.util, "find_library", lambda name: None)
    monkeypatch.setattr(zstd.ctypes, "CDLL", _no_library)
    zstd._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="libzstd.so.1"):
            zstd.decompress(frames)
    finally:
        zstd._lib.cache_clear()


def _no_library(name):
    raise OSError(f"{name}: cannot open shared object file")


# -- OCDBT --------------------------------------------------------------------


def _assert_store_equals_tensorstore(directory):
    want = _tensorstore(directory)
    got = dict(OcdbtStore(str(directory)).items())
    assert sorted(got) == sorted(want) and got == want
    return got


def test_ocdbt_equals_tensorstore_on_fixtures(fixtures):
    keys = [len(_assert_store_equals_tensorstore(d))
            for d in _stores(fixtures)]
    assert keys[0] == keys[1] == 2 * 568  # a .zarray and a chunk per leaf


def _written_state():
    """A small state with every trap: a clip + masked-Adam chain (an
    ``EmptyState``, ``MaskedNode`` leaves, a named ``ScaleByAdamState``) one
    update in, a bf16 leaf, scalars, a tuple, and a leaf large enough to be
    stored out of line."""
    params = {"backbone": {"w": jnp.full((3, 4), 0.5)},
              "proj": {"kernel": jnp.arange(6.0).reshape(2, 3),
                       "bias": jnp.zeros(3)}}
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.masked(
        optax.adam(1e-3), {"backbone": {"w": False},
                           "proj": {"kernel": True, "bias": True}}))
    opt = tx.init(params)
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.1, params)
    _, opt = tx.update(grads, opt, params)
    return {"step": jnp.int32(7), "params": params, "opt": opt,
            "pair": (jnp.linspace(-2, 2, 6).astype(jnp.bfloat16),
                     jnp.float32(3.5)),
            "big": jnp.arange(40_000, dtype=jnp.float32)}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    ckpt_dir = tmp_path_factory.mktemp("written") / "ckpt"
    state = _written_state()
    manager = jckpt.make_manager(str(ckpt_dir))
    jckpt.save(manager, 7, state)
    jckpt.wait(manager)
    return ckpt_dir, state


def test_ocdbt_equals_tensorstore_on_a_state_written_here(written):
    step = written[0] / "7"
    for sub in ("", "ocdbt.process_0"):
        _assert_store_equals_tensorstore(step / "default" / sub)


def test_ocdbt_equals_tensorstore_on_a_deep_tree(tmp_path):
    """Small nodes force interior B-tree levels, with prefix-compressed
    keys and subtree prefixes; small inline and large out-of-line values;
    and a second version on top of the first."""
    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": f"file://{tmp_path}/",
        "config": {"max_inline_value_bytes": 16,
                   "max_decoded_node_bytes": 300,
                   "compression": {"id": "zstd", "level": 5}}}).result()
    r = np.random.default_rng(0)
    with ts.Transaction() as txn:
        for i in range(60):
            kv.with_transaction(txn)[f"key/{i:03d}/abc"] = r.bytes(
                int(r.choice([3, 40])))
    kv["zz"] = b"later"
    got = _assert_store_equals_tensorstore(tmp_path)
    assert len(got) == 61


# -- the traps ----------------------------------------------------------------


def test_zstd_twice(written):
    """The OCDBT node is zstd-compressed, and so is the zarr chunk inside
    it: both layers come off."""
    step = written[0] / "7"
    node = next((step / "default" / "d").iterdir()).read_bytes()
    assert node[13] == 1 and node[14:18] == ZSTD_MAGIC  # node: zstd
    store = OcdbtStore(str(step / "default"))
    chunk = store.read("big/0")
    assert chunk[:4] == ZSTD_MAGIC
    meta = json.loads(store.read("big/.zarray"))
    assert meta["compressor"]["id"] == "zstd"
    tree = ckpt.read_orbax(str(step))
    np.testing.assert_array_equal(tree["big"], np.asarray(written[1]["big"]))


def test_bfloat16_leaf_is_a_torch_bf16_tensor(written):
    step = written[0] / "7"
    meta = json.loads(OcdbtStore(str(step / "default")).read("pair.0/.zarray"))
    assert meta["dtype"] == "bfloat16"
    leaf = ckpt.read_orbax(str(step)).pair[0]
    assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
    assert _bits(leaf) == _bits(written[1]["pair"][0])


def test_scalar_leaves_have_empty_chunks(written):
    step = written[0] / "7"
    store = OcdbtStore(str(step / "default"))
    assert json.loads(store.read("step/.zarray"))["chunks"] == []
    assert store.read("step/0") is not None
    tree = ckpt.read_orbax(str(step))
    assert tree.step.shape == () and int(tree.step) == 7
    assert tree.pair[1].dtype == np.float32 and float(tree.pair[1]) == 3.5


def test_empty_states_read_as_none(written):
    """``EmptyState`` (the clip's) and ``MaskedNode`` (the masked
    backbone's moments) are ``value_type: "None"``: None in the tree; the
    bridge finds the Adam state under the mask and gives moments for the
    unmasked parameters only."""
    step = written[0] / "7"
    meta = json.loads((step / "default" / "_METADATA").read_text())
    nones = [k for k, v in meta["tree_metadata"].items()
             if v["value_metadata"]["value_type"] == "None"]
    assert "('opt', '0')" in nones
    assert "('opt', '1', 'inner_state', '0', 'mu', 'backbone', 'w')" in nones
    tree = ckpt.read_orbax(str(step))
    assert tree.opt[0] is None
    adam = bridge._scale_by_adam(tree.opt)
    assert adam.mu["backbone"]["w"] is None and int(adam.count) == 1
    assert set(bridge.jax_to_torch(adam.mu)) == {"proj.weight", "proj.bias"}
    want = written[1]["opt"][1].inner_state[0]
    np.testing.assert_array_equal(adam.nu["proj"]["kernel"],
                                  np.asarray(want.nu["proj"]["kernel"]))


def test_tuple_and_dict_keys(written):
    tree = ckpt.read_orbax(str(written[0] / "7"))
    assert isinstance(tree, ckpt.OrbaxNode) and isinstance(tree.opt, tuple)
    assert isinstance(tree.pair, tuple) and len(tree.pair) == 2
    assert isinstance(tree.params, ckpt.OrbaxNode)
    assert tree.params is tree["params"]
    assert isinstance(tree.opt[1].inner_state, tuple)
    with pytest.raises(AttributeError):
        tree.no_such_field


@pytest.mark.parametrize("dtype", ["<f4", "<i2", "bfloat16"])
def test_arrays_of_several_chunks_assemble(tmp_path, dtype):
    """An array over several zarr chunks (edge chunks cut to the array),
    written by tensorstore's zarr driver into an OCDBT store, one chunk
    left unwritten: read equal to tensorstore's read, the missing chunk at
    ``fill_value``; where every chunk must be written, it raises."""
    from objgan_tpu_torch.core import zarr

    spec = {"driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
            "path": "arr",
            "metadata": {"shape": [7, 10], "chunks": [3, 4], "dtype": dtype,
                         "fill_value": 2, "compressor": {"id": "zstd",
                                                         "level": 3}},
            "create": True}
    arr = ts.open(spec).result()
    r = np.random.default_rng(0)
    data = (r.normal(size=(7, 10)) * 100).astype(
        np.float32 if dtype == "bfloat16" else dtype)
    if dtype == "bfloat16":
        data = jnp.asarray(data, jnp.bfloat16)
    arr[:, :8].write(data[:, :8]).result()  # chunks (*, 2) stay unwritten
    want = np.asarray(arr.read().result())
    store = OcdbtStore(str(tmp_path))
    got = zarr.read_array(store.read, "arr")
    assert _bits(got) == _bits(want)
    assert np.asarray(got if dtype != "bfloat16" else got.float())[0, 9] == 2
    with pytest.raises(zarr.ZarrError, match="missing"):
        zarr.read_array(store.read, "arr", every_chunk_written=True)


def test_both_data_directories_are_read(fixtures):
    """Orbax's top-level store keeps its B-tree node in ``default/d/`` and
    the chunks too large to inline in ``default/ocdbt.process_0/d/``; the
    reader follows the top-level manifest to both."""
    step = _step_dirs(fixtures)[0]
    store = OcdbtStore(str(step / "default"))
    dict(store.items())
    dirs = {os.path.relpath(os.path.dirname(p), step / "default")
            for p in store._store._files}
    assert dirs == {"d", os.path.join("ocdbt.process_0", "d")}


def _copy_stage(fixtures, tmp_path, stage="box"):
    out = tmp_path / "out"
    shutil.copytree(fixtures / "tiny" / f"objgan_{stage}",
                    out / f"objgan_{stage}")
    return out, out / f"objgan_{stage}" / "ckpt"


@pytest.mark.parametrize("where", ["chunk data", "node", "manifest"])
def test_truncated_files_raise(fixtures, written, tmp_path, where):
    """A truncated file is an I/O fault, not a misfit: the restore raises
    instead of warning and starting fresh. (The written state's large leaf
    is the one chunk stored out of line, in ``ocdbt.process_0/d/``.)"""
    if where == "chunk data":
        d = tmp_path / "ckpt"
        shutil.copytree(written[0], d)
        path, off, length = OcdbtStore(str(d / "7" / "default")).entries()[
            b"big/0"]
        assert os.path.basename(os.path.dirname(os.path.dirname(path))) == \
            "ocdbt.process_0"
        end = off + length
    else:
        _, d = _copy_stage(fixtures, tmp_path)
        default = d / str(STEP) / "default"
        path = (next((default / "d").iterdir()) if where == "node"
                else default / "manifest.ocdbt")
        end = os.path.getsize(path)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:end - 16])
    trainer = BoxTrainer(ttiny("float32"))
    with pytest.raises(ValueError, match="truncated"):
        ckpt.CheckpointManager(str(d)).restore_latest(trainer)


# -- the tiny trainer states --------------------------------------------------


@pytest.mark.parametrize("stage", STAGES)
def test_tiny_state_leaves_are_bit_exact(fixtures, stage):
    import orbax.checkpoint as ocp

    step = _tiny_step(fixtures, stage)
    want = _flat(ocp.PyTreeCheckpointer().restore(str(step / "default")))
    got = _flat(ckpt.read_orbax(str(step)))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.asarray(got[k]).shape == np.asarray(v).shape, k
        assert _bits(got[k]) == _bits(v), k


@pytest.mark.parametrize("stage", STAGES)
def test_restored_trainer_holds_the_state_and_counts(fixtures, stage):
    """Restored into the port's trainer: the step and every optimiser's
    step equal optax's ``count`` (Stage C: G, each DNet's and the object
    D's), and the Adam moments equal the tree's bit for bit."""
    from objgan_tpu_torch.core.config import tiny_test_config

    trainer = card_check._orbax_trainer(
        stage, tiny_test_config().merged({"DTYPE": "float32"}))
    d = _tiny_step(fixtures, stage).parent
    assert ckpt.CheckpointManager(str(d)).restore_latest(trainer) == STEP
    assert trainer.step == STEP
    opts = trainer.optimizers()
    if stage == "gan":
        assert opts == [trainer.g_opt, *trainer.d_opts, trainer.objd_opt]
        assert len(trainer.d_opts) == 3
    for opt in opts:
        states = [opt.state[p] for g in opt.param_groups for p in g["params"]]
        assert states and all(float(s["step"]) == STEP for s in states)
    tree = ckpt.read_orbax(str(_tiny_step(fixtures, stage)))
    want = bridge.jax_state_dict(trainer, tree)
    sd = trainer.state_dict()
    for k, v in want.items():
        assert torch.equal(sd[k].cpu().to(v.dtype), v), k


@pytest.fixture(scope="module")
def jax_steps(fixtures, tmp_path_factory):
    """stage -> (JAX's state after one train step from the tiny Orbax step,
    as the port trainer's state dict; its metrics): the JAX package's
    ``restore_latest`` on a copy of the step, then ``train_step`` with the
    batch and key the goldens were made with. Each stage once."""
    from tests.make_orbax_fixtures import (_numpy, jax_step, jax_trainer,
                                           port_batch)
    from tests.torch_parity import to_numpy_tree

    done = {}

    def step(stage):
        if stage not in done:
            tcfg = ttiny("float32")
            batch = _numpy(port_batch(tcfg, stage))
            jt = jax_trainer(stage, tiny("float32"))
            template = jax.eval_shape(jt.init_state, jax.random.PRNGKey(0),
                                      batch)
            d = tmp_path_factory.mktemp(f"jax_{stage}") / "ckpt"
            shutil.copytree(_tiny_step(fixtures, stage).parent, d)
            state = jckpt.restore_latest(jckpt.make_manager(str(d)),
                                         template)
            new, metrics, _ = jax_step(stage, jt, state, batch)
            sd = bridge.jax_state_dict(card_check._orbax_trainer(stage, tcfg),
                                       to_numpy_tree(new))
            done[stage] = sd, {k: float(v) for k, v in metrics.items()}
        return done[stage]

    return step


def _state_misfits(stage, got, want):
    """[(key, largest error, error relative in norm)] of the tensors of the
    state dict ``got`` that lie neither within STATE_ATOL of JAX's ``want``
    element by element nor within the stage's STATE_RTOL relative in
    norm."""
    bad = []
    for k, w in want.items():
        d = got[k].detach().cpu().double() - w.double()
        a = float(d.abs().max()) if d.numel() else 0.0
        r = float(d.norm()) / max(float(w.double().norm()), 1e-30)
        if a > card_check.STATE_ATOL and r > card_check.STATE_RTOL[stage]:
            bad.append((k, a, r))
    return bad


@pytest.mark.parametrize("stage", STAGES)
def test_tiny_state_step_matches_jax(fixtures, goldens, jax_steps, stage):
    """One step after the restore against JAX's step from the same Orbax
    step: every metric within METRIC_RTOL, and every entry of the state
    dict after it (parameters, Adam moments and counts, the step) as
    ``_state_misfits`` holds it. The goldens the card is held to agree."""
    trainer, metrics, restored = card_check.restored_step(
        stage, str(fixtures / "tiny"), goldens)
    want, want_m = jax_steps(stage)
    assert restored == STEP and trainer.step == STEP + 1
    got = trainer.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want_m.items():
        np.testing.assert_allclose(metrics[k], w, rtol=METRIC_RTOL[stage],
                                   atol=1e-7, err_msg=k)
    assert not _state_misfits(stage, got, want)
    errs = card_check.golden_errors(stage, trainer, metrics, goldens)
    assert errs["step_ok"] and errs["metric_err"] <= METRIC_RTOL[stage], errs
    assert errs["state_score"] <= 1.0, errs


def _swap(tree, a, b):
    """Swap the leaves at the "."-joined paths ``a`` and ``b`` of a
    ``read_orbax`` dict tree."""
    nodes, keys = [], []
    for path in (a, b):
        node, *parts = [tree] + path.split(".")
        for p in parts[:-1]:
            node = node[p]
        nodes.append(node)
        keys.append(parts[-1])
    nodes[0][keys[0]], nodes[1][keys[1]] = (nodes[1][keys[1]],
                                            nodes[0][keys[0]])


def test_moments_on_the_wrong_parameter_fail_the_step(fixtures, goldens,
                                                      jax_steps):
    """The tiny states' Adam moments differ from leaf to leaf, so moments
    that land on the wrong parameter show: G's moments (``mu`` and ``nu``)
    of two same-shaped parameters swapped load without complaint, and the
    step after them fails ``test_tiny_state_step_matches_jax``'s
    comparison at those two parameters; the DNets' Adam states rotated do
    not fit their DNets, and the load raises."""
    tree = ckpt.read_orbax(str(_tiny_step(fixtures, "gan")))
    adam = bridge._scale_by_adam(tree.g_opt)
    mu = _flat(adam.mu)
    by_shape = {}
    for k in sorted(mu):
        by_shape.setdefault(mu[k].shape, []).append(k)
    a, b = next(ks for shape, ks in by_shape.items()
                if len(ks) > 1 and np.prod(shape) > 1)[:2]
    before = bridge.jax_to_torch(adam.mu)
    for moments in (adam.mu, adam.nu):
        _swap(moments, a, b)
    names = {k for k, v in bridge.jax_to_torch(adam.mu).items()
             if not np.array_equal(v, before[k])}
    assert len(names) == 2
    trainer, args, _ = card_check.restored("gan", str(fixtures / "tiny"),
                                           goldens)
    bridge.load_jax_state(trainer, tree)
    trainer.train_step(*args)
    bad = {k for k, _, _ in _state_misfits("gan", trainer.state_dict(),
                                           jax_steps("gan")[0])}
    assert {f"optim.g_net.{n}.exp_avg" for n in names} <= bad
    assert all(any(f".{n}." in f".{k}." for n in names) for k in bad), bad
    rotated = ckpt.read_orbax(str(_tiny_step(fixtures, "gan")))
    rotated["d_opt"] = rotated.d_opt[1:] + rotated.d_opt[:1]
    with pytest.raises(KeyError, match="does not match GanTrainer"):
        bridge.load_jax_state(card_check._orbax_trainer(
            "gan", ttiny("float32")), rotated)


def test_mismatching_config_warns_and_restores_nothing(fixtures, capsys):
    trainer = GanTrainer(ttiny("float32", GAN={"GF_DIM": 16})).init_state(
        torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in trainer.state_dict().items()}
    d = _tiny_step(fixtures, "gan").parent
    assert ckpt.CheckpointManager(str(d)).restore_latest(trainer) is None
    out = capsys.readouterr().out
    assert f"checkpoint at step {STEP}" in out and "INCOMPATIBLE" in out
    after = trainer.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_misfit_jax_step_falls_back_to_the_ports_newest(fixtures, tmp_path,
                                                      capsys):
    """A JAX step that does not fit stays in the directory for good (keep-N
    leaves it), so above a port step it does not hold the run back: the
    resume warns, restores the port's step below it, and does so again
    next time; a save at the JAX step's number warns and leaves it."""
    _, d = _copy_stage(fixtures, tmp_path, "gan")
    cfg = ttiny("float32", GAN={"GF_DIM": 16})
    trainer = GanTrainer(cfg).init_state(torch.Generator().manual_seed(0))
    trainer.step = 7
    manager = ckpt.CheckpointManager(str(d))
    assert manager.save(7, trainer)
    for _ in range(2):
        fresh = GanTrainer(cfg).init_state(torch.Generator().manual_seed(1))
        cli._restore(manager, fresh)
        out = capsys.readouterr().out
        assert f"checkpoint at step {STEP}" in out and "INCOMPATIBLE" in out
        assert "restoring the port's newest step 7 instead" in out
        assert "resumed from step 7" in out
        want = trainer.state_dict()
        assert all(torch.equal(v, want[k])
                   for k, v in fresh.state_dict().items())
    assert not manager.save(STEP, fresh)
    assert f"step {STEP} was NOT saved" in capsys.readouterr().out
    assert ckpt.steps_in(str(d)) == {7: ckpt.PORT, STEP: ckpt.ORBAX}


# -- a JAX run's directory ----------------------------------------------------


def test_jax_run_directory_is_resumed_not_misread(fixtures, tmp_path,
                                                  capsys):
    """``latest_step_in`` and ``_already_trained`` see the Orbax step; a
    resumed run saves ``state.pt`` beside it; keep-N rotates only the
    port's steps, and the Orbax step survives 4 more saves."""
    out, d = _copy_stage(fixtures, tmp_path)
    assert ckpt.latest_step_in(str(d)) == STEP
    assert ckpt.steps_in(str(d)) == {STEP: ckpt.ORBAX}
    assert cli._already_trained(str(d.parent), "box", STEP)
    assert not cli._already_trained(str(d.parent), "box", STEP + 1)
    cfg = ttiny("float32", OUTPUT_DIR=str(out))
    cli.train_box(cfg, max_steps=STEP + 1, device="cpu", log_every=1)
    assert f"resumed from step {STEP}" in capsys.readouterr().out
    assert ckpt.steps_in(str(d)) == {STEP: ckpt.ORBAX, STEP + 1: ckpt.PORT}
    assert (d / str(STEP + 1) / ckpt.STATE_FILE).is_file()
    manager = ckpt.CheckpointManager(str(d))
    trainer = BoxTrainer(cfg)
    for s in range(STEP + 2, STEP + 6):
        assert manager.save(s, trainer)
    assert ckpt.steps_in(str(d)) == {
        STEP: ckpt.ORBAX, **{s: ckpt.PORT for s in range(STEP + 3,
                                                          STEP + 6)}}
    assert manager.steps() == [STEP + 3, STEP + 4, STEP + 5]
    assert manager.latest_step() == STEP + 5


def _yml(tmp_path, out, train):
    cfg = {"OUTPUT_DIR": str(out), "DTYPE": "float32",
           "TRAIN": {"FLAG": train, "BATCH_SIZE": 2},
           "TREE": {"BASE_SIZE": 16},
           "GAN": {"DF_DIM": 8, "GF_DIM": 8, "Z_DIM": 16,
                   "CONDITION_DIM": 16},
           "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": 6, "VOCAB_SIZE": 50,
                    "HIDDEN_DIM": 16, "GLOVE_DIM": 16},
           "OBJ": {"MAX_OBJECTS": 3, "NUM_CLASSES": 7, "ROI_SIZE": 4,
                   "LABEL_DIM": 16, "GMM_COMPONENTS": 4, "SHAPE_SIZE": 16},
           "BOX": {"RNN_SIZE": 32, "INPUT_ENCODING_SIZE": 16,
                   "ATT_HID_SIZE": 16, "MAX_SEQ_LENGTH": 4},
           "SHAPE": {"GF_DIM": 8, "DF_DIM": 8, "HIDDEN_DIM": 8}}
    path = tmp_path / f"tiny_{train}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("stage,module", [
    ("gan", "gan_main"), ("damsm", "pretrain_damsm"), ("box", "box_train"),
    ("shape", "shape_main")])
def test_trainer_entry_point_resumes_a_jax_run(fixtures, tmp_path, capsys,
                                               stage, module):
    import importlib

    out, d = _copy_stage(fixtures, tmp_path, stage)
    main = importlib.import_module(f"objgan_tpu_torch.{module}").main
    main(["--cfg", _yml(tmp_path, out, True), "--max_steps", str(STEP + 1),
          "--device", "cpu"])
    assert f"resumed from step {STEP}" in capsys.readouterr().out
    assert ckpt.steps_in(str(d)) == {STEP: ckpt.ORBAX, STEP + 1: ckpt.PORT}


def test_eval_and_sample_pipeline_start_from_a_jax_run(fixtures, tmp_path,
                                                       capsys):
    from objgan_tpu_torch import eval as teval
    from objgan_tpu_torch import sample_pipeline

    out = tmp_path / "out"
    shutil.copytree(fixtures / "tiny", out)
    yml = _yml(tmp_path, out, False)
    teval.main(["--cfg", yml, "--num_batches", "1", "--device", "cpu"])
    got = capsys.readouterr()
    assert f"evaluating checkpoint at step {STEP}" in got.out
    sample_pipeline.main(["--cfg", yml, "--caption", "two dogs", "--out",
                          str(tmp_path / "pipe"), "--device", "cpu"])
    got = capsys.readouterr()
    for name in ("box", "shape", "gan"):
        assert f"restored the {name} stage from" in got.out
    assert "UNTRAINED" not in got.err
    assert os.listdir(tmp_path / "pipe") == ["pipe_0.png"]


def test_net_e_net_g_and_export_damsm_read_jax_steps(fixtures, tmp_path,
                                                    capsys):
    """``TRAIN.NET_E`` at a JAX DAMSM run's ckpt, ``TRAIN.NET_G`` at a JAX
    Stage-C run's: the encoders are the DAMSM state's, sampling finds its
    generator; ``export_damsm`` writes the lineage text encoder of the JAX
    DAMSM step."""
    from objgan_tpu_torch.core.name_maps import export_rnn_encoder
    from objgan_tpu_torch.tools import export_damsm

    net_e = str(_tiny_step(fixtures, "damsm").parent)
    net_g = str(_tiny_step(fixtures, "gan").parent)
    cfg = ttiny("float32", OUTPUT_DIR=str(tmp_path / "out"),
                TRAIN={"NET_E": net_e, "NET_G": net_g, "FLAG": False})
    text_sd, img_sd = cli.load_damsm_encoders(cfg)
    tree = ckpt.read_orbax(str(_tiny_step(fixtures, "damsm")))
    for got, params in ((text_sd, tree.text_params),
                        (img_sd, tree.img_params)):
        want = bridge.jax_to_torch(params)
        assert sorted(got) == sorted(want)
        assert all(np.array_equal(got[k].numpy(), v) for k, v in want.items())
    samples = cli.sample_gan(cfg, num_batches=1, device="cpu")
    out = capsys.readouterr().out
    assert f"loaded pretrained DAMSM encoders from {net_e} (step {STEP})" \
        in out
    assert "no generator checkpoint" not in out
    assert len(os.listdir(samples)) == cfg.TRAIN.BATCH_SIZE
    text_pth = str(tmp_path / "text_encoder.pth")
    trainer = export_damsm.export(cfg, net_e, text_pth)
    assert f"restored DamsmTrainer (step {STEP})" in capsys.readouterr().out
    exported = torch.load(text_pth, weights_only=True)
    lineage = export_rnn_encoder(trainer.text_enc)
    assert all(torch.equal(exported[k], v) for k, v in lineage.items())


def _compose(fixtures, goldens, dtype):
    """(port, JAX) outputs of the composed ``generate`` from the tiny Orbax
    box, shape and gan steps: the port's ``load_states`` with JAX's noise
    replayed, and what the JAX package's ``load_states`` + ``generate``
    gave on the same directory (``tests/make_orbax_fixtures.py``)."""
    cfg = tiny(dtype)
    caps, lens = example_batch(cfg, batch=2, seed=4)
    pipe = ObjGanPipeline.load_states(ttiny(dtype),
                                      output_dir=str(fixtures / "tiny"),
                                      device="cpu")
    got = pipe.generate(t(caps), t(lens), replay_noise(
        cfg, jax.random.PRNGKey(1), 2))
    pre = f"compose.{dtype}."
    want = {k[len(pre):]: v for k, v in goldens.items()
            if k.startswith(pre) and not k[len(pre):].startswith("images")}
    want["images"] = [goldens[f"{pre}images{i}"]
                      for i in range(cfg.TREE.BRANCH_NUM)]
    return got, want


def test_load_states_from_orbax_equals_jax_generate(fixtures, goldens,
                                                    capsys):
    """The composed pipeline from the tiny Orbax box, shape and gan steps
    against the JAX package's ``load_states`` + ``generate`` on the same
    directory and noise: fp32 (jitted) as ``tests/test_torch_compose.py``
    holds it. bf16 against JAX's ``generate`` run op by op, as the port
    runs: the jitted graph's fusions keep values in fp32 that an op-by-op
    run rounds, and on these weights it errs 2.7x less against fp32 (mean
    0.0029 at 16 px, against 0.0078 op by op; the port's 0.0082). Labels
    and validity exact, the 16 and 32 px images as
    ``torch_parity.assert_bf16_images_close``; at 64 px that rule's mean
    and its error against JAX's fp32 output (at most 1.5x JAX's own bf16
    error), not its share of pixels beyond 5e-2: there the two op-by-op
    bf16 outputs part on 1.6% of pixels, and JAX's own op-by-op and jitted
    outputs part on 4.8%, past the rule's 0.5%."""
    got, want = _compose(fixtures, goldens, "float32")
    out = capsys.readouterr()
    assert "UNTRAINED" not in out.out + out.err
    _assert_outputs_close(got, want)
    got16, want16 = _compose(fixtures, goldens, "bfloat16")
    for key in ("labels", "obj_valid"):
        np.testing.assert_array_equal(n(got16[key]), want16[key])
    assert_bf16_images_close(got16["images"][:2], want16["images"][:2],
                             want["images"][:2])
    g, w, w32 = (n(x["images"][2]) for x in (got16, want16, want))
    assert np.abs(g - w).mean() <= 5e-2 / 5
    assert np.abs(g - w32).mean() <= 1.5 * np.abs(w - w32).mean()


def test_restore_imports_nothing_of_jax(fixtures):
    """``read_orbax`` and a restore through ``CheckpointManager``, in a
    process that imports neither JAX, tensorstore, zstandard nor
    ml_dtypes."""
    d = _tiny_step(fixtures, "gan").parent
    code = (
        "import sys\n"
        "from objgan_tpu_torch.core.checkpoint import CheckpointManager\n"
        "from objgan_tpu_torch.core.config import tiny_test_config\n"
        "from objgan_tpu_torch.train.gan import GanTrainer\n"
        "t = GanTrainer(tiny_test_config().merged({'DTYPE': 'float32'}))\n"
        f"assert CheckpointManager({str(d)!r}).restore_latest(t) == {STEP}\n"
        + FORBIDDEN_MODULES)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
