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

# a subprocess that imported any of these broke the port's rule
FORBIDDEN_MODULES = (
    "bad = [m for m in sys.modules if m in ('jax', 'objgan_tpu') or "
    "m.startswith(('jax.', 'flax', 'optax', 'orbax', 'objgan_tpu.'))]\n"
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
