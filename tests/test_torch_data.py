"""The port's JAX-free host copies (tokenizer, GloVe label tables) against
the JAX package's originals, the param bridge's layout rules, and the
rule that the port never imports JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from objgan_tpu.core.config import Config
from objgan_tpu.data import glove as jglove
from objgan_tpu.data.tokenizer import Vocab as JVocab
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.data import glove as tglove
from objgan_tpu_torch.data.tokenizer import Vocab as TVocab
from objgan_tpu_torch.train.gan import _default_label_table

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    cfg = Config()
    assert tglove.resolve_glove_path(cfg) == jglove.resolve_glove_path(cfg)


def test_default_label_table_81_classes_is_deterministic():
    """At COCO's 81 classes both stages' tables are the same deterministic
    GloVe-or-crc32 table, whatever the generator."""
    cfg = Config()
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
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'flax', 'optax', 'orbax'))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
