"""The port's torch-native checkpoints (``core/checkpoint.py``) and the
trainers' checkpoint state (``train/common.py::Trainer``): round trips of
``DamsmTrainer`` and ``GanTrainer`` (every network, the EMA generator, the
label table, every optimiser's Adam state and the step), keep-N, ignored
leftovers of an interrupted save, the collision guard, a mismatching tree
(warning, ``None``) and a truncated file (raises); and the step-loop
helpers of ``cli.py`` against the JAX package's."""

import os

import numpy as np
import pytest
import torch

from objgan_tpu import cli as jcli
from objgan_tpu_torch import cli
from objgan_tpu_torch.core import checkpoint as ckpt
from objgan_tpu_torch.data import synthetic as tsyn
from objgan_tpu_torch.train.damsm import DamsmTrainer
from objgan_tpu_torch.train.gan import GanTrainer, train_noise
from tests.torch_parity import port_cfg, tiny, ttiny

torch.set_num_threads(2)


def _damsm(seed=0, steps=1):
    cfg = ttiny("float32")
    trainer = DamsmTrainer(cfg).init_state(torch.Generator().manual_seed(seed))
    for s in range(steps):
        gen = torch.Generator().manual_seed(10 + s)
        batch = tsyn.synthetic_batch(cfg, gen)
        trainer.train_step(batch, trainer.text_enc.keep_mask(
            batch["captions"], gen))
    return trainer


def _gan(seed=0, steps=1):
    cfg = ttiny("float32")
    trainer = GanTrainer(cfg).init_state(torch.Generator().manual_seed(seed))
    for s in range(steps):
        gen = torch.Generator().manual_seed(10 + s)
        noise = train_noise(cfg, 2, gen, "cpu")
        trainer.train_step(tsyn.synthetic_batch(cfg, gen), noise["z"],
                           noise["ca_eps"])
    return trainer


def _equal(a, b):
    assert set(a) == set(b)
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("make", [_damsm, _gan], ids=["damsm", "gan"])
def test_round_trip(tmp_path, make):
    """Save after a step, restore into a trainer of other weights: every
    tensor equal, the step and the Adam state included."""
    trainer = make(seed=0, steps=1)
    sd = trainer.state_dict()
    adam = [k for k in sd if k.startswith("optim.")]
    assert adam and all(k.endswith(("step", "exp_avg", "exp_avg_sq"))
                        for k in adam)
    assert int(sd["step"]) == 1
    if make is _gan:  # EMA, label table, every D's and object-D's moments
        assert {"ema_g", "label_table", "text_enc", "img_enc"} <= {
            k.split(".")[0] for k in sd}
        assert any(k.startswith("optim.d_nets.2.") for k in adam)
        assert any(k.startswith("optim.obj_d.") for k in adam)
    manager = ckpt.CheckpointManager(str(tmp_path))
    assert manager.save(1, trainer)
    other = make(seed=1, steps=0)
    assert not _equal(other.state_dict(), sd)
    assert manager.restore_latest(other) == 1
    assert other.step == 1
    assert _equal(other.state_dict(), sd)
    # the file holds CPU tensors under the same keys
    saved = torch.load(tmp_path / "1" / ckpt.STATE_FILE, weights_only=True)
    assert _equal(saved, sd)


def test_restored_trainer_steps_like_the_original(tmp_path):
    """The Adam state restored in place: one more step from the original
    and from the restored trainer gives the same state."""
    trainer = _damsm(steps=2)
    manager = ckpt.CheckpointManager(str(tmp_path))
    manager.save(trainer.step, trainer)
    restored = _damsm(seed=3, steps=0)
    manager.restore_latest(restored)
    cfg = trainer.cfg
    for t in (trainer, restored):
        gen = torch.Generator().manual_seed(99)
        batch = tsyn.synthetic_batch(cfg, gen)
        t.train_step(batch, t.text_enc.keep_mask(batch["captions"], gen))
    assert _equal(trainer.state_dict(), restored.state_dict())


def test_fresh_trainer_state_has_zero_adam_moments():
    sd = _damsm(steps=0).state_dict()
    assert int(sd["step"]) == 0
    assert all(not v.any() for k, v in sd.items() if k.startswith("optim."))


def test_keep_n_after_five_saves(tmp_path):
    trainer = _damsm(steps=0)
    manager = ckpt.CheckpointManager(str(tmp_path), max_to_keep=3)
    for step in range(1, 6):
        assert manager.save(step, trainer)
    assert sorted(os.listdir(tmp_path)) == ["3", "4", "5"]
    assert manager.latest_step() == ckpt.latest_step_in(str(tmp_path)) == 5


def test_leftovers_of_an_interrupted_save_are_ignored(tmp_path):
    trainer = _damsm(steps=0)
    manager = ckpt.CheckpointManager(str(tmp_path))
    manager.save(2, trainer)
    (tmp_path / "9.tmp-abc123").mkdir()
    (tmp_path / "9.tmp-abc123" / ckpt.STATE_FILE).write_bytes(b"partial")
    (tmp_path / "notes").mkdir()
    assert ckpt.latest_step_in(str(tmp_path)) == 2
    assert manager.restore_latest(_damsm(seed=4, steps=0)) == 2
    assert ckpt.latest_step_in(str(tmp_path / "absent")) is None


def test_collision_guard(tmp_path):
    """A step already saved is not written again."""
    manager = ckpt.CheckpointManager(str(tmp_path))
    first = _damsm(seed=0, steps=0)
    assert manager.save(3, first)
    path = tmp_path / "3" / ckpt.STATE_FILE
    before = path.read_bytes()
    assert not manager.save(3, _damsm(seed=5, steps=0))
    assert path.read_bytes() == before
    assert sorted(os.listdir(tmp_path)) == ["3"]


def _drop(sd, key):
    return {k: v for k, v in sd.items() if k != key}


@pytest.mark.parametrize("change", ["missing", "unexpected", "shape"])
def test_mismatched_tree_warns_and_returns_none(tmp_path, capsys, change):
    trainer = _damsm(steps=0)
    sd = trainer.state_dict()
    key = "img_enc.emb_features.weight"
    if change == "missing":
        sd = _drop(sd, key)
    elif change == "unexpected":
        sd["img_enc.extra.weight"] = torch.zeros(3)
    else:
        sd[key] = torch.zeros(2, 2)
    (tmp_path / "4").mkdir()
    torch.save(sd, tmp_path / "4" / ckpt.STATE_FILE)
    target = _damsm(seed=1, steps=0)
    before = target.state_dict()
    assert ckpt.CheckpointManager(str(tmp_path)).restore_latest(target) is None
    assert "INCOMPATIBLE" in capsys.readouterr().out
    assert _equal(target.state_dict(), before)  # left as it was


def test_truncated_file_raises(tmp_path):
    trainer = _damsm(steps=0)
    manager = ckpt.CheckpointManager(str(tmp_path))
    manager.save(1, trainer)
    path = tmp_path / "1" / ckpt.STATE_FILE
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 2])
    with pytest.raises(Exception):
        manager.restore_latest(_damsm(seed=1, steps=0))


def test_already_trained(tmp_path, capsys):
    out = str(tmp_path)
    assert not cli._already_trained(out, "damsm", 5)
    os.makedirs(tmp_path / "ckpt" / "5")
    assert not cli._already_trained(out, "damsm", 10 ** 9)
    assert not cli._already_trained(out, "damsm", 6)
    assert cli._already_trained(out, "damsm", 5)
    assert "nothing to do" in capsys.readouterr().out


@pytest.mark.parametrize("n_records,max_steps,snapshot_steps", [
    (0, 10 ** 9, 0), (100, 10 ** 9, 0), (100, 7, 0), (3, 10 ** 9, 0),
    (100, 10 ** 9, 11)])
def test_apply_epoch_schedule_matches_jax(n_records, max_steps,
                                          snapshot_steps):
    jc = tiny("float32", TRAIN={"BATCH_SIZE": 4, "MAX_EPOCH": 3,
                                "SNAPSHOT_INTERVAL": 2,
                                "SNAPSHOT_STEPS": snapshot_steps})
    want_cfg, want = jcli.apply_epoch_schedule(jc, n_records, max_steps)
    got_cfg, got = cli.apply_epoch_schedule(port_cfg(jc), n_records,
                                            max_steps)
    assert got == want
    assert got_cfg.TRAIN.SNAPSHOT_STEPS == want_cfg.TRAIN.SNAPSHOT_STEPS


def test_to_device_keeps_values_and_dtypes():
    batch = {"captions": np.arange(6, dtype=np.int32).reshape(2, 3),
             "images": [np.ones((2, 4, 4, 3), np.float32)]}
    got = cli.to_device(batch, "cpu")
    assert got["captions"].dtype == torch.int32
    assert torch.equal(got["captions"], torch.arange(6, dtype=torch.int32
                                                     ).reshape(2, 3))
    assert isinstance(got["images"], list) and got["images"][0].shape == (
        2, 4, 4, 3)
