"""The four trainers of the port under data parallelism, on 2 gloo ranks on
the CPU (one spawn for the file, 1 thread per rank).

* Each trainer (Stage C, DAMSM, Stage A, Stage B) takes 2 steps at the
  tiny fp32 config on 2 ranks (``parallel.dryrun.tiny_stages``: global
  numpy batches of 4, each rank its 2 rows, the noise of the global batch)
  against the same program at world size 1 in this process: every metric
  within 2e-3 relative; every parameter and first Adam moment within 1e-5
  of its tensor's scale (max(1, max |x|)), the second moment as its square
  root, which is what Adam's step reads (fp32 holds ~7 digits, and the
  untrained tiny G's moments reach ~3e3, where an absolute 1e-5 is below
  one ulp); the ranks' states bitwise equal.
* The same two steps as one ``TRAIN.STEPS_PER_EXECUTION`` = 2 execution
  of each trainer (``tests/torch_ddp_ranks.py::multi_stages``): on the 2
  ranks against world size 1 within those limits, the ranks bitwise
  equal, and at world size 1 bitwise the two single steps.
* The Stage-C and DAMSM steps of the JAX package's state on its global
  batch, against JAX's single-process step (run as
  ``tests/test_torch_train.py`` and ``tests/test_torch_damsm.py`` run it,
  Pallas kernels through their CPU path), within those files' tolerances:
  Stage C metrics rtol 1e-4 and every gradient (averaged over the ranks) a
  relative norm error of at most 1e-3; DAMSM loss terms rtol 1e-5 and
  every gradient within 1e-4 of its tensor's largest magnitude plus 1e-6.
* World size 1 without a group: each trainer's checkpoint after 2 steps
  of ``cli.train_*`` on the synthetic feed is bitwise the one the
  trainers wrote before data parallelism was added (digests of commit
  910735a, computed by the same code, 1 thread).
* ``build_feed`` on a rank: its strided records, its rows of the batch,
  global class ids, the global record count.
* ``python -m objgan_tpu_torch.box_train`` under a 2-rank torchrun on a
  procedural manifest: rank 0 writes the checkpoint and one metrics CSV;
  a second run resumes from it on both ranks; neither rank loads JAX or
  the JAX package.
"""

import csv
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from objgan_tpu.data import synthetic as jsyn
from objgan_tpu.train.damsm import DamsmTrainer as JDamsmTrainer
from objgan_tpu.train.gan import GanTrainer as JGanTrainer
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.parallel import dryrun, sharding
from objgan_tpu_torch.train.damsm import DamsmTrainer
from objgan_tpu_torch.train.gan import GanTrainer
from tests import torch_ddp_ranks
from tests.test_torch_damsm import _jax_keep_mask
from tests.test_torch_data import FORBIDDEN_MODULES
from tests.torch_parity import n, t, tiny, ttiny

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


def _grads(tree_by_prefix):
    out = {}
    for prefix, tree in tree_by_prefix:
        out.update({prefix + k: v for k, v in
                    bridge.jax_to_torch(jax.device_get(tree)).items()})
    return out


def _jax_gan():
    """JAX's Stage-C step at tiny fp32 on a global batch of 2 (as
    ``tests/test_torch_train.py``): state, batch, noise, gradients and
    metrics, the state as the port's state dict."""
    cfg = tiny("float32")
    jt = JGanTrainer(cfg)
    batch = jax.device_get(jsyn.synthetic_batch(cfg, jax.random.PRNGKey(1)))
    state = jax.jit(jt.init_state)(jax.random.PRNGKey(0), batch)
    rng = jax.random.PRNGKey(3)
    (gg, dg, og), metrics = jax.jit(jax.grad(
        lambda g, d, o: jt._losses(g, d, o, state, batch, rng),
        argnums=(0, 1, 2), has_aux=True))(
        state.g_params, state.d_params, state.objd_params)
    k_z, k_ca = jax.random.split(rng)
    b = batch["captions"].shape[0]
    noise = [t(jax.random.normal(k_z, (b, cfg.GAN.Z_DIM))),
             t(jax.random.normal(k_ca, (b, cfg.GAN.CONDITION_DIM)))]
    trainer = GanTrainer(ttiny("float32"))
    bridge.load_jax_state(trainer, jax.device_get(state))
    return {"state": trainer.state_dict(), "noise": noise,
            "batch": {k: ([t(x) for x in v] if isinstance(v, list)
                          else t(v)) for k, v in batch.items()},
            "grads": _grads([("g_net.", gg), ("obj_d.", og)] + [
                (f"d_nets.{i}.", d) for i, d in enumerate(dg)]),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _jax_damsm():
    """JAX's first DAMSM step at tiny fp32 on a global batch of 2 (as
    ``tests/test_torch_damsm.py``), with its dropout keep mask."""
    cfg = tiny("float32")
    jt = JDamsmTrainer(cfg)
    batch = jax.device_get(jsyn.synthetic_batch(cfg, jax.random.PRNGKey(1)))
    batch["images"] = [batch["images"][-1]]
    state = jt.init_state(jax.random.PRNGKey(0), batch)
    key = jax.random.PRNGKey(5)
    mask = _jax_keep_mask(jt, state.text_params, batch, key)
    (_, aux), (tg, ig) = jax.jit(jax.value_and_grad(
        jt.loss, argnums=(0, 1), has_aux=True))(
        state.text_params, state.img_params, batch, key)
    trainer = DamsmTrainer(ttiny("float32"))
    bridge.load_jax_state(trainer, jax.device_get(state))
    return {"state": trainer.state_dict(), "mask": mask,
            "batch": {k: ([t(x) for x in v] if isinstance(v, list)
                          else t(v)) for k, v in batch.items()},
            "grads": _grads([("text_enc.", tg), ("img_enc.", ig)]),
            "aux": {k: float(v) for k, v in aux.items()}}


@pytest.fixture(scope="module")
def jax_ref():
    return {"cfg": ttiny("float32"), "gan": _jax_gan(),
            "damsm": _jax_damsm()}


@pytest.fixture(scope="module")
def ranks(jax_ref):
    return dryrun.spawn(WORLD, torch_ddp_ranks.trainers_on_ranks,
                        (jax_ref,), "cpu", "gloo")


@pytest.fixture(scope="module")
def world_one():
    """The same four tiny dry runs in this process, without a group."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return dryrun.tiny_stages(torch.device("cpu"), WORLD)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("stage", list(dryrun.STAGES))
def test_trainer_on_two_ranks_equals_world_size_one(ranks, world_one,
                                                    stage):
    one = world_one[stage]
    got = [r["stages"][stage] for r in ranks]
    res = dryrun.compare(one, got)  # finite metrics, ranks' states equal
    assert res["rel"] < dryrun.METRIC_RTOL, res
    for k, want in one["state"].items():
        g = got[0]["state"][k]
        if not want.is_floating_point():
            assert torch.equal(g, want), k
            continue
        if k.endswith(".exp_avg_sq"):
            g, want = g.sqrt(), want.sqrt()
        scale = max(1.0, float(want.abs().max()))
        err = float((g.double() - want.double()).abs().max())
        assert err <= 1e-5 * scale, (k, err, scale)
    if stage == "gan":
        assert res["pixel_err"] < dryrun.PIXEL_ATOL


@pytest.fixture(scope="module")
def multi_one():
    """The K-step executions of ``multi_stages`` in this process, without a
    group."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return torch_ddp_ranks.multi_stages(torch.device("cpu"), WORLD)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("stage", list(dryrun.STAGES))
def test_k_step_execution_on_two_ranks_equals_world_size_one(
        ranks, world_one, multi_one, stage):
    """``TRAIN.STEPS_PER_EXECUTION`` = 2 under gloo: each rank's one K-step
    execution against world size 1's, as the single steps are held; at
    world size 1 it equals the two single steps of ``world_one`` to the
    bit, and its metrics are their mean."""
    one, single = multi_one[stage], world_one[stage]
    for k, v in single["state"].items():
        assert torch.equal(one["state"][k], v), k
    for k, v in one["metrics"].items():
        mean = np.mean([m[k] for m in single["metrics"]], dtype=np.float32)
        np.testing.assert_allclose(v, mean, rtol=1e-6, err_msg=k)
    for r in ranks:
        got = r["multi"][stage]
        for k, v in one["metrics"].items():
            assert abs(got["metrics"][k] - v) <= dryrun.METRIC_RTOL * max(
                abs(v), 1e-12), k
        for k, want in one["state"].items():
            g = got["state"][k]
            if not want.is_floating_point():
                assert torch.equal(g, want), k
                continue
            if k.endswith(".exp_avg_sq"):
                g, want = g.sqrt(), want.sqrt()
            scale = max(1.0, float(want.abs().max()))
            assert float((g.double() - want.double()).abs().max()) <= \
                1e-5 * scale, k
    for k, v in ranks[0]["multi"][stage]["state"].items():
        assert torch.equal(ranks[1]["multi"][stage]["state"][k], v), k


def test_stage_c_on_two_ranks_matches_jax(ranks, jax_ref):
    want = jax_ref["gan"]
    for r in ranks:
        got = r["gan"]
        assert set(got["metrics"]) == set(want["metrics"])
        for k, w in want["metrics"].items():
            np.testing.assert_allclose(float(got["metrics"][k]), w,
                                       rtol=1e-4, atol=1e-7, err_msg=k)
        assert set(got["grads"]) == set(want["grads"])
        for k, w in want["grads"].items():
            g = n(got["grads"][k])
            err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= 1e-3, (k, err)


def test_damsm_on_two_ranks_matches_jax(ranks, jax_ref):
    want = jax_ref["damsm"]
    for r in ranks:
        got = r["damsm"]
        for k, w in want["aux"].items():
            np.testing.assert_allclose(float(got["metrics"][k]), w,
                                       rtol=1e-5, err_msg=k)
        assert set(got["grads"]) == set(want["grads"])
        for k, w in want["grads"].items():
            scale = np.abs(w).max()
            assert scale > 0, k
            assert np.abs(n(got["grads"][k]) - w).max() <= \
                1e-4 * scale + 1e-6, k


_DIGESTS = """
import hashlib, os, sys, tempfile
import torch
torch.set_num_threads(1)
from objgan_tpu_torch import cli
from objgan_tpu_torch.core.checkpoint import load_latest
from objgan_tpu_torch.core.config import tiny_test_config

root = sys.argv[1]
for stage, fn in (("gan", cli.train_gan), ("damsm", cli.pretrain_damsm),
                  ("box", cli.train_box), ("shape", cli.train_shape)):
    cfg = tiny_test_config().merged({"DTYPE": "float32",
                                     "OUTPUT_DIR": os.path.join(root, stage)})
    fn(cfg, max_steps=2, device="cpu", log_every=1)
    step, sd = load_latest(os.path.join(root, stage,
                                        f"{cfg.CONFIG_NAME}_{stage}", "ckpt"))
    h = hashlib.sha256()
    for k in sorted(sd):
        v = sd[k].detach().cpu().contiguous()
        h.update(f"{k}:{v.dtype}:{tuple(v.shape)}".encode())
        h.update(v.numpy().tobytes())
    print(f"DIGEST {stage} {step} {h.hexdigest()}")
"""

# the checkpoints the one-process trainers wrote before data parallelism
# (commit 910735a), by the code above
_BEFORE = {
    "gan": "5584c4a33d8f447c3004e1ed793d0ae44276d6058e96159aa1ebf37eb09c71e4",
    "damsm": "6e00be7bb2937d8da75410df81b349528a40ffca04ab40c70db180d0370827a"
             "3",
    "box": "6466291fe5eda68bea849be6d124841e082ccfc3d77f70e9d656a336595b5791",
    "shape": "694969109b33b30aaf5b0552538b6c3f8d1805cc25783f24faa9d5e9a463a5"
             "6f",
}


def test_world_size_one_checkpoints_are_bitwise_unchanged(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run([sys.executable, "-c", _DIGESTS, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = {ln.split()[1]: (int(ln.split()[2]), ln.split()[3])
           for ln in proc.stdout.splitlines() if ln.startswith("DIGEST")}
    assert got == {k: (2, v) for k, v in _BEFORE.items()}


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    from objgan_tpu_torch.data.procedural import build_manifest

    return build_manifest(str(tmp_path_factory.mktemp("proc")), n_images=8,
                          size=64, seed=3)


def test_build_feed_on_a_rank(manifest, monkeypatch):
    """Rank 1 of 2: records 1, 3, 5, 7 at 2 rows a batch, class ids their
    global indices, the global count for the epoch schedule."""
    from objgan_tpu_torch.core.config import tiny_test_config
    from objgan_tpu_torch.data.feed import build_feed

    cfg = tiny_test_config().merged({
        "OBJ": {"NUM_CLASSES": 81}, "TEXT": {"VOCAB_SIZE": 500},
        "DATA_DIR": os.path.dirname(manifest), "TRAIN": {"BATCH_SIZE": 4}})
    monkeypatch.setattr(sharding, "rank_and_world", lambda: (1, WORLD))
    feed, count, _ = build_feed(cfg, manifest, with_images=False)
    assert count == 8
    ids = set()
    for _ in range(2):  # one epoch of this rank's 4 records
        batch = next(feed)
        assert batch["captions"].shape[0] == 2
        ids.update(int(i) for i in batch["class_ids"])
    assert ids == {1, 3, 5, 7}


def _torchrun(yml, max_steps, world=WORLD):
    code = ("import runpy, sys\n"
            "sys.argv = ['box_train', '--cfg', sys.argv[1], '--manifest', "
            "sys.argv[2], '--max_steps', sys.argv[3], '--log_every', '1', "
            "'--device', 'cpu']\n"
            "runpy.run_module('objgan_tpu_torch.box_train', "
            "run_name='__main__')\n" + FORBIDDEN_MODULES)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={world}", "--no-python", sys.executable, "-c",
         code, str(yml[0]), yml[1], str(max_steps)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_box_train_under_torchrun_writes_once_and_resumes(manifest,
                                                          tmp_path):
    out = tmp_path / "out"
    yml = tmp_path / "tiny.yml"
    yml.write_text(yaml.safe_dump({
        "CONFIG_NAME": "ddp", "OUTPUT_DIR": str(out),
        "DATA_DIR": os.path.dirname(manifest),
        "TRAIN": {"BATCH_SIZE": 4, "FLAG": True},
        "TEXT": {"EMBEDDING_DIM": 16, "HIDDEN_DIM": 8, "WORDS_NUM": 12,
                 "VOCAB_SIZE": 256},
        "OBJ": {"MAX_OBJECTS": 4, "NUM_CLASSES": 81, "LABEL_DIM": 16},
        "BOX": {"RNN_SIZE": 16, "INPUT_ENCODING_SIZE": 16,
                "ATT_HID_SIZE": 16, "MAX_SEQ_LENGTH": 4}}))
    first = _torchrun((yml, manifest), 2)
    assert first.returncode == 0, first.stderr[-3000:]
    stage = out / "ddp_box"
    assert sorted(os.listdir(stage / "ckpt")) == ["2"]
    with open(stage / "box_metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["step"] for r in rows] == ["1", "2"]  # one writer
    assert all(np.isfinite(float(r["box_total"])) for r in rows)
    second = _torchrun((yml, manifest), 4)
    assert second.returncode == 0, second.stderr[-3000:]
    assert second.stdout.count("resumed from step 2") == WORLD
    assert sorted(os.listdir(stage / "ckpt")) == ["2", "4"]
