"""Write the Orbax test fixtures with the JAX package's own
``objgan_tpu.core.checkpoint.save`` (a script, not a test module: the GPU
host has no JAX to write them, so they are committed).

    JAX_PLATFORMS=cpu python tests/make_orbax_fixtures.py

Each fixture is one step of a JAX train state whose leaves start from the
JAX package's real ``init_state`` and are made to compress: every leaf is
its own first K values tiled over the leaf (so GroupNorm scales stay near 1
and biases near 0; K prime, so a conv kernel's taps differ along every
axis), every Adam ``mu`` a block of K values tiled, seeded by the crc32 of
the parameter's Orbax name so that no two leaves hold the same moments,
``nu`` its square (>= 0), and every optax ``count`` and the ``step`` STEP.
Random values do not compress: the tracked tree of the repo has little
room.

The steps go into one archive, ``tests/data/orbax_fixtures.tar.xz``
(Orbax's JSON metadata is most of their bytes and compresses ~20x); a user
unpacks it (``tarfile``) and gets, under ``orbax/``:

* ``full/coco_objgan_gan/ckpt/1000``: a ``GanTrainState``
  at ``cfg/coco_objgan.yml`` width (K = 61), and ``full_leaves.json``:
  each leaf's path (its Orbax name, keys joined by "."), dtype, shape and
  the sha256 of its little-endian bytes, from JAX's tree.
* ``tiny/objgan_{damsm,box,shape,gan}/ckpt/1000``: one
  state of each trainer at ``tiny_test_config`` in fp32 (K = 13), laid out
  as a run's ``OUTPUT_DIR`` (``CONFIG_NAME`` objgan), so the composed serve
  restores box, shape and gan from it. Each is tiled as above, then takes
  WARM_STEPS real JAX train steps, so that its Adam moments are of the
  size of its gradients' and differ from leaf to leaf, and is tiled again,
  moments included (each leaf its own first K values).
* ``tests/data/orbax_goldens.npz``: for each tiny state, JAX's metrics of
  one train step from it on the port's synthetic batch of a fixed seed
  (its sha256 kept, so a host whose torch draws another batch fails
  loudly), with JAX's noise for that step (Stage C's z and ca_eps, Stage
  B's z, DAMSM's dropout keep mask), and after the step, for every float
  entry of the port trainer's state dict: its first 4 values, its L2 norm
  and its dot products with 4 seeded normal vectors
  (``objgan_tpu_torch/train/card_check.py::state_summary``); and the
  JAX package's composed ``generate`` from the tiny box, shape and gan
  steps (its ``load_states``) at fp32 (jitted) and bf16 (op by op) on
  ``tests/torch_parity.py::example_batch`` with PRNGKey(1)'s noise
  (``compose.<dtype>.*``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import tarfile
import tempfile
import zlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from objgan_tpu_torch.train.card_check import (  # noqa: E402
    ORBAX_SEEDS, batch_digest, state_summary)

DATA = os.path.join(REPO, "tests", "data")
ARCHIVE = os.path.join(DATA, "orbax_fixtures.tar.xz")
GOLDENS = os.path.join(DATA, "orbax_goldens.npz")
STEP = 1000
K_FULL, K_TINY = 61, 13
WARM_STEPS = 2  # real JAX steps taken before a tiny state is tiled
COMPOSE_SEED = 1


def _names(path):
    return [str(getattr(p, "name", getattr(p, "key", getattr(p, "idx", p))))
            for p in path]


def orbax_name(path) -> str:
    return ".".join(_names(path))


def moment_block(names, k: int) -> np.ndarray:
    """The K values of a parameter's Adam ``mu`` (``names``: the path of its
    ``mu`` or ``nu`` leaf), seeded by its ``mu`` leaf's Orbax name."""
    at = max(i for i, n in enumerate(names) if n in ("mu", "nu"))
    name = ".".join(names[:at] + ["mu"] + names[at + 1:])
    return (np.random.default_rng(zlib.crc32(name.encode())).standard_normal(
        k) * 1e-3).astype(np.float32)


def compressible(state, k: int, seeded_moments: bool = True):
    """``state`` (a JAX train state) with its leaves tiled as the module
    docstring says; with ``seeded_moments`` False the Adam moments too are
    their own first K values tiled."""

    def fill(path, x):
        x = np.asarray(x)
        field = [p.name for p in path
                 if isinstance(p, jax.tree_util.GetAttrKey)]
        if _names(path) == ["step"] or (field and field[-1] == "count"):
            return jnp.asarray(np.full_like(x, STEP))
        if seeded_moments and field and field[-1] in ("mu", "nu"):
            mu = moment_block(_names(path), k)
            block = mu if field[-1] == "mu" else mu * mu
        else:
            block = x.reshape(-1)[:k]
        return jnp.asarray(np.resize(block, x.size).reshape(x.shape).astype(
            x.dtype))

    return jax.tree_util.tree_map_with_path(fill, state)


def save(state, ckpt_dir: str) -> None:
    from objgan_tpu.core import checkpoint as jckpt

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    manager = jckpt.make_manager(ckpt_dir)
    jckpt.save(manager, STEP, state)
    jckpt.wait(manager)


def leaf_table(state):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        a = np.asarray(leaf)
        le = a.astype(a.dtype.newbyteorder("<"))
        out[orbax_name(path)] = {
            "dtype": le.dtype.str, "shape": list(a.shape),
            "sha256": hashlib.sha256(le.tobytes()).hexdigest()}
    return out


def port_batch(cfg, kind: str, batch=None):
    """The port's synthetic batch of ``kind``'s seed (torch's CPU
    generator), which both packages take."""
    from objgan_tpu_torch.data import synthetic as tsyn

    gen = torch.Generator().manual_seed(ORBAX_SEEDS[kind])
    return tsyn.synthetic_batch(cfg, gen, batch,
                                with_images=kind in ("gan", "damsm"))


def _numpy(batch):
    return {k: ([x.numpy() for x in v] if isinstance(v, list) else v.numpy())
            for k, v in batch.items()}


def make_full(root: str) -> None:
    from objgan_tpu.core.config import cfg_from_file
    from objgan_tpu.train.gan import GanTrainer as JGan
    from objgan_tpu_torch.core import config as pc

    cfg = cfg_from_file(os.path.join(REPO, "cfg", "coco_objgan.yml"))
    tcfg = pc.cfg_from_file(os.path.join(REPO, "cfg", "coco_objgan.yml"))
    batch = _numpy(port_batch(tcfg, "gan", batch=2))  # init reads shapes
    jt = JGan(cfg)
    state = jax.jit(jt.init_state)(jax.random.PRNGKey(0), batch)
    state = compressible(jax.device_get(state), K_FULL)
    out = os.path.join(root, "full", f"{cfg.CONFIG_NAME}_gan", "ckpt")
    save(state, out)
    leaves = leaf_table(state)
    with open(os.path.join(root, "full_leaves.json"), "w") as f:
        json.dump({"config": "cfg/coco_objgan.yml", "step": STEP,
                   "count": STEP, "leaves": leaves}, f, indent=0,
                  sort_keys=True)
    nbytes = sum(np.prod(v["shape"]) * int(v["dtype"][-1])
                 for v in leaves.values())
    print(f"full: {len(leaves)} leaves, {nbytes / 1e6:.1f} MB")


def _tiny_cfgs():
    from tests.torch_parity import tiny, ttiny

    return tiny("float32"), ttiny("float32")


STAGES = ("gan", "damsm", "box", "shape")  # stage i inits from PRNGKey(i)


def jax_trainer(stage: str, cfg):
    from objgan_tpu.train.box import BoxTrainer
    from objgan_tpu.train.damsm import DamsmTrainer
    from objgan_tpu.train.gan import GanTrainer
    from objgan_tpu.train.shape import ShapeTrainer

    return {"gan": GanTrainer, "damsm": DamsmTrainer, "box": BoxTrainer,
            "shape": ShapeTrainer}[stage](cfg)


def jax_step(stage: str, jt, state, batch):
    """(state after JAX's train step, its metrics, its noise) of the tiny
    ``stage`` trainer ``jt`` from ``state``, with the stage's step key."""
    from tests.test_torch_damsm import _jax_keep_mask
    from tests.torch_parity import replay_shape_z

    cfg = jt.cfg
    key = jax.random.PRNGKey(200 + STAGES.index(stage))
    b = cfg.TRAIN.BATCH_SIZE
    if stage == "gan":
        k_z, k_ca = jax.random.split(key)
        noise = {"z": jax.random.normal(k_z, (b, cfg.GAN.Z_DIM)),
                 "ca_eps": jax.random.normal(k_ca,
                                             (b, cfg.GAN.CONDITION_DIM))}
    elif stage == "shape":
        noise = {"z": replay_shape_z(cfg, key, b)}
    elif stage == "damsm":
        noise = {"keep_mask": _jax_keep_mask(jt, state.text_params, batch,
                                             key)}
    else:
        noise, key = {}, None
    args = (state, batch) + ((key,) if key is not None else ())
    new, metrics = jax.jit(jt.train_step)(*args)
    return new, metrics, noise


def make_tiny(root: str, goldens) -> None:
    from objgan_tpu_torch.core import bridge
    from objgan_tpu_torch.train.card_check import _orbax_trainer
    from tests.torch_parity import to_numpy_tree

    cfg, tcfg = _tiny_cfgs()
    for i, kind in enumerate(STAGES):
        tb = port_batch(tcfg, kind)
        batch = _numpy(tb)
        jt = jax_trainer(kind, cfg)
        state = jt.init_state(jax.random.PRNGKey(i), batch)
        state = compressible(jax.device_get(state), K_TINY)
        for _ in range(WARM_STEPS):  # moments of the size of real ones
            state = jax_step(kind, jt, state, batch)[0]
        state = compressible(jax.device_get(state), K_TINY,
                             seeded_moments=False)
        save(state, os.path.join(root, "tiny", f"{cfg.CONFIG_NAME}_{kind}",
                                 "ckpt"))
        new, metrics, noise = jax_step(kind, jt, state, batch)
        final = bridge.jax_state_dict(_orbax_trainer(kind, tcfg),
                                      to_numpy_tree(new))
        keys, head, norm, proj = state_summary(final)
        goldens[f"{kind}.batch_sha256"] = np.array(batch_digest(tb))
        goldens[f"{kind}.step"] = np.array(int(new.step))
        for k, v in noise.items():
            goldens[f"{kind}.noise.{k}"] = np.asarray(v)
        for k, v in metrics.items():
            goldens[f"{kind}.metric.{k}"] = np.asarray(v, np.float64)
        goldens[f"{kind}.keys"] = keys
        goldens[f"{kind}.head"] = head
        goldens[f"{kind}.norm"] = norm
        goldens[f"{kind}.projection"] = proj
        print(f"tiny {kind}: {len(keys)} state entries, metrics "
              f"{ {k: round(float(v), 5) for k, v in metrics.items()} }")


def make_compose(root: str, goldens) -> None:
    """JAX's composed ``generate`` (``ObjGanPipeline.load_states`` from the
    tiny box, shape and gan steps) at fp32 and bf16 on the example
    captions with PRNGKey(COMPOSE_SEED)'s noise: jitted at fp32, op by op
    at bf16 (``jax.disable_jit``), where the jitted graph's fusions keep
    values in fp32 that an op-by-op run, the port's or JAX's, rounds to
    bf16."""
    from objgan_tpu.data import synthetic as jsyn
    from objgan_tpu.pipeline_e2e import ObjGanPipeline as JPipeline
    from tests.torch_parity import example_batch, tiny

    for dtype in ("float32", "bfloat16"):
        cfg = tiny(dtype)
        pipe = JPipeline(cfg)
        batch = jax.device_get(jsyn.synthetic_batch(cfg,
                                                    jax.random.PRNGKey(0)))
        states = pipe.load_states(jax.random.PRNGKey(0), batch,
                                  output_dir=os.path.join(root, "tiny"))
        caps, lens = example_batch(cfg, batch=2, seed=4)
        args = (states, jnp.asarray(caps), jnp.asarray(lens),
                jax.random.PRNGKey(COMPOSE_SEED))
        if dtype == "float32":
            out = jax.jit(pipe.generate)(*args)
        else:  # op by op, as the port runs: XLA's fused graph rounds less
            with jax.disable_jit():
                out = pipe.generate(*args)
        keys = ("labels", "obj_valid") + (
            ("boxes", "masks") if dtype == "float32" else ())
        for k in keys:
            goldens[f"compose.{dtype}.{k}"] = np.asarray(out[k])
        for i, img in enumerate(out["images"]):  # fp32 at either DTYPE
            goldens[f"compose.{dtype}.images{i}"] = np.asarray(img)


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    torch.set_num_threads(4)
    goldens = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "orbax")
        make_full(root)
        make_tiny(root, goldens)
        make_compose(root, goldens)
        with tarfile.open(ARCHIVE, "w:xz", preset=9) as tar:
            tar.add(root, arcname="orbax")
    np.savez_compressed(GOLDENS, **goldens)
    print(f"wrote {ARCHIVE} ({os.path.getsize(ARCHIVE)} bytes) and {GOLDENS}")


if __name__ == "__main__":
    main()
