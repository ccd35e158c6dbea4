"""The 1-vs-N dry run of data parallelism: the port's counterpart of
``__graft_entry__.py::dryrun_multichip``.

    python -m objgan_tpu_torch.parallel.dryrun N [--device cuda|cpu] \\
        [--backend gloo|nccl] [--bf16_cfg cfg/coco_objgan.yml | tiny]

Spawns N ranks (``torch.multiprocessing``, spawn) and runs in each of them,
and in this process at world size 1 (no process group) from the same
initial weights, on deterministic global batches made with numpy:

1. K = 2 chained steps of each trainer (Stage C, DAMSM, Stage A, Stage B)
   at the tiny fp32 config, 2 rows per rank; for Stage C also sampling
   with the EMA generator. As JAX's dry run asserts: every metric finite
   on both sides, the worst relative metric delta < 2e-3 and the sampled
   pixels' max |d| < 5e-3;
2. bf16 Stage-C steps at ``--bf16_cfg`` (default ``cfg/coco_objgan.yml``,
   its global batch of 16; ``tiny`` for the tiny config at 2 rows per
   rank): every metric finite, the parameters of all ranks bitwise equal
   after the steps, ms per step beside world size 1's.

It prints one summary line. On the CPU (``--device cpu``, gloo) every
kernel runs its plain twin; on the card the ranks run kernels K1-K3 and
K1 backward, and each counts its launches. ``--device cuda`` puts rank r
on card r modulo the card count, so two gloo ranks share one card; NCCL
refuses that.
``run`` returns what the summary reads (``chip_smoke.py`` reads it too).
"""

from __future__ import annotations

import argparse
import hashlib
import math
import os
import shutil
import socket
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from objgan_tpu_torch import cli
from objgan_tpu_torch.core.config import (Config, cfg_from_file,
                                          tiny_test_config)
from objgan_tpu_torch.parallel import sharding
from objgan_tpu_torch.train.box import BoxTrainer
from objgan_tpu_torch.train.common import step_generator
from objgan_tpu_torch.train.damsm import DamsmTrainer
from objgan_tpu_torch.train.gan import GanTrainer, train_noise
from objgan_tpu_torch.train.shape import ShapeTrainer

K_STEPS = 2
BF16_STEPS = 3  # the first of them warms up; ms per step from the rest
METRIC_RTOL = 2e-3
PIXEL_ATOL = 5e-3
STAGES = {"gan": GanTrainer, "damsm": DamsmTrainer, "box": BoxTrainer,
          "shape": ShapeTrainer}


def numpy_batch(cfg: Config, rows: int, seed: int) -> Dict[str, Any]:
    """A COCO-shaped global batch made with numpy from ``seed``: the keys,
    dtypes and value ranges of ``data/synthetic.py``, class ids
    ``arange(rows)``."""
    r = np.random.default_rng(seed)
    t, o, s = cfg.TEXT.WORDS_NUM, cfg.OBJ.MAX_OBJECTS, cfg.OBJ.SHAPE_SIZE
    cap_lens = r.integers(3, t + 1, rows).astype(np.int32)
    captions = r.integers(1, cfg.TEXT.VOCAB_SIZE, (rows, t)).astype(np.int32)
    captions[np.arange(t)[None] >= cap_lens[:, None]] = 0
    n_obj = r.integers(1, o + 1, rows)
    obj_valid = (np.arange(o)[None] < n_obj[:, None]).astype(np.float32)
    labels = (r.integers(1, cfg.OBJ.NUM_CLASSES, (rows, o))
              * obj_valid).astype(np.int32)
    boxes = np.concatenate([r.uniform(0.0, 0.7, (rows, o, 2)),
                            r.uniform(0.1, 0.3, (rows, o, 2))],
                           -1).astype(np.float32)
    grid = np.linspace(-1.0, 1.0, s, dtype=np.float32)
    centre = r.uniform(-0.3, 0.3, (2, rows, o, 1, 1)).astype(np.float32)
    shapes = (np.sqrt((grid[None, None, None, :] - centre[0]) ** 2
                      + (grid[None, None, :, None] - centre[1]) ** 2)
              < 0.7).astype(np.float32)
    return {
        "captions": captions, "cap_lens": cap_lens,
        "class_ids": np.arange(rows, dtype=np.int32), "labels": labels,
        "boxes": boxes, "shapes": shapes, "obj_valid": obj_valid,
        "images": [r.uniform(-1.0, 1.0, (rows, size, size, 3)).astype(
            np.float32) for size in cfg.branch_sizes],
    }


def local_part(batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a numpy global batch."""
    start, size = sharding.process_local_batch_slice(
        len(batch["captions"]))

    def rows(x):
        if isinstance(x, list):
            return [rows(v) for v in x]
        return x[start:start + size]

    return {k: rows(v) for k, v in batch.items()}


def _launches() -> Dict[str, int]:
    from objgan_tpu_torch.ops import groupnorm, roi_align

    return {"K1": groupnorm.launches, "K2": roi_align.launches["fwd"],
            "K3": roi_align.launches["bwd"],
            "K1 backward": groupnorm.bwd_launches}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in _launches().items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_stage(device: torch.device, stage: str, cfg: Config,
              batches: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """``stage``'s trainer with fresh weights from ``cfg.RNG_SEED``, one
    step per global batch (this rank's rows, the step function of
    ``cli``), at whatever world size this process is in. Returns every
    step's metrics, the state after the steps (CPU), the kernel launches,
    and for Stage C the finest images that the EMA generator samples for
    the rank's rows of the last batch."""
    trainer = cli.fresh_trainer(cfg, STAGES[stage](cfg), device)
    sharding.broadcast_module_(trainer)
    before = _launches()
    metrics = []
    for k, batch in enumerate(batches):
        m = cli.train_step(cfg, trainer, cli.to_device(local_part(batch),
                                                       device), k, device)
        metrics.append({name: float(v) for name, v in m.items()})
    out = {"metrics": metrics, "launches": _since(before)}
    if stage == "gan":
        local = cli.to_device(local_part(batches[-1]), device)
        noise = train_noise(cfg, local["captions"].shape[0], step_generator(
            cfg.RNG_SEED, len(batches), device, cli._SNAPSHOT), device)
        images = trainer.sample(local, noise["z"], noise["ca_eps"])["images"]
        out["images"] = images[-1].float().cpu()
    out["state"] = {k: v.detach().cpu().clone()
                    for k, v in trainer.state_dict().items()}
    return out


def tiny_stages(device: torch.device,
                world: int) -> Dict[str, Dict[str, Any]]:
    """``run_stage`` of every trainer at the tiny fp32 config, on K global
    batches of 2 rows per rank of ``world``."""
    cfg = tiny_cfg(2 * world)
    batches = [numpy_batch(cfg, cfg.TRAIN.BATCH_SIZE, 100 + k)
               for k in range(K_STEPS)]
    return {s: run_stage(device, s, cfg, batches) for s in STAGES}


def tiny_cfg(rows: int, dtype: str = "float32") -> Config:
    return tiny_test_config().merged({"DTYPE": dtype,
                                      "TRAIN": {"BATCH_SIZE": rows}})


def bf16_cfg(name: str, world: int) -> Config:
    """``cfg/coco_objgan.yml`` (or another yml) as it stands, or ``tiny``:
    the tiny bf16 config at 2 rows per rank."""
    if name == "tiny":
        return tiny_cfg(2 * world, "bfloat16")
    return cfg_from_file(name)


def bf16_steps(device: torch.device, cfg_name: str,
               world: int) -> Dict[str, Any]:
    """BF16_STEPS Stage-C steps at ``cfg_name``'s width on its global
    batch (``bf16_cfg``): every step's metrics, the synchronised ms of each
    step, the digest of the parameters after them and the kernel
    launches."""
    cfg = bf16_cfg(cfg_name, world)
    trainer = cli.fresh_trainer(cfg, GanTrainer(cfg), device)
    sharding.broadcast_module_(trainer)
    before = _launches()
    metrics, ms = [], []
    for k in range(BF16_STEPS):
        batch = cli.to_device(local_part(numpy_batch(
            cfg, cfg.TRAIN.BATCH_SIZE, 200 + k)), device)
        _sync(device)
        t0 = time.monotonic()
        m = cli.train_step(cfg, trainer, batch, k, device)
        _sync(device)
        ms.append((time.monotonic() - t0) * 1e3)
        metrics.append({name: float(v) for name, v in m.items()})
    digest = hashlib.sha256()
    for name, p in trainer.named_parameters():
        digest.update(name.encode())
        digest.update(p.detach().cpu().contiguous().view(
            torch.uint8).numpy().tobytes())
    return {"metrics": metrics, "ms": ms, "digest": digest.hexdigest(),
            "launches": _since(before), "batch": cfg.TRAIN.BATCH_SIZE}


def dry_run(device: torch.device, bf16: str, world: int) -> Dict[str, Any]:
    """What each of ``world`` ranks, and the world-size-1 process, runs on
    the global batches of ``world`` ranks."""
    return {"tiny": tiny_stages(device, world),
            "bf16": bf16_steps(device, bf16, world)}


# -- ranks ----------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, device: str, backend: str,
          fn: Callable, args: tuple, out_dir: str) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    sharding.maybe_initialize_distributed(dev, backend)
    try:
        result = fn(dev, *args)
        sharding.barrier()
    finally:
        torch.distributed.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn(world: int, fn: Callable, args: tuple = (), device="cuda",
          backend: Optional[str] = None) -> List[Any]:
    """``fn(device, *args)`` in ``world`` spawned ranks of one process
    group; the ranks' results, in rank order. ``fn`` and ``args`` are
    pickled (``fn`` by its module path). A rank that fails ends the others
    and raises here."""
    import torch.multiprocessing as mp

    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    out_dir = tempfile.mkdtemp(prefix="dryrun_")
    try:
        mp.spawn(_rank, args=(world, _free_port(), str(device), backend, fn,
                              args, out_dir), nprocs=world, join=True)
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


# -- the comparison -------------------------------------------------------------


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def compare(one: Dict[str, Any], ranks: List[Dict[str, Any]]
            ) -> Dict[str, Any]:
    """One stage's world-size-1 result against its ranks': finite
    metrics, the worst relative (and the largest absolute) metric delta,
    the largest parameter and Adam-state difference, the ranks' states
    equal to each other and, for Stage C, the sampled pixels."""
    for side, res in [("world-1", one)] + [(f"rank {r}", x)
                                           for r, x in enumerate(ranks)]:
        bad = [k for m in res["metrics"] for k, v in m.items()
               if not math.isfinite(v)]
        _check(not bad, f"non-finite {side} metrics: {sorted(set(bad))}")
    deltas, abs_err = {}, 0.0
    for k_step, (want, *got) in enumerate(zip(
            one["metrics"], *(r["metrics"] for r in ranks))):
        for k, w in want.items():
            for g in got:
                abs_err = max(abs_err, abs(g[k] - w))
                d = abs(g[k] - w) / max(abs(w), 1e-6)
                deltas[f"{k}@{k_step + 1}"] = max(d, deltas.get(
                    f"{k}@{k_step + 1}", 0.0))
    worst = max(deltas, key=deltas.get)
    state_err = max(float((r["state"][k].double()
                           - one["state"][k].double()).abs().max())
                    for r in ranks for k in one["state"]
                    if one["state"][k].is_floating_point())
    same = all(torch.equal(ranks[0]["state"][k], r["state"][k])
               for r in ranks[1:] for k in one["state"])
    _check(same, "the ranks' states differ after the steps")
    out = {"worst": worst, "rel": deltas[worst], "abs": abs_err,
           "state_err": state_err,
           "launches": [r["launches"] for r in ranks],
           "launches_1": one["launches"]}
    if "images" in one:
        img = torch.cat([r["images"] for r in ranks])
        _check(bool(torch.isfinite(img).all())
               and bool(torch.isfinite(one["images"]).all()),
               "non-finite sampled pixels")
        out["pixel_err"] = float((img - one["images"]).abs().max())
    return out


def run(world: int, device="cuda", backend: Optional[str] = None,
        bf16: str = "cfg/coco_objgan.yml") -> Dict[str, Any]:
    """The dry run: ``dry_run`` in ``world`` ranks and at world size 1
    (here, no process group), compared. Raises on a failed check; returns
    per stage ``compare``'s result, and the bf16 steps' results."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    one = dry_run(device, bf16, world)
    ranks = spawn(world, dry_run, (bf16, world), device, backend)
    out = {"stages": {}}
    for s in STAGES:
        res = compare(one["tiny"][s], [r["tiny"][s] for r in ranks])
        _check(res["rel"] < METRIC_RTOL,
               f"{s}: 1-vs-{world}-rank metric divergence: {res['worst']} "
               f"rel {res['rel']:.2e}")
        if "pixel_err" in res:
            _check(res["pixel_err"] < PIXEL_ATOL,
                   f"{s}: 1-vs-{world}-rank sampled pixels diverge: max|d| "
                   f"{res['pixel_err']:.2e}")
        out["stages"][s] = res
    got = [r["bf16"] for r in ranks]
    for side, res in [("world-1", one["bf16"])] + [
            (f"rank {r}", x) for r, x in enumerate(got)]:
        bad = [k for m in res["metrics"] for k, v in m.items()
               if not math.isfinite(v)]
        _check(not bad, f"bf16 {side}: non-finite metrics {bad}")
    _check(len({r["digest"] for r in got}) == 1,
           "bf16: the ranks' parameters differ after the steps")
    out["bf16"] = {"one": one["bf16"], "ranks": got}
    return out


def summary(world: int, res: Dict[str, Any]) -> str:
    parts = [f"dryrun({world}): ok"]
    for s, r in res["stages"].items():
        line = (f"{s} {K_STEPS} steps worst metric rel {r['rel']:.2e} "
                f"({r['worst']}), state max|d| {r['state_err']:.2e}")
        if "pixel_err" in r:
            line += f", EMA-sampled pixels max|d| {r['pixel_err']:.2e}"
        parts.append(line)
    b = res["bf16"]
    ms1 = float(np.median(b["one"]["ms"][1:]))
    msn = float(np.median(b["ranks"][0]["ms"][1:]))
    parts.append(
        f"bf16 {BF16_STEPS} steps at global batch {b['one']['batch']} "
        f"finite, the ranks' parameters bitwise equal, d_loss "
        f"{b['ranks'][0]['metrics'][-1]['d_loss']:.4f}; ms per step "
        f"{ms1:.1f} at world size 1, {msn:.1f} at {world}")
    return "; ".join(parts)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="1-vs-N data-parallel dry run "
                                             "of the four trainers.")
    ap.add_argument("world", type=int, help="number of ranks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (rank r on card r modulo the card count) or "
                         "cpu")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--bf16_cfg", default="cfg/coco_objgan.yml",
                    help="the bf16 steps' yml, or 'tiny'")
    args = ap.parse_args(argv)
    print(summary(args.world, run(args.world, args.device, args.backend,
                                  bf16=args.bf16_cfg)), flush=True)


if __name__ == "__main__":
    main()
