"""One tiny fp32 step's gradients on a device against the CPU's.

``tiny_step_on_card(stage, device)`` builds a trainer of ``stage`` ("gan",
"damsm" or "shape") at ``tiny_test_config`` in fp32 from seeded weights,
batch and noise, takes ``grads`` of a copy on ``device`` (the kernels, on a
card) and of the original on the CPU (the twins), and reports how far the
two lie apart: the largest relative metric error and the largest relative
norm error of a parameter's gradient. The card tests hold each stage's
step to it.

``restored(stage, output_dir, goldens, device)`` restores the tiny fp32
trainer of ``stage`` ("gan", "damsm", "box" or "shape") from the JAX
package's Orbax step under ``output_dir/objgan_<stage>/ckpt``
(``tests/make_orbax_fixtures.py`` writes it) through
``CheckpointManager.restore_latest``, with the batch of the stage's seed
and JAX's noise from ``goldens`` (``tests/data/orbax_goldens.npz``).
``restored_step`` takes one train step there and ``golden_errors``
measures it against JAX's; ``restored_grads_on_card`` holds a ``grads``
call on the card to the CPU's, as ``tiny_step_on_card`` does.

``graph_against_eager(stage, cfg, k, device)`` holds K train steps as one
CUDA-graph replay (``MultiStep``, ``TRAIN.STEPS_PER_EXECUTION``) to K
eager single steps from the same state, batches and noise, as
``chip_smoke.py`` (full width) and the card tests (tiny) do;
``deterministic_agreement(cfgs, k)`` does so for each stage in a
process under ``torch.use_deterministic_algorithms``, where the replay
must equal the eager steps to the bit.
"""

from __future__ import annotations

import copy
import hashlib
import zlib
from typing import Dict, Mapping

import numpy as np
import torch

from objgan_tpu_torch.core.config import Config, tiny_test_config
from objgan_tpu_torch.data.synthetic import synthetic_batch

METRIC_RTOL = 1e-4   # each metric, relative
GRAD_RTOL = 1e-3     # each parameter's gradient, relative in norm


def _inputs(stage: str, cfg):
    """(trainer on the CPU, grads' positional arguments) from seeds."""
    init = torch.Generator().manual_seed(0)
    gen = torch.Generator().manual_seed(1)
    if stage == "gan":
        from objgan_tpu_torch.train.gan import GanTrainer, train_noise

        batch = synthetic_batch(cfg, gen)
        noise = train_noise(cfg, cfg.TRAIN.BATCH_SIZE,
                            torch.Generator().manual_seed(2), "cpu")
        return (GanTrainer(cfg).init_state(init),
                (batch, noise["z"], noise["ca_eps"]))
    if stage == "damsm":
        from objgan_tpu_torch.train.damsm import DamsmTrainer

        trainer = DamsmTrainer(cfg).init_state(init)
        batch = synthetic_batch(cfg, gen)
        keep = trainer.text_enc.keep_mask(batch["captions"],
                                          torch.Generator().manual_seed(2))
        return trainer, (batch, keep)
    if stage == "shape":
        from objgan_tpu_torch.train.shape import ShapeTrainer, shape_noise

        batch = synthetic_batch(cfg, gen, with_images=False)
        z = shape_noise(cfg, cfg.TRAIN.BATCH_SIZE, gen, "cpu")
        return ShapeTrainer(cfg).init_state(init), (batch, z)
    raise ValueError(f"no tiny step for stage {stage!r}")


def _to(x, device):
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [_to(v, device) for v in x]
    return x.to(device)


def _relative(got: float, want: float) -> float:
    if got == want:
        return 0.0
    return abs(got - want) / abs(want) if want else float("inf")


def tiny_step_on_card(stage: str, device="cuda") -> Dict[str, object]:
    """The errors of one tiny fp32 ``grads`` call of ``stage`` on
    ``device`` against the same call on the CPU: ``metric_err`` (relative,
    the largest over metrics), ``grad_err`` and ``worst`` (relative in
    norm, the largest over parameters, and its name), ``metrics`` and
    ``grads`` (how many were compared)."""
    cfg = tiny_test_config().merged({"DTYPE": "float32"})
    cpu, args = _inputs(stage, cfg)
    card = copy.deepcopy(cpu).to(device)
    want_g, want_m = cpu.grads(*args)
    got_g, got_m = card.grads(*[_to(a, device) for a in args])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return _errors(want_g, want_m, got_g, got_m)


def _errors(want_g, want_m, got_g, got_m) -> Dict[str, object]:
    metric_err = max(_relative(float(got_m[k]), float(v))
                     for k, v in want_m.items())
    grad_err, worst = 0.0, ""
    for k, w in want_g.items():
        e = float((got_g[k].cpu() - w).norm() / w.norm().clamp(min=1e-12))
        if e > grad_err:
            grad_err, worst = e, k
    return {"metric_err": metric_err, "grad_err": grad_err, "worst": worst,
            "metrics": len(want_m), "grads": len(want_g)}


# the synthetic batch of each stage's restored step (torch's CPU generator)
ORBAX_SEEDS = {"gan": 11, "damsm": 12, "box": 13, "shape": 14}
GOLDEN_HEAD = 4  # leading values of each state tensor the goldens keep
GOLDEN_PROJECTIONS = 4  # seeded normal vectors each tensor is projected on
# a state tensor after a restored step against JAX's: within STATE_ATOL
# element by element, as the Stage A/B tests hold two steps, or within
# STATE_RTOL of its stage relative in norm. Stage C: its gradients are
# held to 1e-3 relative in norm (tests/test_torch_train.py) and Adam's
# second moment squares them (its G moments reach ~700 on the tiled
# fixture, where no 1e-5 holds)
STATE_ATOL = 1e-5
STATE_RTOL = {"gan": 2e-3, "damsm": 1e-4, "box": 1e-4, "shape": 1e-4}
# deterministic_agreement's process: the four full-width trainers at K = 4
# take minutes
AGREEMENT_TIMEOUT_S = 600.0


def batch_digest(batch: Mapping) -> str:
    """sha256 of a batch's arrays in key order."""
    h = hashlib.sha256()
    for k in sorted(batch):
        for x in batch[k] if isinstance(batch[k], list) else [batch[k]]:
            h.update(k.encode())
            h.update(np.ascontiguousarray(x.cpu().numpy()).tobytes())
    return h.hexdigest()


def projection_vectors(key: str, n: int) -> np.ndarray:
    """The GOLDEN_PROJECTIONS seeded normal vectors of length ``n`` the
    goldens project the state tensor ``key`` on."""
    return np.random.default_rng(zlib.crc32(key.encode())).standard_normal(
        (GOLDEN_PROJECTIONS, n))


def state_summary(sd: Mapping[str, torch.Tensor]):
    """(keys, first GOLDEN_HEAD values, L2 norms, projections) of the float
    entries of a trainer's state dict, Adam's step counts left out."""
    keys = sorted(k for k, v in sd.items()
                  if v.is_floating_point() and not k.endswith(".step"))
    head = np.full((len(keys), GOLDEN_HEAD), np.nan, np.float32)
    norm = np.zeros(len(keys))
    proj = np.zeros((len(keys), GOLDEN_PROJECTIONS))
    for i, k in enumerate(keys):
        x = sd[k].detach().cpu().double().reshape(-1).numpy()
        head[i, :min(GOLDEN_HEAD, x.size)] = x[:GOLDEN_HEAD]
        norm[i] = np.linalg.norm(x)
        proj[i] = projection_vectors(k, x.size) @ x
    return np.array(keys), head, norm, proj


def _orbax_trainer(stage: str, cfg):
    from objgan_tpu_torch.train.box import BoxTrainer
    from objgan_tpu_torch.train.damsm import DamsmTrainer
    from objgan_tpu_torch.train.gan import GanTrainer
    from objgan_tpu_torch.train.shape import ShapeTrainer

    return {"gan": GanTrainer, "damsm": DamsmTrainer, "box": BoxTrainer,
            "shape": ShapeTrainer}[stage](cfg)


def restored(stage: str, output_dir: str, goldens: Mapping, device="cpu"):
    """(trainer, step arguments, restored step): the tiny fp32 ``stage``
    trainer restored from its Orbax step on ``device``, and the batch of
    the stage's seed with JAX's noise there, as ``train_step`` and
    ``grads`` take them. Raises when the stage's seed draws another batch
    than the goldens were made on."""
    import os

    from objgan_tpu_torch.core.checkpoint import CheckpointManager

    cfg = tiny_test_config().merged({"DTYPE": "float32"})
    # on the device first: the restore puts the Adam moments beside their
    # parameters, and moving the trainer later would leave them behind
    trainer = _orbax_trainer(stage, cfg).to(device)
    ckpt = os.path.join(output_dir, f"{cfg.CONFIG_NAME}_{stage}", "ckpt")
    step = CheckpointManager(ckpt).restore_latest(trainer)
    if step is None:
        raise RuntimeError(f"no {stage} step restored from {ckpt}")
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(
        ORBAX_SEEDS[stage]), with_images=stage in ("gan", "damsm"))
    if batch_digest(batch) != str(goldens[f"{stage}.batch_sha256"]):
        raise RuntimeError(f"the {stage} seed drew another batch than the "
                           "goldens were made on (torch's CPU generator "
                           "changed?)")
    noise = {k.rsplit(".", 1)[-1]: torch.from_numpy(np.array(goldens[k]))
             for k in goldens if k.startswith(f"{stage}.noise.")}
    batch, noise = _to(batch, device), _to(noise, device)
    args = {"gan": lambda: (batch, noise["z"], noise["ca_eps"]),
            "shape": lambda: (batch, noise["z"]),
            "damsm": lambda: (batch, noise["keep_mask"]),
            "box": lambda: (batch,)}[stage]()
    return trainer, args, step


def restored_step(stage: str, output_dir: str, goldens: Mapping,
                  device="cpu"):
    """(trainer after the step, its metrics as floats, the restored step):
    ``restored``'s trainer after one train step."""
    trainer, args, step = restored(stage, output_dir, goldens, device)
    metrics = trainer.train_step(*args)
    return trainer, {k: float(v) for k, v in metrics.items()}, step


def restored_grads_on_card(stage: str, output_dir: str, goldens: Mapping,
                           device="cuda") -> Dict[str, object]:
    """``tiny_step_on_card``'s errors, on the restored state: one ``grads``
    call of ``restored``'s trainer on ``device`` against the CPU's."""
    card, args, _ = restored(stage, output_dir, goldens, device)
    cpu, cpu_args, _ = restored(stage, output_dir, goldens, "cpu")
    want_g, want_m = cpu.grads(*cpu_args)
    got_g, got_m = card.grads(*args)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return _errors(want_g, want_m, got_g, got_m)


def golden_errors(stage: str, trainer, metrics: Mapping[str, float],
                  goldens: Mapping) -> Dict[str, object]:
    """How far a step of ``restored_step`` lies from JAX's, read from the
    goldens (the card's host has no JAX to take the step). ``metric_err``:
    the largest relative metric error. ``state_score``: the largest, over
    the float state tensors after the step, of the estimated L2 norm of its
    error over its limit, max(STATE_ATOL, STATE_RTOL · ||JAX's tensor||).
    The estimate is the largest of the norms' difference and the leading
    values' error norm (each at most the error's norm) and the root mean
    square of the errors of the GOLDEN_PROJECTIONS projections, whose
    square has the error's squared norm as its expectation. No element
    errs by more than the norm, so a score of at most 1 says each tensor
    lies within STATE_ATOL of JAX's element by element or within its
    stage's STATE_RTOL in norm, up to the estimate's spread.
    ``worst`` names its tensor; ``step_ok`` says the step equals JAX's."""
    want_m = {k.split(".", 2)[2]: float(goldens[k]) for k in goldens
              if k.startswith(f"{stage}.metric.")}
    metric_err = max(_relative(metrics[k], w) for k, w in want_m.items())
    keys, head, norm, proj = state_summary(trainer.state_dict())
    if list(keys) != list(goldens[f"{stage}.keys"]):
        raise RuntimeError(f"{stage}: state entries differ from the goldens'")
    score, worst = 0.0, ""
    for i, k in enumerate(keys):
        dh = head[i] - goldens[f"{stage}.head"][i]
        dp = proj[i] - goldens[f"{stage}.projection"][i]
        want_norm = float(goldens[f"{stage}.norm"][i])
        err = max(float(np.linalg.norm(dh[~np.isnan(dh)])),
                  float(np.sqrt(np.mean(dp * dp))), abs(norm[i] - want_norm))
        e = err / max(STATE_ATOL, STATE_RTOL[stage] * want_norm)
        if e > score:
            score, worst = e, k
    return {"metric_err": metric_err, "state_score": score, "worst": worst,
            "metrics": len(want_m), "tensors": len(keys),
            "step_ok": trainer.step == int(goldens[f"{stage}.step"])}


# -- K steps per execution: the graph against eager steps ------------------------

_TRAINERS_WITH_IMAGES = ("gan", "damsm")


def stacked_inputs(stage: str, cfg, trainer, start: int, k: int, device,
                   seed: int = 0):
    """(batches, noises) of K steps from ``start`` on ``device``: synthetic
    batches of ``stage`` drawn from (``seed``, step) stacked on a leading
    axis, and each step's noise from (RNG_SEED, step), as the K-step loop
    stacks them."""
    from objgan_tpu_torch import cli
    from objgan_tpu_torch.train.common import step_generator

    batches = [synthetic_batch(cfg, step_generator(seed, start + i, device, 1),
                               with_images=stage in _TRAINERS_WITH_IMAGES)
               for i in range(k)]
    noises = cli.stack_noise([cli.step_noise(cfg, trainer, b, start + i,
                                             device)
                              for i, b in enumerate(batches)])
    return cli.stack_batches(batches), noises


def fresh(stage: str, cfg, device):
    """A trainer of ``stage`` with the weights of ``cfg.RNG_SEED`` on
    ``device``, as the entry points make it."""
    from objgan_tpu_torch import cli

    if stage == "gan":
        return cli.make_trainer(cfg, device)
    return cli.fresh_trainer(cfg, _orbax_trainer(stage, cfg), device)


def state_errors(stage: str, got: Mapping[str, torch.Tensor],
                 want: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """How far two state dicts lie apart: ``bitwise`` equal or not, the
    largest element error ``max_abs`` and relative-in-norm error ``rel``
    (each over all float tensors), and ``misfits``, the tensors outside
    both STATE_ATOL element by element and the stage's STATE_RTOL in
    norm."""
    bitwise, max_abs, rel, misfits = True, 0.0, 0.0, []
    for k, w in want.items():
        g = got[k].detach()
        bitwise = bitwise and torch.equal(g.cpu(), w.detach().cpu())
        if not w.is_floating_point() or not w.numel():
            continue
        d = g.double().cpu() - w.double().cpu()
        a = float(d.abs().max())
        r = float(d.norm()) / max(float(w.double().norm()), 1e-30)
        max_abs, rel = max(max_abs, a), max(rel, r)
        if a > STATE_ATOL and r > STATE_RTOL[stage]:
            misfits.append(k)
    return {"bitwise": bitwise, "max_abs": max_abs, "rel": rel,
            "misfits": misfits}


def graph_against_eager(stage: str, cfg, k: int = 4, device="cuda"):
    """K train steps of ``stage`` at ``cfg`` as one CUDA-graph replay
    against K eager single steps from the same state, batches and noise.

    Trainer ``graph`` takes its first execution (the eager warm-up that
    makes Adam capturable), then a second, which it captures and replays.
    Copies of it after the first (without its executor) take the second's
    K steps one by one: ``eager`` and ``eager2`` with the same capturable Adam (two, to
    show eager's own spread), ``k1`` with Adam as K = 1 runs it. Returns
    the trainers, the second execution's inputs, the kernels' launches
    while it was captured (``ops.*.launches``: one per kernel node a
    wrapper recorded), ``state_errors`` of ``graph`` against ``eager``
    (``eager_err``), of ``eager2`` against ``eager`` (``spread``) and of
    ``graph`` against ``k1`` (``k1_err``), and the metric means' largest
    relative error (``metric_err``). Under
    ``torch.use_deterministic_algorithms`` (with
    ``CUBLAS_WORKSPACE_CONFIG`` set before the process first used cuBLAS)
    eager steps are reproducible, and the replay equals them to the
    bit."""
    from objgan_tpu_torch.ops import groupnorm, roi_align
    from objgan_tpu_torch.train.common import index_stack, set_capturable

    graph = fresh(stage, cfg, device)
    graph.multi_train_step(*stacked_inputs(stage, cfg, graph, graph.step, k,
                                           device))
    copies = {name: copy.deepcopy(graph) for name in ("eager", "eager2",
                                                      "k1")}
    for opt in copies["k1"].optimizers():
        set_capturable(opt, False)
    inputs = stacked_inputs(stage, cfg, graph, graph.step, k, device)
    before = (groupnorm.launches, dict(roi_align.launches),
              groupnorm.bwd_launches)
    got_m = graph.multi_train_step(*inputs)
    captured = {"K1": groupnorm.launches - before[0],
                "K1 backward": groupnorm.bwd_launches - before[2],
                "K2": roi_align.launches["fwd"] - before[1]["fwd"],
                "K3": roi_align.launches["bwd"] - before[1]["bwd"]}
    rows = {name: [t.train_step(index_stack(inputs[0], i),
                                *index_stack(inputs[1], i))
                   for i in range(k)] for name, t in copies.items()}
    torch.cuda.synchronize(device)
    metric_err = max(_relative(float(got_m[name]), float(torch.stack(
        [r[name].float() for r in rows["eager"]]).mean(0)))
        for name in got_m)
    got, want = graph.state_dict(), copies["eager"].state_dict()
    return {"graph": graph, **copies, "inputs": inputs,
            "captured": captured, "metric_err": metric_err,
            "eager_err": state_errors(stage, got, want),
            "spread": state_errors(stage, copies["eager2"].state_dict(),
                                   want),
            "k1_err": state_errors(stage, got, copies["k1"].state_dict())}


def agreement(result) -> Dict[str, object]:
    """The numbers of a ``graph_against_eager`` result, without its
    tensors (for JSON)."""
    out = {"metric_err": result["metric_err"],
           "captured": result["captured"]}
    for key in ("eager_err", "spread", "k1_err"):
        e = result[key]
        out[key] = {"bitwise": e["bitwise"], "max_abs": e["max_abs"],
                    "rel": e["rel"], "misfits": len(e["misfits"])}
    return out


def deterministic_agreement(cfgs: Mapping[str, Config],
                            k: int) -> Dict[str, Dict[str, object]]:
    """``agreement`` of ``graph_against_eager`` at K = ``k`` for each stage
    of ``cfgs`` at its config, in a process of its own under
    ``torch.use_deterministic_algorithms`` with cuBLAS's workspace fixed
    (``CUBLAS_WORKSPACE_CONFIG``) before its first use: there two eager
    runs agree to the bit, and the replay must equal them. Returns
    {stage: agreement}; raises when the process fails or outlasts
    AGREEMENT_TIMEOUT_S."""
    import dataclasses
    import json
    import os
    import subprocess
    import sys

    raw = {stage: dataclasses.asdict(cfg) for stage, cfg in cfgs.items()}
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=root + (os.pathsep + path if path else ""))
    proc = subprocess.run(
        [sys.executable, "-c", "from objgan_tpu_torch.train import "
         "card_check; card_check._agree_here()", json.dumps(raw), str(k)],
        cwd=root, env=env, capture_output=True, text=True,
        timeout=AGREEMENT_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"deterministic agreement failed (rc "
                           f"{proc.returncode}):\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _agree_here() -> None:
    """``deterministic_agreement``'s process: reads the configs (as
    ``dataclasses.asdict`` gave them) and K from its arguments, prints one
    JSON line."""
    import json
    import sys

    from objgan_tpu_torch.core.precision import true_fp32

    true_fp32()
    torch.use_deterministic_algorithms(True)
    out = {}
    for stage, raw in json.loads(sys.argv[1]).items():
        out[stage] = agreement(graph_against_eager(
            stage, Config().merged(raw), int(sys.argv[2])))
    print(json.dumps(out))
