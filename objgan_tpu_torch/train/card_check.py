"""One tiny fp32 step's gradients on a device against the CPU's.

``tiny_step_on_card(stage, device)`` builds a trainer of ``stage`` ("gan",
"damsm" or "shape") at ``tiny_test_config`` in fp32 from seeded weights,
batch and noise, takes ``grads`` of a copy on ``device`` (the kernels, on a
card) and of the original on the CPU (the twins), and reports how far the
two lie apart: the largest relative metric error and the largest relative
norm error of a parameter's gradient. ``chip_smoke.py`` and the card tests
both hold the step to it.
"""

from __future__ import annotations

import copy
from typing import Dict

import torch

from objgan_tpu_torch.core.config import tiny_test_config
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
    metric_err = max(_relative(float(got_m[k]), float(v))
                     for k, v in want_m.items())
    grad_err, worst = 0.0, ""
    for k, w in want_g.items():
        e = float((got_g[k].cpu() - w).norm() / w.norm().clamp(min=1e-12))
        if e > grad_err:
            grad_err, worst = e, k
    return {"metric_err": metric_err, "grad_err": grad_err, "worst": worst,
            "metrics": len(want_m), "grads": len(want_g)}
