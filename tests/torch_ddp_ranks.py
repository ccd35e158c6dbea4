"""What the ranks of ``tests/test_torch_parallel.py`` and
``tests/test_torch_ddp.py`` run (``parallel.dryrun.spawn`` pickles these
functions by their module path). Spawned ranks import this module, which
imports torch and the port only: no JAX, no conftest."""

from typing import Dict

import torch

from objgan_tpu_torch import cli
from objgan_tpu_torch.losses import damsm_loss as tdl
from objgan_tpu_torch.losses import gan_loss as tgl
from objgan_tpu_torch.parallel import dryrun, sharding
from objgan_tpu_torch.train.damsm import DamsmTrainer
from objgan_tpu_torch.train.gan import GanTrainer


def _rows(x: torch.Tensor) -> torch.Tensor:
    return sharding.local_rows(x).clone()


def _leaf(x: torch.Tensor) -> torch.Tensor:
    return _rows(x).requires_grad_(True)


def losses_on_ranks(device, inputs: Dict[str, torch.Tensor], smooth):
    """This rank's share of ``_masked_mean``, ``roll_sent`` and
    ``damsm_loss`` on its rows of the global ``inputs``, with its gradient
    with respect to those rows, and the local-only losses that a rank
    would compute without the collectives."""
    x, mask = _leaf(inputs["x"]), _rows(inputs["mask"])
    share = tgl._masked_mean(x, mask)
    (dx,) = torch.autograd.grad(share, x)
    local = (x * mask).sum() / mask.sum().clamp(min=1.0)
    feats = [_leaf(inputs[k]) for k in ("regions", "global", "words",
                                        "sent")]
    lens, ids = _rows(inputs["lens"]), _rows(inputs["ids"])
    total, parts = tdl.damsm_loss(*feats, lens, ids, smooth)
    grads = torch.autograd.grad(total, feats)
    with torch.no_grad():  # the local batch's matching only
        regions, glob, words, sent = feats
        w0, w1, _ = tdl.words_loss(regions, words, lens, ids, smooth.GAMMA1,
                                   smooth.GAMMA2, smooth.GAMMA3)
        s0, s1 = tdl.sent_loss(glob, sent, ids, smooth.GAMMA3)
        local_damsm = w0 + w1 + s0 + s1
    return {"masked": share.detach(), "masked_grad": dx,
            "masked_local": local.detach(),
            "roll": tgl.roll_sent(_rows(inputs["sent"])),
            "damsm": total.detach(),
            "damsm_parts": {k: v.detach() for k, v in parts.items()},
            "damsm_grads": list(grads), "damsm_local": local_damsm}


def multi_stages(device, world: int):
    """Each trainer's ``dryrun.K_STEPS`` tiny steps as one
    ``multi_train_step`` (``TRAIN.STEPS_PER_EXECUTION``) on the dry run's
    global batches of 2 rows per rank of ``world``: this rank's rows
    stacked, each step's noise from (RNG_SEED, step). The K-meaned metrics
    and the state after it (CPU)."""
    cfg = dryrun.tiny_cfg(2 * world)
    batches = [dryrun.local_part(dryrun.numpy_batch(
        cfg, cfg.TRAIN.BATCH_SIZE, 100 + k)) for k in range(dryrun.K_STEPS)]
    out = {}
    for stage, cls in dryrun.STAGES.items():
        trainer = cli.fresh_trainer(cfg, cls(cfg), device)
        sharding.broadcast_module_(trainer)
        noises = cli.stack_noise([cli.step_noise(cfg, trainer, b, k, device)
                                  for k, b in enumerate(batches)])
        metrics = trainer.multi_train_step(
            cli.to_device(cli.stack_batches(batches), device), noises)
        out[stage] = {"metrics": {k: float(v) for k, v in metrics.items()},
                      "state": {k: v.detach().cpu().clone() for k, v in
                                trainer.state_dict().items()}}
    return out


def trainers_on_ranks(device, jax_inputs):
    """The four trainers' tiny dry run (``parallel.dryrun.tiny_stages``),
    the same steps as one K-step execution each (``multi_stages``), and
    the Stage-C and DAMSM steps of the JAX package's state, batch and
    noise: this rank's rows, gradients averaged over the ranks, metrics
    averaged."""
    out = {"stages": dryrun.tiny_stages(device, 2),
           "multi": multi_stages(device, 2)}
    cfg = jax_inputs["cfg"]

    def port_batch(batch):
        return {k: ([_rows(v) for v in x] if isinstance(x, list)
                    else _rows(x)) for k, x in batch.items()}

    gan = jax_inputs["gan"]
    trainer = GanTrainer(cfg)
    trainer.load_state_dict(gan["state"])
    grads, metrics = trainer.grads(port_batch(gan["batch"]),
                                   *map(_rows, gan["noise"]))
    sharding.all_reduce_grads_(grads)
    out["gan"] = {"grads": grads, "metrics": metrics}

    damsm = jax_inputs["damsm"]
    trainer = DamsmTrainer(cfg)
    trainer.load_state_dict(damsm["state"])
    grads, metrics = trainer.grads(port_batch(damsm["batch"]),
                                   _rows(damsm["mask"]))
    sharding.all_reduce_grads_(grads)
    out["damsm"] = {"grads": grads, "metrics": metrics}
    return out
