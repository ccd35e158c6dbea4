"""What the port's trainers share: Adam as the JAX package sets it up, the
checkpointable trainer state, optax's global-norm clip and the per-step
random streams.

``Trainer.state_dict`` holds, beside ``nn.Module``'s parameters and
buffers, every optimiser's Adam state under ``optim.<parameter
name>.<step | exp_avg | exp_avg_sq>`` and the trainer's ``step``: one flat
dict of tensors, which ``core/checkpoint.py`` saves and restores.

Under data parallelism (``parallel/sharding.py``) ``grads_of`` returns the
rank's own gradients and the metrics averaged over the ranks, and
``apply_grads`` averages the gradients over the ranks before the clip, so
a global-norm clip sees the gradient of the global batch and every rank
takes the same Adam step. The reduction is explicit, not
``DistributedDataParallel``'s: ``torch.autograd.grad`` bypasses its
reducer.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from objgan_tpu_torch.parallel import sharding

_ADAM_KEYS = ("step", "exp_avg", "exp_avg_sq")


def adam(params, lr: float, b1: float = 0.5) -> torch.optim.Adam:
    """optax.adam(lr, b1=b1, b2=0.999) (eps 1e-8); the GAN stages and
    DAMSM take b1 0.5, Stage A optax's default 0.9."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, 0.999), eps=1e-8)


def step_generator(seed: int, step: int, device, stream: int = 0,
                   rank: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step, stream): the
    port's counterpart of ``jax.random.fold_in(PRNGKey(seed), step)``. A
    step's draws depend on its number only, so a resumed run draws what an
    unbroken one would. A draw that differs between the ranks (each rank's
    synthetic batch) adds the rank, as JAX folds in the process index: rank
    0 draws what one process draws."""
    entropy = [seed, step, stream] + ([rank] if rank else [])
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) >> 1)


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: with the global norm n of
    ``grads``, each g stays g if n < max_norm, else becomes
    (g / n) * max_norm. Returns n. (``torch.nn.utils.clip_grad_norm_`` is
    another rule: it scales by max_norm / (n + 1e-6), clamped at 1.)"""
    norms = torch._foreach_norm(grads)
    total = torch.stack(norms).square().sum().sqrt()
    keep = total < max_norm
    one = torch.ones_like(total)
    torch._foreach_div_(grads, torch.where(keep, one, total))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return total


class Trainer(nn.Module):
    """A module that owns Adam optimisers (``optimizers()``) and a step
    count ``step``, checkpointed together by ``state_dict`` and
    ``load_state_dict``."""

    step: int = 0

    def optimizers(self) -> List[torch.optim.Optimizer]:
        raise NotImplementedError

    def trained_parameters(self) -> Dict[str, nn.Parameter]:
        """The parameters that take gradients, by name: all but frozen
        backbones (``requires_grad`` off)."""
        return {n: p for n, p in self.named_parameters() if p.requires_grad}

    @staticmethod
    def grads_of(losses: Sequence[Tuple[torch.Tensor,
                                        Dict[str, nn.Parameter]]],
                 metrics: Dict[str, torch.Tensor]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Each (loss, {name: parameter}) pair's gradients by name (zeros
        where the loss does not reach a parameter; this rank's), and
        ``metrics`` detached and averaged over the ranks."""
        grads = {}
        for loss, params in losses:
            got = torch.autograd.grad(loss, list(params.values()),
                                      allow_unused=True)
            for (name, p), g in zip(params.items(), got):
                grads[name] = torch.zeros_like(p) if g is None else g
        return grads, sharding.all_reduce_metrics(
            {k: v.detach() for k, v in metrics.items()})

    def clip_(self, grads: Dict[str, torch.Tensor]) -> None:
        """Clips ``grads`` in place before ``apply_grads``' Adam steps;
        none by default."""

    @torch.no_grad()
    def apply_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """The average of ``grads`` (by parameter name) over the ranks,
        ``clip_``, then one Adam step of every optimiser."""
        sharding.all_reduce_grads_(grads)
        self.clip_(grads)
        for name, p in self.named_parameters():
            if name in grads:
                p.grad = grads[name]
        for opt in self.optimizers():
            opt.step()
            opt.zero_grad(set_to_none=True)
        self.step += 1

    def _adam_entries(self) -> Iterator[Tuple[str, torch.optim.Optimizer,
                                              nn.Parameter]]:
        names = {p: n for n, p in self.named_parameters()}
        for opt in self.optimizers():
            for group in opt.param_groups:
                for p in group["params"]:
                    yield f"optim.{names[p]}.", opt, p

    def state_dict(self, *args, **kwargs) -> Dict[str, torch.Tensor]:
        """nn.Module's keys, the Adam state (zeros at step 0 before a
        parameter's first update, as Adam would create it) and ``step``."""
        sd = super().state_dict(*args, **kwargs)
        prefix = kwargs.get("prefix", "")
        for key, opt, p in self._adam_entries():
            state = opt.state.get(p) or {
                "step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}
            for k in _ADAM_KEYS:
                sd[prefix + key + k] = state[k].detach()
        sd[prefix + "step"] = torch.tensor(self.step, dtype=torch.int64)
        return sd

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """Copies every tensor of ``state_dict`` (on any device) into this
        trainer on its own device; Adam's step counts stay fp32 on the CPU,
        where Adam keeps them."""
        sd = dict(state_dict)
        step = sd.pop("step")
        adam_state = {k: sd.pop(k) for k in list(sd) if k.startswith(
            "optim.")}
        result = super().load_state_dict(sd, strict=strict, assign=assign)
        for key, opt, p in self._adam_entries():
            opt.state[p] = {
                "step": adam_state[key + "step"].to("cpu", torch.float32,
                                                    copy=True),
                **{k: adam_state[key + k].to(p.device, p.dtype, copy=True)
                   for k in _ADAM_KEYS[1:]}}
        self.step = int(step)
        return result
