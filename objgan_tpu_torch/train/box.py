"""Stage A: caption -> layout. Port of ``objgan_tpu/train/box.py``.

``BoxTrainer`` trains the box generator by teacher-forced maximum
likelihood (``models/box_generator.py::box_loss``): the gradients clipped
by their global norm at ``BOX.GRAD_CLIP`` (optax's rule,
``train/common.py::clip_by_global_norm_``), then Adam at
``BOX.LEARNING_RATE`` (optax's default b1 0.9, b2 0.999). Scheduled
sampling's per-step flips are an argument of the step, drawn by the caller
(``ss_flips``). ``sample`` (temperature sampling, its noise from
``box_noise``) and ``beam_sample`` decode with the trained model; the
module-level ``sample`` is what the composed pipeline calls.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from objgan_tpu_torch.core.config import Config
from objgan_tpu_torch.core.layers import init_weights
from objgan_tpu_torch.models.box_generator import BoxGenerator, box_loss
from objgan_tpu_torch.parallel.sharding import global_batch, local_rows
from objgan_tpu_torch.train.common import Trainer, adam, clip_by_global_norm_


def box_noise(cfg: Config, batch: int, generator: torch.Generator,
              device) -> Dict[str, torch.Tensor]:
    """The draws of one temperature-sampled decode, per step s:
    ``label_gumbel[s]`` (B, NUM_CLASSES), ``comp_gumbel[s]``
    (B, GMM_COMPONENTS) and ``box_normal[s]`` (B, 4)."""
    t = cfg.BOX.MAX_SEQ_LENGTH
    tiny = torch.finfo(torch.float32).tiny

    def gumbel(*shape):
        u = torch.rand(shape, generator=generator, device=device)
        return -torch.log(-torch.log(torch.clamp(u, min=tiny)))

    return {
        "label_gumbel": gumbel(t, batch, cfg.OBJ.NUM_CLASSES),
        "comp_gumbel": gumbel(t, batch, cfg.OBJ.GMM_COMPONENTS),
        "box_normal": torch.randn((t, batch, 4), generator=generator,
                                  device=device),
    }


def ss_flips(cfg: Config, objects: int, batch: int,
             generator: torch.Generator, device) -> Optional[torch.Tensor]:
    """Scheduled sampling's flips (O + 1, B), each set with probability
    ``BOX.SCHEDULED_SAMPLING_PROB``; None when it is 0. Under data
    parallelism drawn for the global batch, ``batch`` this rank's
    columns."""
    p = cfg.BOX.SCHEDULED_SAMPLING_PROB
    if p <= 0.0:
        return None
    return local_rows(torch.rand((objects + 1, global_batch(batch)),
                                 generator=generator, device=device) < p,
                      dim=1)


def sample(model: BoxGenerator, captions: torch.Tensor,
           cap_lens: torch.Tensor,
           noise: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Temperature-sampled layout; ``noise`` as ``box_noise`` draws it."""
    return model.sample(captions, cap_lens, noise["label_gumbel"],
                        noise["comp_gumbel"], noise["box_normal"])


class BoxTrainer(Trainer):
    """The box generator ``model``, its optimiser and the step.
    ``init_state(generator)`` draws fresh weights (on the CPU, then move
    the trainer); ``core.bridge.load_jax_state`` loads a JAX state.
    ``multi_train_step(batches, (flips,))`` takes K steps on stacked
    inputs (``train/common.py::MultiStep``; flips None without scheduled
    sampling)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.model = BoxGenerator(cfg)
        self.reset_optimizers()

    def init_state(self, generator: torch.Generator) -> "BoxTrainer":
        init_weights(self.model, generator)
        self.reset_optimizers()
        return self

    def reset_optimizers(self) -> None:
        self.opt = adam(self.model.parameters(), self.cfg.BOX.LEARNING_RATE,
                        b1=0.9)
        self.step = 0

    def optimizers(self):
        return [self.opt]

    def loss(self, batch: Dict, flips: Optional[torch.Tensor] = None):
        """(total, metrics) of the teacher-forced pass on ``batch``."""
        # a layout-only wire batch (--wire) carries neither image_u8 nor
        # shapes_u8: it is read as it comes, with no from_wire
        c = self.cfg
        out = self.model.teacher_forced(batch["captions"], batch["cap_lens"],
                                        batch["labels"], batch["boxes"],
                                        flips)
        total, aux = box_loss(out, batch["labels"], batch["boxes"],
                              batch["obj_valid"], c.OBJ.GMM_COMPONENTS,
                              gmm_mode=c.OBJ.GMM_MODE)
        return total, dict(aux, box_total=total)

    def grads(self, batch: Dict, flips: Optional[torch.Tensor] = None):
        """Every parameter's gradient (unclipped) by name, and the step's
        metrics (detached)."""
        total, metrics = self.loss(batch, flips)
        return self.grads_of([(total, dict(self.named_parameters()))],
                             metrics)

    def clip_(self, grads: Dict[str, torch.Tensor]) -> None:
        """Every gradient, by the global norm."""
        clip_by_global_norm_([grads[n] for n, _ in self.named_parameters()],
                             self.cfg.BOX.GRAD_CLIP)

    def train_step(self, batch: Dict, flips: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        grads, metrics = self.grads(batch, flips)
        self.apply_grads(grads)
        return metrics

    def step_noise(self, batch: Dict, generator: torch.Generator):
        """(scheduled sampling's flips, or None,)."""
        b, o = batch["labels"].shape
        return (ss_flips(self.cfg, o, b, generator, generator.device),)

    @torch.no_grad()
    def sample(self, captions: torch.Tensor, cap_lens: torch.Tensor,
               noise: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return sample(self.model, captions, cap_lens, noise)

    @torch.no_grad()
    def beam_sample(self, captions: torch.Tensor, cap_lens: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        return self.model.beam_sample(captions, cap_lens,
                                      self.cfg.BOX.BEAM_SIZE)
