"""DAMSM pretraining: the text and image encoders trained jointly on the
matching losses. Port of ``objgan_tpu/train/damsm.py``.

Both encoders take Adam (b1 0.5, b2 0.999, eps 1e-8) at
``TRAIN.ENCODER_LR`` on their parameters that require a gradient: all of
them, except the frozen Inception-v3 backbone of ``TEXT.CNN_BACKBONE:
inception``, which gets no Adam state (JAX masks it off with
``optax.masked``) and never moves. Only the text encoder's gradients are
clipped, by their global norm at ``TRAIN.RNN_GRAD_CLIP``, with optax's rule
(``train/common.py::clip_by_global_norm_``); the image encoder's are not.
The text encoder's dropout mask is an argument of the step, drawn by the
caller (``RNNEncoder.keep_mask``). On the card the image encoder's eight
GroupNorms run kernel K1, forward, under autograd.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from objgan_tpu_torch.core.config import Config
from objgan_tpu_torch.core.layers import init_weights
from objgan_tpu_torch.data.wire import from_wire
from objgan_tpu_torch.losses.damsm_loss import damsm_loss
from objgan_tpu_torch.models.damsm import (build_image_encoder,
                                           build_text_encoder)
from objgan_tpu_torch.train.common import Trainer, adam, clip_by_global_norm_


class DamsmTrainer(Trainer):
    """The DAMSM text encoder ``text_enc``, image encoder ``img_enc``, their
    optimisers and the step. ``init_state(generator)`` draws fresh weights
    (on the CPU, then move the trainer); ``core.bridge.load_jax_state``
    loads a JAX state instead. ``multi_train_step(batches, (keep_mask,))``
    takes K steps on stacked inputs (``train/common.py::MultiStep``)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.text_enc = build_text_encoder(cfg)
        self.img_enc = build_image_encoder(cfg)
        self.reset_optimizers()

    def init_state(self, generator: torch.Generator) -> "DamsmTrainer":
        init_weights(self.text_enc, generator)
        init_weights(self.img_enc, generator)
        self.reset_optimizers()
        return self

    def reset_optimizers(self) -> None:
        lr = self.cfg.TRAIN.ENCODER_LR
        self.text_opt = adam(self.text_enc.parameters(), lr)
        self.img_opt = adam([p for p in self.img_enc.parameters()
                             if p.requires_grad], lr)
        self.step = 0

    def optimizers(self):
        return [self.text_opt, self.img_opt]

    def losses(self, batch: Dict, keep_mask: torch.Tensor):
        """(total loss, metrics) of one step: the text encoder with dropout
        by ``keep_mask`` (B, T, GLOVE_DIM), the image encoder on the finest
        images. A wire batch is expanded on the batch's device first."""
        batch = from_wire(self.cfg, batch)
        words, sent = self.text_enc(batch["captions"], batch["cap_lens"],
                                    keep_mask)
        regions, global_f = self.img_enc(batch["images"][-1])
        total, aux = damsm_loss(regions, global_f, words, sent,
                                batch["cap_lens"], batch["class_ids"],
                                self.cfg.TRAIN.SMOOTH)
        return total, dict(aux, damsm_total=total)

    def grads(self, batch: Dict, keep_mask: torch.Tensor
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Every trained parameter's gradient (unclipped) by name, and the
        step's metrics (detached)."""
        total, metrics = self.losses(batch, keep_mask)
        return self.grads_of([(total, self.trained_parameters())], metrics)

    def clip_(self, grads: Dict[str, torch.Tensor]) -> None:
        """The text encoder's gradients only, by their global norm."""
        text = [grads[f"text_enc.{n}"] for n, _ in
                self.text_enc.named_parameters()]
        clip_by_global_norm_(text, self.cfg.TRAIN.RNN_GRAD_CLIP)

    def train_step(self, batch: Dict,
                   keep_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        grads, metrics = self.grads(batch, keep_mask)
        self.apply_grads(grads)
        return metrics

    def step_noise(self, batch: Dict, generator: torch.Generator):
        """(the text encoder's dropout keep mask,)."""
        return (self.text_enc.keep_mask(batch["captions"], generator),)
