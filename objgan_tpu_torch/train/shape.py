"""Stage B: boxes -> masks. Port of ``objgan_tpu/train/shape.py``.

``ShapeTrainer`` trains the shape generator ``g`` against the shape
discriminator ``d`` in one backward of ``d_loss + g_loss``, with the JAX
package's stop-gradients: D's loss sees the fake masks detached, G's loss
runs through D with D's parameters detached (``torch.func.functional_call``
on detached copies), and the real features it matches are detached. So
every gradient comes from the same iterate. Adam (b1 0.5, b2 0.999) at
``SHAPE.LEARNING_RATE`` updates G and D. The perceptual term is D feature
matching (``SHAPE.PERCEPTUAL: fm``), or with ``vgg`` the L1 distance of
frozen VGG-16 features (``models/vgg.py``, up to ``relu4_3``) of the fake
and the real masks, weighted by ``LAMBDA_PERCEPTUAL``, in place of feature
matching. VGG takes no Adam state and never moves; its weights are random
(with a warning) unless ``SHAPE.VGG_WEIGHTS`` names a torchvision
``vgg16`` state dict. The noise ``z``
(B, O, 1, 1, SHAPE.GF_DIM) is an argument of the step (``shape_noise``).
On the card, G's 5 and D's 2 GroupNorms per application run kernel K1
under autograd: 11 forward calls a step.

``ShapeState`` (``g`` and this stage's own ``label_table``) is what the
composed pipeline holds; ``sample`` turns a layout into masks.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
from torch.func import functional_call

from objgan_tpu_torch.core.config import Config
from objgan_tpu_torch.core.layers import init_weights
from objgan_tpu_torch.data.wire import from_wire
from objgan_tpu_torch.losses.gan_loss import shape_d_loss, shape_g_loss
from objgan_tpu_torch.models.shape_generator import (ShapeDiscriminator,
                                                     ShapeGenerator)
from objgan_tpu_torch.models.vgg import (VGG16, load_torchvision_vgg16,
                                         vgg_perceptual_loss)
from objgan_tpu_torch.parallel.sharding import (global_batch, local_rows,
                                                masked_mean_share)
from objgan_tpu_torch.train.common import Trainer, adam


class ShapeState(nn.Module):
    """The shape generator ``g`` and this stage's own ``label_table``
    buffer (at a class count other than COCO's 81 it differs from the
    Stage-C table)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.g = ShapeGenerator(cfg)
        self.register_buffer("label_table", torch.zeros(
            cfg.OBJ.NUM_CLASSES, cfg.OBJ.LABEL_DIM))


def shape_noise(cfg: Config, batch: int, generator: torch.Generator,
                device) -> torch.Tensor:
    """G's noise z (B, O, 1, 1, SHAPE.GF_DIM), standard normal fp32; under
    data parallelism drawn for the global batch, ``batch`` this rank's
    rows."""
    return local_rows(torch.randn(
        (global_batch(batch), cfg.OBJ.MAX_OBJECTS, 1, 1, cfg.SHAPE.GF_DIM),
        generator=generator, device=device))


def sample(state, boxes: torch.Tensor, labels: torch.Tensor,
           obj_valid: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """boxes (B, O, 4), labels (B, O), obj_valid (B, O), noise z
    (B, O, 1, 1, SHAPE.GF_DIM) -> masks (B, O, S, S) in [0, 1]. ``state``
    has ``g`` and ``label_table``."""
    labels_emb = state.label_table[labels.long()]
    return torch.sigmoid(state.g(boxes, labels_emb, obj_valid, z))


class ShapeTrainer(Trainer):
    """G, D, the frozen label table, their optimisers and the step.
    ``init_state(generator)`` draws fresh weights (on the CPU, then move
    the trainer); ``core.bridge.load_jax_state`` loads a JAX state.
    ``multi_train_step(batches, (z,))`` takes K steps on stacked inputs
    (``train/common.py::MultiStep``)."""

    def __init__(self, cfg: Config):
        super().__init__()
        if cfg.SHAPE.PERCEPTUAL not in ("fm", "vgg"):
            raise ValueError(f"SHAPE.PERCEPTUAL must be 'fm' or 'vgg', got "
                             f"{cfg.SHAPE.PERCEPTUAL!r}")
        self.cfg = cfg
        self.g = ShapeGenerator(cfg)
        self.d = ShapeDiscriminator(cfg)
        self.vgg = None
        if cfg.SHAPE.PERCEPTUAL == "vgg":
            self.vgg = VGG16(stop_at="relu4_3")  # the last perceptual tap
            self.vgg.requires_grad_(False)
        self.register_buffer("label_table", torch.zeros(
            cfg.OBJ.NUM_CLASSES, cfg.OBJ.LABEL_DIM))
        self.reset_optimizers()

    def init_state(self, generator: torch.Generator) -> "ShapeTrainer":
        from objgan_tpu_torch.train.gan import _default_label_table

        init_weights(self.g, generator)
        init_weights(self.d, generator)
        with torch.no_grad():
            self.label_table.copy_(_default_label_table(self.cfg, generator))
        if self.vgg is not None:
            self._init_vgg(generator)
        self.reset_optimizers()
        return self

    def _init_vgg(self, generator: torch.Generator) -> None:
        path = self.cfg.SHAPE.VGG_WEIGHTS
        if path:
            load_torchvision_vgg16(self.vgg, torch.load(
                path, map_location="cpu", weights_only=True))
            print(f"loaded VGG-16 weights from {path}")
        else:
            init_weights(self.vgg, generator)
            print("WARNING: SHAPE.PERCEPTUAL=vgg without "
                  "SHAPE.VGG_WEIGHTS — perceptual features are RANDOM "
                  "(structural test only)")

    def reset_optimizers(self) -> None:
        lr = self.cfg.SHAPE.LEARNING_RATE
        self.g_opt = adam(self.g.parameters(), lr)
        self.d_opt = adam(self.d.parameters(), lr)
        self.step = 0

    def optimizers(self):
        return [self.g_opt, self.d_opt]

    def losses(self, batch: Dict, z: torch.Tensor):
        """(d_loss + g_loss, metrics) of one step on ``batch`` (boxes,
        labels, obj_valid and the ground-truth masks ``shapes``, or a wire
        batch's ``shapes_u8``, expanded here)."""
        batch = from_wire(self.cfg, batch)
        boxes, valid = batch["boxes"], batch["obj_valid"]
        shapes = batch["shapes"]
        labels_emb = self.label_table[batch["labels"].long()]
        mask_logits = self.g(boxes, labels_emb, valid, z)
        fake = torch.sigmoid(mask_logits)
        real_logits, real_feats = self.d(shapes, boxes, labels_emb)
        fake_logits_d, _ = self.d(fake.detach(), boxes, labels_emb)
        d_l = shape_d_loss(real_logits, fake_logits_d, valid)
        frozen_d = {k: v.detach() for k, v in self.d.named_parameters()}
        fake_logits_g, fake_feats = functional_call(
            self.d, frozen_d, (fake, boxes, labels_emb))
        # VGG's perceptual term replaces D feature matching
        lambda_fm = 0.0 if self.vgg is not None else self.cfg.SHAPE.LAMBDA_FM
        g_l, aux = shape_g_loss(
            fake_logits_g, [f.detach() for f in real_feats], fake_feats,
            shapes, mask_logits, valid, lambda_fm)
        if self.vgg is not None:
            b, o, s, _ = fake.shape
            per = vgg_perceptual_loss(self.vgg, fake.reshape(b * o, s, s),
                                      shapes.reshape(b * o, s, s))
            v = valid.reshape(b * o).float()
            perceptual = masked_mean_share((per * v).sum(), v.sum())
            g_l = g_l + self.cfg.SHAPE.LAMBDA_PERCEPTUAL * perceptual
            aux["shape_perceptual"] = perceptual
        aux.update(shape_d=d_l, shape_g=g_l)
        return d_l + g_l, aux

    def grads(self, batch: Dict, z: torch.Tensor):
        """Every G and D gradient by parameter name, from one backward, and
        the step's metrics (detached)."""
        total, metrics = self.losses(batch, z)
        return self.grads_of([(total, self.trained_parameters())], metrics)

    def train_step(self, batch: Dict,
                   z: torch.Tensor) -> Dict[str, torch.Tensor]:
        grads, metrics = self.grads(batch, z)
        self.apply_grads(grads)
        return metrics

    def step_noise(self, batch: Dict, generator: torch.Generator):
        """(z of ``shape_noise``,)."""
        return (shape_noise(self.cfg, batch["labels"].shape[0], generator,
                            generator.device),)

    @torch.no_grad()
    def sample(self, boxes: torch.Tensor, labels: torch.Tensor,
               obj_valid: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return sample(self, boxes, labels, obj_valid, z)
