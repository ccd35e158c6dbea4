"""End-to-end composed inference: caption -> layout -> shapes -> image.

Port of ``objgan_tpu/pipeline_e2e.py``. Stage A (boxes), Stage B (masks) and
Stage C (the image pyramid) run back to back on one device with no host
round trip. All randomness of a batch is drawn up front by ``draw_noise``,
on the device, from an explicit ``torch.Generator``; a test hands
``generate`` the draws that JAX's key chain made instead.
"""

from __future__ import annotations

import sys
from typing import Dict, Mapping

import torch
import torch.nn as nn

from objgan_tpu_torch.core.config import Config
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.core.layers import init_weights
from objgan_tpu_torch.models.box_generator import BoxGenerator
from objgan_tpu_torch.train import box as box_train
from objgan_tpu_torch.train import gan as gan_train
from objgan_tpu_torch.train import shape as shape_train


def _gumbel(shape, generator: torch.Generator,
            device: torch.device) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def draw_noise(cfg: Config, batch: int, generator: torch.Generator,
               device) -> Dict[str, torch.Tensor]:
    """Every random draw of one ``generate`` call:

    * Stage A, per decode step s: ``label_gumbel[s]`` (B, NUM_CLASSES),
      ``comp_gumbel[s]`` (B, GMM_COMPONENTS), ``box_normal[s]`` (B, 4);
    * Stage B: ``shape_z`` (B, O, 1, 1, SHAPE.GF_DIM), fp32 (the stage's
      dtype);
    * Stage C: ``z`` (B, Z_DIM) and the CA-net ``ca_eps``
      (B, CONDITION_DIM), fp32.
    """
    t, b = cfg.BOX.MAX_SEQ_LENGTH, batch

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    return {
        "label_gumbel": _gumbel((t, b, cfg.OBJ.NUM_CLASSES), generator,
                                device),
        "comp_gumbel": _gumbel((t, b, cfg.OBJ.GMM_COMPONENTS), generator,
                               device),
        "box_normal": normal(t, b, 4),
        "shape_z": normal(b, cfg.OBJ.MAX_OBJECTS, 1, 1, cfg.SHAPE.GF_DIM),
        "z": normal(b, cfg.GAN.Z_DIM),
        "ca_eps": normal(b, cfg.GAN.CONDITION_DIM),
    }


class ObjGanPipeline(nn.Module):
    """Composed three-stage sampler: ``box`` (Stage A), ``shape`` (Stage B)
    and ``gan`` (Stage C), each with its own weights."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.box = BoxGenerator(cfg)
        self.shape = shape_train.ShapeState(cfg)
        self.gan = gan_train.GanState(cfg)

    @classmethod
    def fresh(cls, cfg: Config, seed: int, device) -> "ObjGanPipeline":
        """Freshly initialised weights drawn from ``seed`` (on the CPU, so a
        seed gives the same weights on every device), moved to ``device``.
        No checkpoint loader exists yet: this warns that the weights are
        untrained."""
        pipe = cls(cfg)
        g = torch.Generator().manual_seed(seed)
        init_weights(pipe, g)
        pipe.shape.label_table.copy_(gan_train._default_label_table(cfg, g))
        pipe.gan.label_table.copy_(gan_train._default_label_table(cfg, g))
        print("WARNING: no checkpoint loader in the PyTorch port yet — the "
              "composed pipeline runs every stage with UNTRAINED random "
              "weights", file=sys.stderr)
        return pipe.to(device).eval()

    def load_jax_params(self, box: Mapping, shape_g: Mapping,
                        shape_label_table, gan_g: Mapping, text: Mapping,
                        gan_label_table) -> None:
        """Weights from the JAX package's stage states, as numpy trees:
        ``BoxTrainState.params``, ``ShapeTrainState.g_params`` and
        ``.label_table``, ``GanTrainState.ema_g_params``, ``.text_params``
        and ``.label_table``."""
        bridge.load_jax_params(self.box, box)
        bridge.load_jax_params(self.shape.g, shape_g)
        bridge.load_jax_params(self.gan.g_net, gan_g)
        bridge.load_jax_params(self.gan.text_enc, text)
        with torch.no_grad():
            self.shape.label_table.copy_(torch.tensor(shape_label_table))
            self.gan.label_table.copy_(torch.tensor(gan_label_table))

    @torch.inference_mode()
    def generate(self, captions: torch.Tensor, cap_lens: torch.Tensor,
                 noise: Dict[str, torch.Tensor]) -> Dict[str, object]:
        """caption ids (B, T) and lengths (B,) -> layout, masks and the
        image pyramid."""
        o = self.cfg.OBJ.MAX_OBJECTS
        layout = box_train.sample(self.box, captions, cap_lens, noise)
        labels, boxes, valid = (layout["labels"], layout["boxes"],
                                layout["obj_valid"])
        # object axis: BOX.MAX_SEQ_LENGTH -> OBJ.MAX_OBJECTS
        pad = o - labels.shape[1]
        if pad > 0:
            labels = nn.functional.pad(labels, (0, pad))
            boxes = nn.functional.pad(boxes, (0, 0, 0, pad))
            valid = nn.functional.pad(valid, (0, pad))
        else:
            labels, boxes, valid = labels[:, :o], boxes[:, :o], valid[:, :o]

        masks = shape_train.sample(self.shape, boxes, labels, valid,
                                   noise["shape_z"])
        batch = {
            "captions": captions, "cap_lens": cap_lens, "labels": labels,
            "boxes": boxes, "shapes": masks, "obj_valid": valid,
        }
        out = gan_train.sample(self.gan, batch, noise["z"], noise["ca_eps"])
        return {
            "labels": labels,
            "boxes": boxes,
            "obj_valid": valid,
            "masks": masks,
            "images": out["images"],
            "grid_attn": out["grid_attn"],
            "obj_attn": out["obj_attn"],
        }
