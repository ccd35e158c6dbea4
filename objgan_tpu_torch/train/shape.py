"""Stage B, sampling: boxes -> masks. Port of ``ShapeTrainer.sample`` from
``objgan_tpu/train/shape.py``; the trainer is not ported yet."""

from __future__ import annotations

import torch
import torch.nn as nn

from objgan_tpu_torch.core.config import Config
from objgan_tpu_torch.models.shape_generator import ShapeGenerator


class ShapeState(nn.Module):
    """The shape generator ``g`` and this stage's own ``label_table``
    buffer (at a class count other than COCO's 81 it differs from the
    Stage-C table)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.g = ShapeGenerator(cfg)
        self.register_buffer("label_table", torch.zeros(
            cfg.OBJ.NUM_CLASSES, cfg.OBJ.LABEL_DIM))


def sample(state: ShapeState, boxes: torch.Tensor, labels: torch.Tensor,
           obj_valid: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """boxes (B, O, 4), labels (B, O), obj_valid (B, O), noise z
    (B, O, 1, 1, SHAPE.GF_DIM) -> masks (B, O, S, S) in [0, 1]."""
    labels_emb = state.label_table[labels]
    return torch.sigmoid(state.g(boxes, labels_emb, obj_valid, z))
