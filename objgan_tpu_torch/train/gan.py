"""Stage C, sampling: the frozen text encoder, the label table and the
(EMA) generator. Port of ``GanTrainer.sample`` and ``_default_label_table``
from ``objgan_tpu/train/gan.py``; the train step is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from objgan_tpu.core.config import Config
from objgan_tpu_torch.models.damsm import build_text_encoder
from objgan_tpu_torch.models.generator import GNet


def _default_label_table(cfg: Config,
                         generator: torch.Generator) -> torch.Tensor:
    """Frozen label-embedding table: the GloVe class-name table for the 81
    COCO classes (random crc32-seeded vectors per word without a GloVe
    file), a random N(0, 0.02^2) table for any other class count."""
    if cfg.OBJ.NUM_CLASSES == 81:
        from objgan_tpu_torch.data.glove import (coco_label_table,
                                                 resolve_glove_path)

        return torch.from_numpy(coco_label_table(
            cfg.OBJ.LABEL_DIM,
            glove_path=resolve_glove_path(cfg, cfg.OBJ.LABEL_DIM)))
    return torch.randn(cfg.OBJ.NUM_CLASSES, cfg.OBJ.LABEL_DIM,
                       generator=generator) * 0.02


class GanState(nn.Module):
    """What Stage-C sampling reads: the EMA generator ``g_net``, the DAMSM
    ``text_enc`` and this stage's own ``label_table`` buffer."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.g_net = GNet(cfg)
        self.text_enc = build_text_encoder(cfg)
        self.register_buffer("label_table", torch.zeros(
            cfg.OBJ.NUM_CLASSES, cfg.OBJ.LABEL_DIM))


def sample(state: GanState, batch: Dict[str, torch.Tensor], z: torch.Tensor,
           ca_eps: torch.Tensor) -> Dict[str, object]:
    """Text + layout -> image pyramid. ``batch`` holds captions (B, T),
    cap_lens (B,), labels (B, O), boxes (B, O, 4), shapes (B, O, S, S) and
    obj_valid (B, O); z (B, Z) and ca_eps (B, CONDITION_DIM) are the noise."""
    captions = batch["captions"]
    t = captions.shape[1]
    words, sent = state.text_enc(captions, batch["cap_lens"])
    word_mask = (torch.arange(t, device=captions.device)[None]
                 >= batch["cap_lens"][:, None])
    labels_emb = state.label_table[batch["labels"]]
    return state.g_net(z, sent, words, word_mask, labels_emb, batch["boxes"],
                       batch["shapes"], batch["obj_valid"], ca_eps)
