"""Stage A, sampling: caption -> layout. Port of ``BoxTrainer.sample`` from
``objgan_tpu/train/box.py``; the trainer and beam search are not ported
yet."""

from __future__ import annotations

from typing import Dict

import torch

from objgan_tpu_torch.models.box_generator import BoxGenerator


def sample(model: BoxGenerator, captions: torch.Tensor,
           cap_lens: torch.Tensor,
           noise: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Temperature-sampled layout; ``noise`` as drawn by
    ``pipeline_e2e.draw_noise`` (label_gumbel, comp_gumbel, box_normal)."""
    return model.sample(captions, cap_lens, noise["label_gumbel"],
                        noise["comp_gumbel"], noise["box_normal"])
