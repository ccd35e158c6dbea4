"""fp32 means fp32 on the card.

cuDNN runs fp32 convolutions in TF32 by default (about three decimal
digits), and matmuls may be allowed to as well. The attention maps of this
model are specified in true fp32, and the Stage-A/B models run in fp32, so
every entry point calls ``true_fp32()`` before it builds a model.
"""

from __future__ import annotations

import torch


def true_fp32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
