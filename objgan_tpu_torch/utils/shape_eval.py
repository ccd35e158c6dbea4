"""Stage-B evaluation: held-out mask quality of the shape generator. Port
of ``objgan_tpu/utils/shape_eval.py``. Every metric is over valid objects
only; the trainer samples on its device, the metrics are numpy on the
host."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from objgan_tpu_torch.utils.box_eval import _np


@torch.no_grad()
def heldout_mask_metrics(trainer, batches: Sequence[Dict],
                         zs: Sequence[torch.Tensor],
                         threshold: float = 0.5) -> Dict[str, float]:
    """Masks sampled for ``batches`` (on the trainer's device; batch i with
    the noise ``zs[i]``) against the ground truth:

    - ``mask_iou``: mean IoU (prediction above ``threshold``, ground truth
      above 0.5; empty against empty counts as 1);
    - ``mask_pixel_acc``: mean per-object pixel accuracy;
    - ``area_ratio``: mean predicted over ground-truth area, over objects
      with a non-empty ground truth;
    - ``n_objects``: the valid objects scored.
    """
    ious, accs, ratios = [], [], []
    n_obj = 0
    for batch, z in zip(batches, zs):
        pred = _np(trainer.sample(batch["boxes"], batch["labels"],
                                  batch["obj_valid"], z))
        gt = _np(batch["shapes"]) > 0.5
        pm = pred > threshold
        valid = _np(batch["obj_valid"]).astype(bool)
        for b, o in zip(*np.nonzero(valid)):
            p, g = pm[b, o], gt[b, o]
            inter = float(np.logical_and(p, g).sum())
            union = float(np.logical_or(p, g).sum())
            ious.append(inter / union if union else 1.0)
            accs.append(float((p == g).mean()))
            ga = float(g.sum())
            if ga:
                ratios.append(float(p.sum()) / ga)
            n_obj += 1
    return {
        "mask_iou": float(np.mean(ious)) if ious else 0.0,
        "mask_pixel_acc": float(np.mean(accs)) if accs else 0.0,
        "area_ratio": float(np.mean(ratios)) if ratios else 0.0,
        "n_objects": float(n_obj),
    }
