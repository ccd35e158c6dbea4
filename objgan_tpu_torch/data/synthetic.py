"""Synthetic COCO-shaped batches, drawn from a ``torch.Generator`` on its
device. Counterpart of ``objgan_tpu/data/synthetic.py``: the same keys,
shapes, dtypes (int32 ids and lengths, fp32 the rest) and value ranges.

* captions (B, T) in [1, VOCAB_SIZE), zero past cap_lens (B,) in [3, T];
* 1..MAX_OBJECTS valid objects per image: obj_valid (B, O), labels (B, O)
  in [1, NUM_CLASSES) and 0 where padded, boxes (B, O, 4) with x, y in
  [0, 0.7) and w, h in [0.1, 0.3);
* shapes (B, O, S, S): a disc of radius 0.7 around a centre within 0.3 of
  the object frame's middle;
* class_ids (B,) = id_offset + arange(B), unique in the batch (DAMSM's
  class mask drops pairs with equal ids); a rank passes the start of its
  slice of the global batch, so the ids stay unique across ranks;
* images: one (B, s, s, 3) tensor in [-1, 1) per pyramid scale, left out
  with ``with_images=False`` (Stages A and B read none).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from objgan_tpu_torch.core.config import Config


def synthetic_batch(cfg: Config, generator: torch.Generator,
                    batch: Optional[int] = None,
                    with_images: bool = True,
                    id_offset: int = 0) -> Dict[str, object]:
    b = batch or cfg.TRAIN.BATCH_SIZE
    t = cfg.TEXT.WORDS_NUM
    o = cfg.OBJ.MAX_OBJECTS
    s = cfg.OBJ.SHAPE_SIZE
    dev = generator.device

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=generator, device=dev,
                             dtype=torch.int32)

    def uniform(lo, hi, shape):
        u = torch.rand(shape, generator=generator, device=dev)
        return lo + (hi - lo) * u

    cap_lens = randint(3, t + 1, (b,))
    captions = randint(1, cfg.TEXT.VOCAB_SIZE, (b, t))
    pos = torch.arange(t, device=dev)[None]
    captions = torch.where(pos < cap_lens[:, None], captions,
                           torch.zeros_like(captions))
    n_obj = randint(1, o + 1, (b,))
    obj_valid = (torch.arange(o, device=dev)[None]
                 < n_obj[:, None]).float()
    labels = (randint(1, cfg.OBJ.NUM_CLASSES, (b, o)) * obj_valid).int()
    boxes = torch.cat([uniform(0.0, 0.7, (b, o, 2)),
                       uniform(0.1, 0.3, (b, o, 2))], dim=-1)
    grid = torch.linspace(-1.0, 1.0, s, device=dev)
    yy, xx = grid[None, None, :, None], grid[None, None, None, :]
    cx = uniform(-0.3, 0.3, (b, o, 1, 1))
    cy = uniform(-0.3, 0.3, (b, o, 1, 1))
    shapes = (torch.sqrt((xx - cx) ** 2 + (yy - cy) ** 2) < 0.7).float()
    out = {
        "captions": captions,
        "cap_lens": cap_lens,
        "class_ids": torch.arange(id_offset, id_offset + b,
                                  dtype=torch.int32, device=dev),
        "labels": labels,
        "boxes": boxes,
        "shapes": shapes,
        "obj_valid": obj_valid,
    }
    if with_images:
        out["images"] = [uniform(-1.0, 1.0, (b, size, size, 3))
                         for size in cfg.branch_sizes]
    return out


def synthetic_layout_batch(cfg: Config, generator: torch.Generator,
                           batch: int = 8) -> Dict[str, torch.Tensor]:
    """(captions, cap_lens, labels, boxes, obj_valid) for Stage-A training:
    ``synthetic_batch``'s layout keys, drawn from ``generator``."""
    d = synthetic_batch(cfg, generator, batch, with_images=False)
    return {k: d[k] for k in
            ("captions", "cap_lens", "labels", "boxes", "obj_valid")}
