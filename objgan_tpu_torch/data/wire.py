"""The compact uint8 batch wire format, expanded on the device. Port of
``objgan_tpu/data/wire.py::from_wire``.

A wire batch carries the finest image scale as uint8 (``image_u8``,
(B, S, S, 3)) and the masks 255-quantised as uint8 (``shapes_u8``). The
coarser scales are exact box-filter means of the finest one.
``from_wire`` returns a classic batch (the image pyramid in [-1, 1] as fp32,
fp32 masks) and passes a classic batch through unchanged.
"""

from __future__ import annotations

from typing import Dict

import torch

WIRE_IMAGE = "image_u8"    # (B, S, S, 3) uint8, finest scale
WIRE_SHAPES = "shapes_u8"  # (B, O, s, s) uint8, mask value x 255


def is_wire(batch: Dict) -> bool:
    return WIRE_IMAGE in batch or WIRE_SHAPES in batch


def from_wire(cfg, batch: Dict) -> Dict:
    """Expand a wire batch to the classic one; identity otherwise."""
    if not is_wire(batch):
        return batch
    out = {k: v for k, v in batch.items()
           if k not in (WIRE_IMAGE, WIRE_SHAPES)}
    if WIRE_SHAPES in batch:
        out["shapes"] = batch[WIRE_SHAPES].float() / 255.0
    if WIRE_IMAGE in batch:
        img = batch[WIRE_IMAGE].float() / 127.5 - 1.0
        sizes = list(cfg.branch_sizes)  # coarse -> fine
        if img.shape[1] != sizes[-1]:
            raise ValueError(
                f"wire image is {img.shape[1]}px but cfg expects finest "
                f"scale {sizes[-1]}px ({sizes}) — feed and config disagree")
        pyr = [img]
        for sz in reversed(sizes[:-1]):
            prev = pyr[0]
            b, h, w, c = prev.shape
            f = h // sz
            pyr.insert(0, prev.reshape(b, sz, f, sz, f, c).mean(dim=(2, 4)))
        out["images"] = pyr
    return out
