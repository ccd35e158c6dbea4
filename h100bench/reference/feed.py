"""Plain check of the training feed's rows against the raw dataset.

The train step's reference starts from the uint8 wire batches that the
program's feed handed to the step. This module checks that start on its
own, from the manifest and the PNG files, with none of the program's code:
for each row, the record its class id names; the image, decoded by PIL,
equal to the row's image or to its mirror; the labels and boxes in the
salient-first order (area descending, then left to right), mirrored with
the image; each mask the even-odd fill of the record's polygon at pixel
centres in the object's box frame, 255-quantised and mirrored likewise;
and the caption ids one of the record's captions under a vocabulary built
from the manifest (index 0 padding, 1 the unknown word, then the sorted
words), where a word may have been dropped to the unknown id.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Sequence

import numpy as np

_TOKEN = re.compile(r"\w+")


def tokenize(caption: str) -> List[str]:
    return _TOKEN.findall(caption.lower())


def build_vocab(records: Sequence[Dict]) -> Dict[str, int]:
    words = sorted({w for r in records for c in r["captions"]
                    for w in tokenize(c)} - {"<end>", "<unk>"})
    vocab = {"<end>": 0, "<unk>": 1}
    vocab.update({w: i + 2 for i, w in enumerate(words)})
    return vocab


def encode(vocab: Dict[str, int], caption: str, max_len: int):
    ids = [vocab.get(t, 1) for t in tokenize(caption)][:max_len]
    out = np.zeros(max_len, np.int64)
    out[:len(ids)] = ids
    return out, max(len(ids), 1)


def polygon_fill(poly: np.ndarray, size: int) -> np.ndarray:
    """Even-odd fill of ``poly`` (k, 2), in [0, 1] box coordinates, at the
    centres of a size x size grid."""
    c = (np.arange(size) + 0.5) / size
    x1, y1 = poly[:, 0], poly[:, 1]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
    out = np.zeros((size, size), np.float32)
    for i, y in enumerate(c):
        cross = (y1 <= y) != (y2 <= y)
        if cross.any():
            xi = x1[cross] + (y - y1[cross]) / (y2[cross] - y1[cross]) * (
                x2[cross] - x1[cross])
            out[i] = (xi[None, :] <= c[:, None]).sum(1) % 2 == 1
    return out


def row_faults(row: Dict[str, np.ndarray], rec: Dict, vocab: Dict[str, int],
               image_root: str, shape_size: int) -> List[str]:
    """What in one wire row disagrees with its record (empty if nothing)."""
    from PIL import Image

    faults = []
    with Image.open(os.path.join(image_root, rec["image_file"])) as im:
        img = np.asarray(im.convert("RGB"), np.uint8)
    flip = not np.array_equal(row["image_u8"], img)
    if flip and not np.array_equal(row["image_u8"], img[:, ::-1]):
        faults.append("image")
    o = len(row["labels"])
    boxes = np.asarray(rec["boxes"], np.float32).reshape(-1, 4)
    order = np.lexsort((boxes[:, 0], -(boxes[:, 2] * boxes[:, 3])))[:o]
    n = len(order)
    want_boxes = np.zeros((o, 4), np.float32)
    want_boxes[:n] = boxes[order]
    masks = np.zeros((o, shape_size, shape_size), np.float32)
    for i, src in enumerate(order):
        x0, y0, w, h = [float(v) for v in want_boxes[i]]
        poly = np.asarray(rec["polygons"][src], np.float64)
        local = np.stack([(poly[:, 0] - x0) / max(w, 1e-6),
                          (poly[:, 1] - y0) / max(h, 1e-6)], 1)
        masks[i] = polygon_fill(local, shape_size)
    masks_u8 = np.clip(np.round(masks * 255.0), 0, 255).astype(np.uint8)
    if flip:
        want_boxes[:n, 0] = 1.0 - want_boxes[:n, 0] - want_boxes[:n, 2]
        masks_u8 = masks_u8[:, :, ::-1]
    labels = np.zeros(o, np.int64)
    labels[:n] = np.asarray(rec["labels"])[order]
    if not np.array_equal(np.asarray(row["labels"]), labels):
        faults.append("labels")
    if not np.array_equal(np.asarray(row["boxes"], np.float32), want_boxes):
        faults.append("boxes")
    if not np.array_equal(np.asarray(row["obj_valid"]),
                          (np.arange(o) < n).astype(np.float32)):
        faults.append("obj_valid")
    if not np.array_equal(row["shapes_u8"], masks_u8):
        faults.append("masks")
    ids = np.asarray(row["captions"], np.int64)
    for cap in rec["captions"]:
        want, length = encode(vocab, cap, len(ids))
        if (int(row["cap_lens"]) == length
                and np.all((ids == want) | ((ids == 1) & (want > 0)))):
            break
    else:
        faults.append("caption")
    return faults


def batch_faults(batch: Dict[str, np.ndarray], records: Sequence[Dict],
                 vocab: Dict[str, int], image_root: str,
                 shape_size: int) -> int:
    """Rows of a wire batch that disagree with their records."""
    bad = 0
    for i in range(len(batch["class_ids"])):
        row = {k: v[i] for k, v in batch.items()}
        bad += bool(row_faults(row, records[int(row["class_ids"])], vocab,
                               image_root, shape_size))
    return bad


def load_records(path: str) -> List[Dict]:
    import json

    with open(path) as f:
        return json.load(f)
