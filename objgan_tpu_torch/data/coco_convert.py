"""Convert standard COCO annotation files into the manifest records of
``data/pipeline.py``. A copy of ``objgan_tpu/data/coco_convert.py``, so
that the port prepares its datasets without the JAX package:

    python -m objgan_tpu_torch.data.coco_convert \
        --instances annotations/instances_train2017.json \
        --captions annotations/captions_train2017.json \
        --out train_manifest.json [--min_area 0.002] [--max_images N]

Output records hold normalized boxes/polygons and caption strings; images
stay on disk (records carry ``image_file`` relative paths; CocoFeed loads
lazily when the key is present).
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

# COCO category_id (1..90, sparse) -> contiguous 1..80 label ids matching
# data/glove.py:COCO_CLASSES order.
COCO_ID_TO_CONTIGUOUS = {
    cid: i + 1
    for i, cid in enumerate([
        1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20,
        21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
        41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
        59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79,
        80, 81, 82, 84, 85, 86, 87, 88, 89, 90,
    ])
}


def convert(
    instances: Dict,
    captions: Dict,
    min_area: float = 0.0,
    max_objects: Optional[int] = None,
    max_images: Optional[int] = None,
) -> List[Dict]:
    """COCO dicts -> manifest records. Boxes/polygons normalized to [0,1];
    crowd annotations and degenerate boxes dropped."""
    images = {im["id"]: im for im in instances["images"]}
    caps_by_img = defaultdict(list)
    for c in captions["annotations"]:
        caps_by_img[c["image_id"]].append(c["caption"])

    anns_by_img = defaultdict(list)
    for a in instances["annotations"]:
        if a.get("iscrowd", 0):
            continue
        anns_by_img[a["image_id"]].append(a)

    records = []
    for img_id, anns in anns_by_img.items():
        if img_id not in images or not caps_by_img.get(img_id):
            continue
        im = images[img_id]
        w, h = float(im["width"]), float(im["height"])
        labels, boxes, polys = [], [], []
        # salient-first: large objects first (matches the feed's canonical
        # order so truncation under MAX_OBJECTS keeps the main objects)
        anns = sorted(anns, key=lambda a: -a.get("area", 0.0))
        for a in anns:
            if a["category_id"] not in COCO_ID_TO_CONTIGUOUS:
                continue
            x, y, bw, bh = a["bbox"]
            if bw <= 1 or bh <= 1:
                continue
            if (bw * bh) / (w * h) < min_area:
                continue
            seg = a.get("segmentation")
            poly = None
            if isinstance(seg, list) and seg and isinstance(seg[0], list):
                # largest-AREA polygon part (shoelace), normalized to image
                # coords — vertex count would pick a highly-detailed sliver
                # over the actual body of an occlusion-split instance
                def _area(part):
                    p = np.asarray(part, np.float64).reshape(-1, 2)
                    x_, y_ = p[:, 0], p[:, 1]
                    return 0.5 * abs(float(
                        np.dot(x_, np.roll(y_, -1))
                        - np.dot(y_, np.roll(x_, -1))))

                part = max(seg, key=_area)
                p = np.asarray(part, np.float64).reshape(-1, 2)
                poly = (p / [w, h]).tolist()
            labels.append(COCO_ID_TO_CONTIGUOUS[a["category_id"]])
            boxes.append([x / w, y / h, bw / w, bh / h])
            polys.append(poly)
            if max_objects and len(labels) >= max_objects:
                break
        if not labels:
            continue
        rec = {
            "captions": caps_by_img[img_id],
            "labels": labels,
            "boxes": boxes,
            "image_file": im.get("file_name"),
        }
        if any(p is not None for p in polys):
            rec["polygons"] = [
                p if p is not None else [[0.0, 0.0], [1.0, 0.0], [1.0, 1.0],
                                         [0.0, 1.0]]
                for p in polys
            ]
        records.append(rec)
        if max_images and len(records) >= max_images:
            break
    return records


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--instances", required=True)
    ap.add_argument("--captions", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--min_area", type=float, default=0.0)
    ap.add_argument("--max_objects", type=int, default=None)
    ap.add_argument("--max_images", type=int, default=None)
    args = ap.parse_args()
    with open(args.instances) as f:
        inst = json.load(f)
    with open(args.captions) as f:
        caps = json.load(f)
    records = convert(inst, caps, args.min_area, args.max_objects,
                      args.max_images)
    with open(args.out, "w") as f:
        json.dump(records, f)
    print(f"wrote {len(records)} records to {args.out}")


if __name__ == "__main__":
    main()
