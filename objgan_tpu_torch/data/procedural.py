"""Procedural COCO-format dataset generator, a stand-in for a COCO
download that needs no network. A copy of ``objgan_tpu/data/procedural.py``
that goes through the port's own converter.

Generates scenes of colored geometric objects standing in for COCO classes,
with real pixels on disk, COCO-format ``instances``/``captions`` dicts, and
polygon segmentations — then routes them through the real converter
(``data/coco_convert.convert``), so the full non-synthetic path (annotation
parsing, polygon normalization, manifest loading, lazy image decode,
rasterization) runs as it would on a genuine COCO download.

    python -m objgan_tpu_torch.data.procedural --out /tmp/coco_proc --n 200

writes ``<out>/images/*.png`` + ``<out>/manifest.json``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

import numpy as np

# (class name, original sparse COCO category_id, RGB color, shape kind)
_PALETTE = [
    ("sports ball", 37, (220, 40, 40), "circle"),
    ("kite", 38, (240, 200, 40), "diamond"),
    ("tv", 72, (40, 40, 60), "rect"),
    ("pizza", 59, (230, 140, 60), "circle"),
    ("car", 3, (50, 90, 200), "rect"),
    ("stop sign", 13, (200, 30, 30), "octagon"),
    ("umbrella", 28, (120, 40, 160), "semicircle"),
    ("clock", 85, (230, 230, 230), "circle"),
]
_COLOR_NAMES = {
    (220, 40, 40): "red", (240, 200, 40): "yellow", (40, 40, 60): "black",
    (230, 140, 60): "orange", (50, 90, 200): "blue", (200, 30, 30): "red",
    (120, 40, 160): "purple", (230, 230, 230): "white",
}
_BACKGROUNDS = [
    ((90, 160, 90), "grass"), ((150, 190, 230), "sky"),
    ((200, 180, 140), "sand"), ((120, 120, 130), "road"),
]


def _shape_polygon(kind: str, cx: float, cy: float, rx: float, ry: float,
                   rng: np.random.Generator) -> np.ndarray:
    """Closed polygon (k, 2) in image coords for one object."""
    if kind == "circle":
        t = np.linspace(0, 2 * np.pi, 20, endpoint=False)
        return np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], -1)
    if kind == "rect":
        return np.array([[cx - rx, cy - ry], [cx + rx, cy - ry],
                         [cx + rx, cy + ry], [cx - rx, cy + ry]], np.float64)
    if kind == "diamond":
        return np.array([[cx, cy - ry], [cx + rx, cy], [cx, cy + ry],
                         [cx - rx, cy]], np.float64)
    if kind == "octagon":
        t = np.linspace(0, 2 * np.pi, 8, endpoint=False) + np.pi / 8
        return np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], -1)
    if kind == "semicircle":
        t = np.linspace(0, np.pi, 12)
        arc = np.stack([cx + rx * np.cos(t), cy - ry * np.sin(t)], -1)
        return np.concatenate([arc, [[cx - rx, cy], [cx + rx, cy]]], 0)
    raise ValueError(kind)


def _fill_polygon(img: np.ndarray, poly: np.ndarray, color) -> None:
    """Even-odd scanline fill directly into the uint8 canvas."""
    h, w = img.shape[:2]
    x1, y1 = poly[:, 0], poly[:, 1]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
    for yi in range(max(0, int(y1.min())), min(h, int(y1.max()) + 2)):
        y = yi + 0.5
        crosses = (y1 <= y) != (y2 <= y)
        if not crosses.any():
            continue
        t = (y - y1[crosses]) / (y2[crosses] - y1[crosses])
        xs = np.sort(x1[crosses] + t * (x2[crosses] - x1[crosses]))
        for a, b in zip(xs[::2], xs[1::2]):
            img[yi, max(0, int(a)): min(w, int(b) + 1)] = color


def generate_scene(rng: np.random.Generator, size: int
                   ) -> Tuple[np.ndarray, List[Dict], List[str]]:
    """One scene: (uint8 image, object annotations, captions)."""
    bg_color, bg_name = _BACKGROUNDS[rng.integers(len(_BACKGROUNDS))]
    img = np.empty((size, size, 3), np.uint8)
    img[:] = bg_color
    # simple shading so images aren't constant off the objects
    grad = np.linspace(0.85, 1.1, size)[:, None, None]
    img = np.clip(img * grad, 0, 255).astype(np.uint8)

    n_obj = int(rng.integers(2, 5))
    anns, phrases = [], []
    for _ in range(n_obj):
        name, cid, color, kind = _PALETTE[rng.integers(len(_PALETTE))]
        rx = rng.uniform(0.06, 0.18) * size
        ry = rx * rng.uniform(0.7, 1.3)
        cx = rng.uniform(rx + 2, size - rx - 2)
        cy = rng.uniform(ry + 2, size - ry - 2)
        poly = _shape_polygon(kind, cx, cy, rx, ry, rng)
        jitter = np.clip(np.asarray(color, np.float64)
                         * rng.uniform(0.85, 1.1), 0, 255)
        _fill_polygon(img, poly, jitter.astype(np.uint8))
        x0, y0 = poly[:, 0].min(), poly[:, 1].min()
        bw, bh = poly[:, 0].max() - x0, poly[:, 1].max() - y0
        anns.append({
            "category_id": cid,
            "bbox": [float(x0), float(y0), float(bw), float(bh)],
            "area": float(bw * bh),
            "segmentation": [poly.reshape(-1).tolist()],
            "iscrowd": 0,
        })
        phrases.append(f"a {_COLOR_NAMES[color]} {name}")
    captions = [
        f"{' and '.join(phrases)} on the {bg_name}",
        f"a photo of {phrases[0]} on the {bg_name}",
        f"the {bg_name} with {' and '.join(sorted(phrases))}",
    ]
    return img, anns, captions


def generate_coco_dataset(out_dir: str, n_images: int = 200, size: int = 256,
                          seed: int = 0) -> Tuple[Dict, Dict]:
    """Write PNGs and return COCO-format (instances, captions) dicts."""
    from objgan_tpu_torch.utils.visualize import save_png

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations, cap_annotations = [], [], []
    ann_id, cap_id = 1, 1
    for i in range(n_images):
        img, anns, captions = generate_scene(rng, size)
        fname = f"images/proc_{i:05d}.png"
        save_png(os.path.join(out_dir, fname), img)
        images.append({"id": i + 1, "file_name": fname,
                       "width": size, "height": size})
        for a in anns:
            a = dict(a, id=ann_id, image_id=i + 1)
            annotations.append(a)
            ann_id += 1
        for c in captions:
            cap_annotations.append({"id": cap_id, "image_id": i + 1,
                                    "caption": c})
            cap_id += 1
    instances = {"images": images, "annotations": annotations}
    captions = {"annotations": cap_annotations}
    return instances, captions


def build_manifest(out_dir: str, n_images: int = 200, size: int = 256,
                   seed: int = 0) -> str:
    """Generate a dataset and convert it via the real COCO converter."""
    from objgan_tpu_torch.data.coco_convert import convert

    instances, captions = generate_coco_dataset(out_dir, n_images, size, seed)
    records = convert(instances, captions)
    path = os.path.join(out_dir, "manifest.json")
    with open(path, "w") as f:
        json.dump(records, f)
    print(f"wrote {len(records)} records to {path}")
    return path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    build_manifest(args.out, args.n, args.size, args.seed)


if __name__ == "__main__":
    main()
