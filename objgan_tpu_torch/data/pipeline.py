"""Host-side data feed: COCO-format records -> numpy batches. A copy of what
the port's trainers need from ``objgan_tpu/data/pipeline.py``, so that the
port imports nothing of the JAX package; ``tests/test_torch_data.py`` holds
the two feeds to bitwise-equal batches.

  record (dict, one image):
      "captions":  list[str]                  (CAPTIONS_PER_IMAGE strings)
      "labels":    int array (n_obj,)          COCO class ids, 1..80
      "boxes":     float array (n_obj, 4)      normalized (x0, y0, w, h)
      "polygons":  optional list of (k, 2) float arrays, normalized image
                   coords, one polygon per object (instance segmentation)
      "masks":     optional (n_obj, S, S) float — precomputed per-object
                   masks in their own box frame (skips rasterization)
      "image":     optional (H, W, 3) uint8/float — the photo
      "image_file": optional path of the photo, relative to the image root

Per batch the feed tokenizes one randomly chosen caption per image, pads
objects to MAX_OBJECTS with validity masks, rasterizes polygon masks into
each object's box frame, and builds the image pyramid by area resize. The
batch has the keys and dtypes of ``data/synthetic.py``'s, as numpy arrays;
the trainer moves it onto its device.

``wire=True`` gives the uint8 wire batch of ``data/wire.py`` instead: the
finest image scale as uint8 (``image_u8``) and the masks 255-quantised
(``shapes_u8``); the trainers expand it on the device (``from_wire``). The
deterministic work per record (decode, resize, rasterization, caption
tokenization) is then done once and kept in a RAM cache when the dataset's
predicted footprint fits the budget of :func:`wire_cache_allowed`.

Polygons are filled by the C++ scanline fill of ``native/rasterize.cc``,
built with g++ at first use; a failed build raises (no quiet fallback).
``_numpy_polygon_fill`` is its plain version, which the tests hold it to.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from objgan_tpu_torch import native
from objgan_tpu_torch.core.config import Config
from objgan_tpu_torch.data.tokenizer import Vocab
from objgan_tpu_torch.data.wire import WIRE_IMAGE, WIRE_SHAPES


def polygon_to_box_mask(
    polygon: np.ndarray, box: np.ndarray, size: int
) -> np.ndarray:
    """Rasterize one normalized-image-coords polygon into the object's own
    (size, size) box frame, with the native fill (``native/``)."""
    x0, y0, w, h = [float(v) for v in box]
    local = np.empty_like(polygon, dtype=np.float64)
    local[:, 0] = (polygon[:, 0] - x0) / max(w, 1e-6)
    local[:, 1] = (polygon[:, 1] - y0) / max(h, 1e-6)
    return native.rasterize_polygon(local, size)


def _numpy_polygon_fill(poly: np.ndarray, size: int) -> np.ndarray:
    """Even-odd scanline fill at pixel centers, vectorized over rows."""
    ys = (np.arange(size) + 0.5) / size  # (S,)
    xs = (np.arange(size) + 0.5) / size  # (S,)
    x1 = poly[:, 0]
    y1 = poly[:, 1]
    x2 = np.roll(x1, -1)
    y2 = np.roll(y1, -1)
    # for each scanline y, each edge crossing contributes an x intercept
    out = np.zeros((size, size), np.float32)
    for i, y in enumerate(ys):
        crosses = (y1 <= y) != (y2 <= y)
        if not crosses.any():
            continue
        t = (y - y1[crosses]) / (y2[crosses] - y1[crosses])
        xi = x1[crosses] + t * (x2[crosses] - x1[crosses])
        inside = (xi[None, :] <= xs[:, None]).sum(axis=1) % 2 == 1
        out[i] = inside
    return out


def _resize_area(img: np.ndarray, size: int) -> np.ndarray:
    """Area (box-filter) resize to (size, size, C).

    Exact strided mean when the ratio is integer; PIL's BOX filter
    otherwise — the filter ``_file_pyramid`` uses, so an inline
    ``rec['image']`` and the identical on-disk file give the same pixel
    statistics. Nearest-neighbor subsampling only when PIL is missing."""
    h, w = img.shape[:2]
    if h == size and w == size:
        return img
    if h % size == 0 and w % size == 0:
        fh, fw = h // size, w // size
        return img.reshape(size, fh, size, fw, -1).mean(axis=(1, 3))
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover - PIL is installed on both hosts
        yi = (np.arange(size) * h // size).clip(0, h - 1)
        xi = (np.arange(size) * w // size).clip(0, w - 1)
        return img[yi][:, xi]
    if img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        return np.asarray(Image.fromarray(img).resize((size, size),
                                                      Image.BOX))
    chans = img if img.ndim == 3 else img[..., None]
    out = np.stack(
        [np.asarray(Image.fromarray(np.ascontiguousarray(c, np.float32),
                                    mode="F").resize((size, size),
                                                     Image.BOX))
         for c in np.moveaxis(chans, -1, 0)], axis=-1)
    if np.issubdtype(img.dtype, np.integer):
        out = np.round(out)
    out = out.astype(img.dtype)
    return out if img.ndim == 3 else out[..., 0]


class CocoFeed:
    """Infinite shuffled batch iterator over a list of records.

    ``augment=True`` adds the lineage's training-time augmentation, kept
    geometry-consistent across every modality: a random horizontal flip
    applied jointly to the image, the boxes (x0 -> 1 - x0 - w) and the
    per-object masks, and <unk> word dropout. ``with_masks=False`` skips
    mask rasterization and omits "shapes"; ``with_images=False`` omits the
    pyramid. ``id_offset``/``id_stride`` map a partition's local record
    index i to its global id offset + i * stride (the "class_ids").

    ``wire=True`` emits the uint8 wire batch (module doc). Its cache keys
    on the global record id and is all-or-nothing: on when the dataset fits
    the byte budget of :func:`wire_cache_allowed`, or within an explicit
    ``cache_limit`` record count; beyond it every epoch recomputes. Rows
    hand out the cached arrays themselves or views of them (a flip is a
    negative-stride view): nothing downstream may write into a row."""

    def __init__(self, cfg: Config, records: Sequence[Dict], vocab: Vocab,
                 seed: int = 0, with_images: bool = True,
                 augment: bool = True, image_root: Optional[str] = None,
                 wire: bool = False, cache_limit: Optional[int] = None,
                 with_masks: bool = True, id_offset: int = 0,
                 id_stride: int = 1):
        self.cfg = cfg
        self.records = list(records)
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.with_images = with_images
        self.id_offset = int(id_offset)
        self.id_stride = int(id_stride)
        self.with_masks = with_masks
        self.augment = augment
        self.wire = wire
        self._cache: Optional[Dict[int, Dict]] = (
            {} if wire and wire_cache_allowed(cfg, len(self.records),
                                              cache_limit, with_images,
                                              with_masks)
            else None
        )
        self.image_root = image_root or cfg.DATA_DIR
        if not self.records:
            raise ValueError("empty dataset")
        validate_vocab(cfg, vocab)
        validate_labels(cfg, self.records)
        if with_images:
            validate_image_records(self.records)

    def _load_image(self, rec: Dict) -> Optional[np.ndarray]:
        """Inline array, or lazy-load ``image_file`` via PIL."""
        if rec.get("image") is not None:
            return np.asarray(rec["image"], np.float32)
        if rec.get("image_file"):
            from PIL import Image

            path = os.path.join(self.image_root, rec["image_file"])
            with Image.open(path) as im:
                return np.asarray(im.convert("RGB"), np.float32)
        return None

    def _file_pyramid(self, rec: Dict, flip: bool) -> Optional[list]:
        """Pyramid of an on-disk image by PIL's C box-filter resize, each
        scale from the decoded original. An inline ``rec['image']`` keeps
        precedence over ``image_file``: None, so the slow path serves it."""
        if rec.get("image") is not None or not rec.get("image_file"):
            return None
        from PIL import Image

        path = os.path.join(self.image_root, rec["image_file"])
        with Image.open(path) as im:
            im = im.convert("RGB")
            if flip:
                im = im.transpose(Image.FLIP_LEFT_RIGHT)
            out = []
            for sz in self.cfg.branch_sizes:
                r = im if im.size == (sz, sz) else im.resize((sz, sz),
                                                             Image.BOX)
                out.append(np.asarray(r, np.float32) / 127.5 - 1.0)
        return out

    @staticmethod
    def _image_was_int(rec: Dict) -> bool:
        """Integer-typed pixels (incl. decoded files) get /127.5-1."""
        if rec.get("image") is not None:
            return np.issubdtype(np.asarray(rec["image"]).dtype, np.integer)
        return bool(rec.get("image_file"))  # PIL decode = uint8

    def _canonical(self, rec: Dict):
        """Deterministic layout canonicalization: salient-first order (area
        descending, ties left-to-right), MAX_OBJECTS padding, per-object
        masks in box frame."""
        cfg = self.cfg
        o = cfg.OBJ.MAX_OBJECTS
        s = cfg.OBJ.SHAPE_SIZE
        n = min(len(rec["labels"]), o)
        labels = np.zeros((o,), np.int32)
        boxes = np.zeros((o, 4), np.float32)
        valid = np.zeros((o,), np.float32)
        masks = np.zeros((o, s, s), np.float32)
        all_labels = np.asarray(rec["labels"], np.int32)
        all_boxes = np.asarray(rec["boxes"], np.float32).reshape(-1, 4)
        order = np.lexsort(
            (all_boxes[:, 0], -(all_boxes[:, 2] * all_boxes[:, 3]))
        )[: n]
        labels[:n] = all_labels[order]
        boxes[:n] = all_boxes[order]
        valid[:n] = 1.0
        if not self.with_masks:
            return labels, boxes, valid, None
        if rec.get("masks") is not None:
            m = np.asarray(rec["masks"], np.float32)[order]
            masks[:n] = m if m.shape[-1] == s else np.stack(
                [_resize_area(x[..., None], s)[..., 0] for x in m]
            )
        elif rec.get("polygons") is not None:
            for i, src in enumerate(order):
                masks[i] = polygon_to_box_mask(
                    np.asarray(rec["polygons"][src], np.float64), boxes[i], s
                )
        else:
            masks[:n] = 1.0  # box == shape fallback
        return labels, boxes, valid, masks

    def _word_dropout(self, caps: np.ndarray, lens: int, rng) -> np.ndarray:
        """<unk> word dropout in place on ``caps``."""
        p_drop = self.cfg.TEXT.WORD_DROPOUT
        if self.augment and p_drop > 0 and self.vocab.unk is not None:
            drop = (rng.random(lens) < p_drop)
            caps[:lens][drop] = self.vocab.unk
        return caps

    def _encode_caption(self, rec: Dict, rng) -> tuple:
        """Random caption pick + encode + <unk> word dropout."""
        cap = rec["captions"][rng.integers(len(rec["captions"]))]
        caps, lens = self.vocab.encode(cap, self.cfg.TEXT.WORDS_NUM)
        return self._word_dropout(caps, lens, rng), lens

    def _finest_u8(self, rec: Dict) -> Optional[np.ndarray]:
        """Finest-scale uint8 image (canonical orientation) for wire mode."""
        sz = self.cfg.branch_sizes[-1]
        if rec.get("image") is not None:
            img = np.asarray(rec["image"])
            if not np.issubdtype(img.dtype, np.integer):
                img = (img + 1.0) * 127.5  # [-1, 1] float contract -> u8
            img = _resize_area(img.astype(np.float32), sz)
            # round, as the PIL path does: truncation would bias an inline
            # image ~-0.5 LSB against the identical on-disk file
            return np.clip(np.round(img), 0.0, 255.0).astype(np.uint8)
        if rec.get("image_file"):
            from PIL import Image

            path = os.path.join(self.image_root, rec["image_file"])
            with Image.open(path) as im:
                im = im.convert("RGB")
                if im.size != (sz, sz):
                    im = im.resize((sz, sz), Image.BOX)
                return np.asarray(im, np.uint8)
        return None

    def _wire_base(self, rec: Dict, rec_id: int) -> Dict:
        """The cacheable deterministic work of one record in wire mode:
        decode + resize + rasterize + tokenize, once per record."""
        if self._cache is not None:
            hit = self._cache.get(rec_id)
            if hit is not None:
                return hit
        cfg = self.cfg
        labels, boxes, valid, masks = self._canonical(rec)
        base = {
            "enc": [self.vocab.encode(c, cfg.TEXT.WORDS_NUM)
                    for c in rec["captions"]],
            "labels": labels, "boxes": boxes, "valid": valid,
        }
        if masks is not None:
            # 8-bit quantization, not binarization: soft mask values
            # survive within 1/510, binary masks round-trip exactly
            base["masks_u8"] = np.clip(
                np.round(masks * 255.0), 0.0, 255.0).astype(np.uint8)
        if self.with_images:
            base["image_u8"] = self._finest_u8(rec)
        if self._cache is not None:
            self._cache[rec_id] = base
        return base

    def _one_wire(self, rec: Dict, rng, rec_id: int) -> Dict[str, np.ndarray]:
        base = self._wire_base(rec, rec_id)
        caps, lens = base["enc"][rng.integers(len(base["enc"]))]
        # copies before any write: the cached arrays serve every epoch
        caps = self._word_dropout(caps.copy(), lens, rng)
        flip = bool(self.augment and rng.random() < 0.5)
        boxes, masks = base["boxes"], base.get("masks_u8")
        if flip:
            n = int(base["valid"].sum())
            boxes = boxes.copy()
            boxes[:n, 0] = 1.0 - boxes[:n, 0] - boxes[:n, 2]
            if masks is not None:
                masks = masks[:, :, ::-1]
        out = {
            "captions": caps,
            "cap_lens": np.int32(lens),
            "class_ids": np.int32(rec_id),
            "labels": base["labels"],
            "boxes": boxes,
            "obj_valid": base["valid"],
        }
        if masks is not None:
            out[WIRE_SHAPES] = masks
        if self.with_images and base.get("image_u8") is not None:
            img = base["image_u8"]
            out[WIRE_IMAGE] = img[:, ::-1] if flip else img
        return out

    def _one(self, rec: Dict, rng: Optional[np.random.Generator] = None,
             rec_id: int = 0) -> Dict[str, np.ndarray]:
        rng = rng if rng is not None else self.rng
        cfg = self.cfg
        if self.wire:
            return self._one_wire(rec, rng, rec_id)
        caps, lens = self._encode_caption(rec, rng)
        labels, boxes, valid, masks = self._canonical(rec)
        n = int(valid.sum())

        flip = bool(self.augment and rng.random() < 0.5)
        if flip:
            boxes[:n, 0] = 1.0 - boxes[:n, 0] - boxes[:n, 2]
            if masks is not None:
                masks[:n] = masks[:n, :, ::-1]

        out = {
            "captions": caps,
            "cap_lens": np.int32(lens),
            # unique per-image id: DAMSM's class mask excludes only true
            # duplicates as negatives
            "class_ids": np.int32(rec_id),
            "labels": labels,
            "boxes": boxes,
            "obj_valid": valid,
        }
        if masks is not None:
            out["shapes"] = masks
        if self.with_images:
            pyramid = self._file_pyramid(rec, flip)
            if pyramid is not None:
                out["images"] = pyramid
            else:
                img = self._load_image(rec)
                if img is not None:
                    if self._image_was_int(rec):
                        img = img / 127.5 - 1.0  # uint8 -> [-1, 1]
                    # float inputs are REQUIRED to already be in [-1, 1]
                    if flip:
                        img = img[:, ::-1]
                    out["images"] = [
                        _resize_area(img, sz).astype(np.float32)
                        for sz in cfg.branch_sizes
                    ]
        return out

    def _epoch_indices(self) -> Iterator[int]:
        """Endless index stream: a shuffle per epoch without replacement,
        so every record is visited once per epoch. Batches may straddle
        epoch boundaries so they stay full."""
        while True:
            for i in self.rng.permutation(len(self.records)):
                yield int(i)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        cfg = self.cfg
        b = cfg.TRAIN.BATCH_SIZE
        index_stream = self._epoch_indices()
        while True:
            idx = [next(index_stream) for _ in range(b)]
            rows = [
                self._one(self.records[i],
                          rec_id=self.id_offset + int(i) * self.id_stride)
                for i in idx
            ]
            batch: Dict = {}
            for k in rows[0]:
                if k == "images":
                    batch[k] = [
                        np.stack([r[k][j] for r in rows])
                        for j in range(len(rows[0][k]))
                    ]
                else:
                    batch[k] = np.stack([r[k] for r in rows])
            yield batch


def wire_record_bytes(cfg: Config, with_images: bool = True,
                      with_masks: bool = True) -> int:
    """Predicted RAM bytes of one cached ``_wire_base`` entry, fixed by the
    config: finest-scale uint8 image + uint8 object masks + padded layout
    tensors + tokenized captions (nominal 5 captions a record, COCO's)."""
    img = cfg.branch_sizes[-1] ** 2 * 3 if with_images else 0
    masks = cfg.OBJ.MAX_OBJECTS * cfg.OBJ.SHAPE_SIZE ** 2 if with_masks else 0
    layout = cfg.OBJ.MAX_OBJECTS * (4 * 4 + 4 + 4)  # boxes f32 + label + valid
    caps = 5 * (cfg.TEXT.WORDS_NUM * 4 + 8)
    return img + masks + layout + caps


def _cgroup_mem_limit(proc_file: str = "/proc/self/cgroup",
                      v2_root: str = "/sys/fs/cgroup",
                      v1_root: str = "/sys/fs/cgroup/memory"
                      ) -> Optional[int]:
    """Tightest memory limit over this process's own cgroup and every
    ancestor up to the mount root. ``/proc/self/cgroup`` names the group
    the process lives in: a job can be limited in a nested group while the
    mount root stays unlimited."""
    groups = []  # (controller mount root, limit filename, group path)
    try:
        for line in open(proc_file):
            parts = line.strip().split(":", 2)
            if len(parts) != 3:
                continue
            _, ctrls, path = parts
            if ctrls == "":  # cgroup v2 unified hierarchy
                groups.append((v2_root, "memory.max", path))
            elif "memory" in ctrls.split(","):  # v1 memory controller
                groups.append((v1_root, "memory.limit_in_bytes", path))
    except OSError:
        pass
    if not groups:  # /proc unreadable: fall back to the mount roots
        groups = [(v2_root, "memory.max", "/"),
                  (v1_root, "memory.limit_in_bytes", "/")]
    best = None
    for root, fname, rel in groups:
        segs = [s for s in rel.strip("/").split("/") if s]
        # leaf -> root: a limit can sit on any ancestor; in a cgroup
        # namespace the own path may not exist under the host mount, and
        # the walk then reads the mount root
        for i in range(len(segs), -1, -1):
            try:
                raw = open(os.path.join(root, *segs[:i], fname)).read()
            except OSError:
                continue
            raw = raw.strip()
            if raw.isdigit():  # v2 writes "max" when unlimited
                v = int(raw)
                best = v if best is None else min(best, v)
    return best


def _physical_ram_bytes() -> int:
    """Memory available to this process: the host's physical RAM, clamped
    by the tightest cgroup limit (sysconf sees the host's RAM, not the
    container's)."""
    try:
        ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        if ram <= 0:  # sysconf returns -1 (no exception) for indeterminate
            ram = 16 << 30
    except (AttributeError, ValueError, OSError):  # non-POSIX fallback
        ram = 16 << 30
    limit = _cgroup_mem_limit()
    if limit is not None:
        ram = min(ram, limit)
    return ram


def wire_cache_allowed(cfg: Config, n_records: int,
                       cache_limit: Optional[int] = None,
                       with_images: bool = True,
                       with_masks: bool = True) -> bool:
    """All-or-nothing wire-cache policy: an explicit ``cache_limit`` wins;
    otherwise the dataset's predicted footprint must fit a quarter of
    physical RAM (room left for the prefetch queue, model state and the
    page cache that serves image decode)."""
    if cache_limit is not None:
        return n_records <= cache_limit
    budget = _physical_ram_bytes() // 4
    per = wire_record_bytes(cfg, with_images, with_masks)
    return n_records * per <= budget


def validate_vocab(cfg: Config, vocab) -> None:
    """Fail fast when the vocabulary exceeds cfg.TEXT.VOCAB_SIZE: the
    embedding lookup would index past its table."""
    if len(vocab) > cfg.TEXT.VOCAB_SIZE:
        raise ValueError(
            f"vocabulary has {len(vocab)} words but cfg.TEXT.VOCAB_SIZE "
            f"is {cfg.TEXT.VOCAB_SIZE}; raise it (nn.Embed would silently "
            "clamp out-of-range token ids)"
        )


def validate_labels(cfg: Config, records: Sequence[Dict]) -> None:
    """Fail fast on class ids outside [1, NUM_CLASSES): class id 0 is the
    reserved STOP/padding token, and an id past the table would one-hot to
    zeros or wrap."""
    hi = max((int(max(r["labels"])) for r in records if len(r["labels"])),
             default=1)
    lo = min((int(min(r["labels"])) for r in records if len(r["labels"])),
             default=1)
    if hi >= cfg.OBJ.NUM_CLASSES or lo < 1:
        raise ValueError(
            f"dataset has class ids in [{lo}, {hi}] but cfg.OBJ.NUM_CLASSES "
            f"is {cfg.OBJ.NUM_CLASSES}; labels must lie in [1, NUM_CLASSES) "
            f"— 0 is the reserved STOP/padding class (a 0-based export "
            f"must be shifted up by 1), and negative ids (e.g. a -1 "
            f"padding convention) would wrap via label_table[-1]"
        )


def validate_image_records(records: Sequence[Dict]) -> None:
    """Reject a dataset MIXING image-carrying and image-less records: batch
    assembly takes its keys from the first row, so a mixed dataset would
    give batches of order-dependent structure."""
    missing = [i for i, r in enumerate(records)
               if r.get("image") is None and not r.get("image_file")]
    if missing and len(missing) != len(records):
        raise ValueError(
            f"{len(missing)} of {len(records)} records have "
            f"neither 'image' nor 'image_file' (first: record "
            f"{missing[0]}) — a mixed dataset produces "
            f"order-dependent batch structure; fix the manifest or "
            f"pass with_images=False")


def load_records_json(path: str) -> List[Dict]:
    """Load a dataset manifest: a JSON list of records (see module doc).
    Polygons/boxes must already be normalized to [0, 1]."""
    with open(path) as f:
        return json.load(f)


def split_records(records: Sequence[Dict], val_fraction: float = 0.1,
                  seed: int = 0):
    """Deterministic (train, val) split — the ``B_VALIDATION`` consumer:
    with it set, trainers see the train portion and sampling the held-out
    portion."""
    n = len(records)
    n_val = max(1, int(round(n * val_fraction))) if n > 1 else 0
    order = np.random.default_rng(seed).permutation(n)
    val_idx = set(int(i) for i in order[:n_val])
    train = [r for i, r in enumerate(records) if i not in val_idx]
    val = [r for i, r in enumerate(records) if i in val_idx]
    return train, val
