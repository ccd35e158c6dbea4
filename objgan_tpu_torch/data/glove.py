"""GloVe label-embedding tables, without JAX.

A copy of the table part of ``objgan_tpu/data/glove.py`` for the port
(importing ``objgan_tpu.data`` imports JAX): a ``glove.6B.<dim>d.txt``-style
file when present, else deterministic crc32-seeded random vectors per word.
``tests/test_torch_data.py`` holds the two copies to identical tables.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

COCO_CLASSES = [
    "background", "person", "bicycle", "car", "motorcycle", "airplane",
    "bus", "train", "truck", "boat", "traffic light", "fire hydrant",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "backpack",
    "umbrella", "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]


def load_glove_file(path: str, dim: int) -> Dict[str, np.ndarray]:
    table: Dict[str, np.ndarray] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) != dim + 1:
                continue
            table[parts[0]] = np.asarray(parts[1:], np.float32)
    return table


def _random_vector(word: str, dim: int) -> np.ndarray:
    # zlib.crc32, not hash(): str hashing is salted per process, which would
    # regenerate DIFFERENT fallback vectors at inference than at training
    import zlib

    seed = zlib.crc32(("glove:" + word).encode("utf-8"))
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, 0.3, dim).astype(np.float32)


def vocab_table(
    words: Sequence[str], dim: int, glove_path: Optional[str] = None
) -> np.ndarray:
    """(len(words), dim) table; multi-word names average their word vectors
    (the lineage's treatment of two-word COCO classes).

    An EXPLICITLY supplied ``glove_path`` that is missing or yields no
    vectors at this ``dim`` raises: the caller asked for real GloVe
    embeddings, and silently degrading every word to the crc32-seeded
    random fallback is the exact failure this loud check prevents
    (e.g. a 300d file opened with dim=128 parses zero lines)."""
    glove = {}
    if glove_path:
        if not os.path.exists(glove_path):
            raise FileNotFoundError(
                f"GloVe file {glove_path!r} does not exist (TEXT.GLOVE_PATH "
                "points nowhere — fix the path or unset it to use the "
                "documented random-fallback vectors)")
        glove = load_glove_file(glove_path, dim)
        if not glove:
            raise ValueError(
                f"GloVe file {glove_path!r} contains no {dim}-d vectors — "
                "dimension mismatch? (a glove.6B.300d.txt read with "
                f"dim={dim} parses zero lines)")
    out = np.zeros((len(words), dim), np.float32)
    for i, name in enumerate(words):
        vecs = []
        for p in name.split():
            v = glove.get(p)
            vecs.append(v if v is not None else _random_vector(p, dim))
        if not vecs:
            vecs = [np.zeros(dim, np.float32)]
        out[i] = np.mean(vecs, axis=0)
    out[0] = 0.0  # padding / background row stays zero
    return out


def coco_label_table(dim: int, glove_path: Optional[str] = None) -> np.ndarray:
    """(81, dim) label-embedding table: background + 80 COCO classes."""
    return vocab_table(COCO_CLASSES, dim, glove_path)


def resolve_glove_path(cfg, dim: Optional[int] = None) -> Optional[str]:
    """GloVe file for this config: explicit ``TEXT.GLOVE_PATH`` wins, else
    ``DATA_DIR/glove.6B.<dim>d.txt`` is discovered when present. Returns
    ``None`` (→ deterministic random fallback vectors) otherwise."""
    if cfg.TEXT.GLOVE_PATH:
        return cfg.TEXT.GLOVE_PATH
    dim = dim or cfg.TEXT.GLOVE_DIM
    candidate = os.path.join(cfg.DATA_DIR, f"glove.6B.{dim}d.txt")
    return candidate if os.path.exists(candidate) else None
