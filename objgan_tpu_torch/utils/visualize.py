"""Image output helpers: [-1, 1] floats to uint8, the attention grids
(``build_super_images``: word->region maps; ``build_object_images``: each
object's box and its most attended word) and a PNG writer.

A copy of ``objgan_tpu/utils/visualize.py`` (numpy only), so that the port
imports nothing of the JAX package. ``tests/test_torch_data.py`` holds the
two copies to identical bytes.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np


def _to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8."""
    return np.clip((np.asarray(img, np.float32) + 1.0) * 127.5, 0, 255).astype(
        np.uint8
    )


def _resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    yi = (np.arange(size) * h // size).clip(0, h - 1)
    xi = (np.arange(size) * w // size).clip(0, w - 1)
    return img[yi][:, xi]


def attention_overlay(
    image: np.ndarray,  # (S, S, 3) in [-1, 1]
    attn: np.ndarray,  # (h, w) one word's attention map
    alpha: float = 0.6,
) -> np.ndarray:
    """Overlay one attention map on an image (uint8 out)."""
    base = _to_uint8(image).astype(np.float32)
    a = np.asarray(attn, np.float32)
    a = (a - a.min()) / max(a.max() - a.min(), 1e-8)
    a = _resize_nearest(a[..., None], base.shape[0])[..., 0]
    heat = np.stack([a * 255, a * 64, (1 - a) * 160], axis=-1)
    out = (1 - alpha * a[..., None]) * base + alpha * a[..., None] * heat
    return np.clip(out, 0, 255).astype(np.uint8)


TEXT_STRIP_HEIGHT = 16


def _text_strip(text: str, width: int, height: int = TEXT_STRIP_HEIGHT,
                fill=(255, 255, 255)) -> np.ndarray:
    """(height, width, 3) uint8 black strip with ``text`` rendered in
    ``fill`` (PIL's built-in bitmap font; blank strip if PIL is
    unavailable)."""
    strip = np.zeros((height, width, 3), np.uint8)
    if not text:
        return strip
    try:
        from PIL import Image, ImageDraw

        im = Image.fromarray(strip)
        ImageDraw.Draw(im).text((2, 2), text, fill=tuple(fill))
        return np.asarray(im)
    except Exception:
        return strip


def build_super_images(
    images: np.ndarray,  # (B, S, S, 3) generated images in [-1, 1]
    attn_maps: np.ndarray,  # (B, h, w, T) grid attention
    captions: Optional[np.ndarray] = None,  # (B, T) token ids
    cap_lens: Optional[np.ndarray] = None,
    max_words: int = 8,
    max_rows: int = 8,
    ixtoword: Optional[dict] = None,
) -> np.ndarray:
    """One big uint8 grid: each row = [image | per-word attention overlays].

    With ``captions`` given, the attended word is rendered under each overlay
    (the lineage's ``build_super_images`` draws the word below each map —
    that is what makes the grid interpretable). ``ixtoword`` maps token id →
    word; ids missing from it (or with no mapping supplied) render as
    ``#<id>``. Without ``captions`` the layout is unchanged (no text strip).
    """
    b = min(images.shape[0], max_rows)
    t = min(attn_maps.shape[-1], max_words)
    size = images.shape[1]
    ixtoword = ixtoword or {}
    rows = []
    for i in range(b):
        cells = [_to_uint8(images[i])]
        n = int(cap_lens[i]) if cap_lens is not None else t
        for w in range(t):
            if w < n:
                cells.append(attention_overlay(images[i], attn_maps[i, :, :, w]))
            else:
                cells.append(np.zeros((size, size, 3), np.uint8))
        row = np.concatenate(cells, axis=1)
        if captions is not None:
            strips = [_text_strip("", size)]
            for w in range(t):
                word = ""
                if w < n:
                    tok = int(captions[i, w])
                    word = ixtoword.get(tok, f"#{tok}")
                strips.append(_text_strip(word, size))
            row = np.concatenate([row, np.concatenate(strips, axis=1)], axis=0)
        rows.append(row)
    return np.concatenate(rows, axis=0)


_BOX_COLORS = [
    (255, 80, 80), (80, 200, 255), (255, 220, 60), (140, 255, 120),
    (230, 120, 255), (255, 160, 60), (120, 140, 255), (255, 255, 255),
]


def _draw_box(img: np.ndarray, box: Sequence[float], color, width: int = 2
              ) -> None:
    """Draw a normalized (x0, y0, w, h) box outline in-place (uint8 HWC)."""
    s = img.shape[0]
    x0 = int(np.clip(box[0] * s, 0, s - 1))
    y0 = int(np.clip(box[1] * s, 0, s - 1))
    x1 = int(np.clip((box[0] + box[2]) * s, x0 + 1, s))
    y1 = int(np.clip((box[1] + box[3]) * s, y0 + 1, s))
    img[y0:y1, x0:min(x0 + width, s)] = color
    img[y0:y1, max(x1 - width, 0):x1] = color
    img[y0:min(y0 + width, s), x0:x1] = color
    img[max(y1 - width, 0):y1, x0:x1] = color


def build_object_images(
    images: np.ndarray,      # (B, S, S, 3) generated images in [-1, 1]
    boxes: np.ndarray,       # (B, O, 4) normalized (x0, y0, w, h)
    labels: np.ndarray,      # (B, O) class ids
    obj_valid: np.ndarray,   # (B, O) validity mask
    obj_attn: np.ndarray,    # (B, O, T) object->word attention (fp32)
    captions: Optional[np.ndarray] = None,  # (B, T) token ids
    cap_lens: Optional[np.ndarray] = None,
    ixtoword: Optional[dict] = None,
    class_names: Optional[Sequence[str]] = None,
    max_rows: int = 8,
) -> np.ndarray:
    """Object-driven-attention counterpart of :func:`build_super_images`.

    The lineage's grid visualizer shows word->region attention; Obj-GAN's
    second attention path is per-object over words (PAPER §3.3), so each row
    here is the generated image with every valid object's box outlined in a
    distinct color, followed by one text strip per object:
    ``<class>: <top attended word> (<weight>)`` in that object's color.
    """
    b = min(images.shape[0], max_rows)
    o = boxes.shape[1]
    size = images.shape[1]
    ixtoword = ixtoword or {}
    rows = []
    for i in range(b):
        img = _to_uint8(images[i]).copy()
        texts: List[tuple] = []
        n_words = int(cap_lens[i]) if cap_lens is not None else None
        for j in range(o):
            if not obj_valid[i, j]:
                continue
            color = _BOX_COLORS[j % len(_BOX_COLORS)]
            _draw_box(img, boxes[i, j], color)
            cid = int(labels[i, j])
            cname = (class_names[cid]
                     if class_names and 0 <= cid < len(class_names)
                     else f"class{cid}")
            att = np.asarray(obj_attn[i, j], np.float32)
            if n_words is not None:
                att = att[:n_words] if n_words else att * 0
            top = int(att.argmax()) if att.size else 0
            word = (ixtoword.get(int(captions[i, top]), f"#{int(captions[i, top])}")
                    if captions is not None else f"w{top}")
            texts.append((f"{cname}: {word} ({float(att[top]) if att.size else 0.0:.2f})",
                          color))
        row = [img]
        for text, color in texts:
            row.append(_text_strip(text, size, fill=color))
        rows.append(np.concatenate(row, axis=0))
    # rows have differing heights (variable object counts); pad to tallest
    hmax = max(r.shape[0] for r in rows)
    rows = [np.concatenate(
        [r, np.zeros((hmax - r.shape[0], size, 3), np.uint8)], axis=0)
        if r.shape[0] < hmax else r for r in rows]
    return np.concatenate(rows, axis=1)


def save_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 PNG (PIL if present, else minimal encoder)."""
    img = np.ascontiguousarray(img, np.uint8)
    try:
        from PIL import Image

        Image.fromarray(img).save(path)
        return
    except Exception:
        pass
    h, w = img.shape[:2]
    raw = b"".join(
        b"\x00" + img[y].tobytes() for y in range(h)
    )

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)
