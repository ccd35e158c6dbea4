"""Image output helpers: [-1, 1] floats to uint8, and a PNG writer.

The part of ``objgan_tpu/utils/visualize.py`` that serving and sampling
use (``_to_uint8``, ``save_png``), copied so that the port imports nothing
of the JAX package. ``tests/test_torch_data.py`` holds the two copies to
identical bytes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8."""
    return np.clip((np.asarray(img, np.float32) + 1.0) * 127.5, 0, 255).astype(
        np.uint8
    )


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
