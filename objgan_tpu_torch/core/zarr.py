"""zarr v2 arrays out of a key-value store (``core/ocdbt.py``), as an Orbax
checkpoint writes its leaves: ``<name>/.zarray`` (JSON: ``shape``,
``chunks``, ``dtype``, ``order``, ``compressor``, ``fill_value``) beside
the chunks ``<name>/<i>.<j>...``.

* A chunk is zstd-compressed (``compressor: {"id": "zstd"}``: the second
  layer of zstd, under the store's own) or stored raw (``null``).
* A scalar has ``"chunks": []`` and the one chunk key ``0``.
* ``"dtype": "bfloat16"`` is no numpy dtype: it is read as ``<u2`` and
  viewed as ``torch.bfloat16`` (the host need not have ``ml_dtypes``).
* An absent chunk is ``fill_value``, unless the checkpoint says it wrote
  every chunk (``store_array_data_equal_to_fill_value``), when an absent
  chunk raises.
* Chunks are put together in C order; an edge chunk is cut to the array.
"""

from __future__ import annotations

import json
import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from objgan_tpu_torch.core import zstd

BFLOAT16 = "bfloat16"


class ZarrError(ValueError):
    """A zarr array that cannot be read: a bad ``.zarray``, a chunk of the
    wrong size, or a missing chunk where none may be missing."""


def _dtype(name: str) -> np.dtype:
    if name == BFLOAT16:
        return np.dtype("<u2")
    try:
        dt = np.dtype(name)
    except TypeError as e:
        raise ZarrError(f"zarr dtype {name!r} is not supported") from e
    if dt.kind not in "biuf" or dt.hasobject:
        raise ZarrError(f"zarr dtype {name!r} is not supported")
    return dt


def _fill(meta: dict, dt: np.dtype):
    value = meta.get("fill_value")
    if value is None:
        return 0
    if meta["dtype"] == BFLOAT16:
        f32 = np.array(float(value), np.float32).view(np.uint32)
        return int(f32 >> 16)
    if isinstance(value, str):  # "NaN", "Infinity", "-Infinity"
        return float(value)
    return value


def read_array(read: Callable[[str], Optional[bytes]], name: str,
               every_chunk_written: bool = False
               ) -> Union[np.ndarray, torch.Tensor]:
    """The zarr v2 array ``name`` of a store whose ``read(key)`` returns a
    value or None: a numpy array, or a bf16 ``torch.Tensor``."""
    raw = read(f"{name}/.zarray")
    if raw is None:
        raise ZarrError(f"no zarr array {name!r} (no {name}/.zarray)")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ZarrError(f"{name}: zarr format {meta.get('zarr_format')}")
    if meta.get("filters"):
        raise ZarrError(f"{name}: zarr filters are not supported")
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"]) or shape
    if len(chunks) != len(shape):
        raise ZarrError(f"{name}: chunks {chunks} for shape {shape}")
    order = meta.get("order", "C")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ZarrError(f"{name}: compressor {compressor.get('id')!r} is not "
                        "supported")
    dt = _dtype(meta["dtype"])
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta, dt), dt)
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks)) * dt.itemsize
    for index in np.ndindex(*grid):
        key = f"{name}/" + (sep.join(map(str, index)) if index else "0")
        data = read(key)
        if data is None:
            if every_chunk_written:
                raise ZarrError(f"{name}: chunk {key!r} is missing")
            continue
        if compressor is not None:
            try:
                data = zstd.decompress(data, chunk_bytes)
            except zstd.ZstdError as e:
                raise ZarrError(f"{name}: chunk {key!r}: {e}") from e
        if len(data) != chunk_bytes:
            raise ZarrError(f"{name}: chunk {key!r} holds {len(data)} bytes, "
                            f"expected {chunk_bytes}")
        block = np.frombuffer(data, dt).reshape(chunks, order=order)
        where = tuple(slice(i * c, min((i + 1) * c, s))
                      for i, c, s in zip(index, chunks, shape))
        out[where] = block[tuple(slice(0, w.stop - w.start) for w in where)]
    if meta["dtype"] == BFLOAT16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out.astype(dt.newbyteorder("="), copy=False)
