"""The feed's polygon fill in C++ (``rasterize.cc``), loaded with ctypes: the
port's counterpart of ``objgan_tpu/native``.

The library is compiled with g++ at first use, never at import, into
``objgan_tpu_torch/_build/libobjgan_native-<hash>.so``, the hash taken of
the source and the flags, so an edited source or a changed flag rebuilds;
it is written under a temporary name and renamed into place, so builders
in several processes at once are safe. ``data/feed.py::build_feed`` builds
it in the parent before any worker process starts. Where g++ fails, the
call raises with g++'s output: there is no fallback to the numpy fill
(``data/pipeline.py::_numpy_polygon_fill``, the plain version the tests
hold this one to, bit for bit). ``-ffp-contract=off`` keeps the compiler
from fusing a multiply and an add, which would round once where numpy
rounds twice.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "rasterize.cc"
# the kernels' build directory (ops/_build.py), which the worker feed's
# processes must not import: they load this library and no CUDA code
BUILD = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"libobjgan_native-{digest}.so"


def build() -> Path:
    """Compile ``rasterize.cc`` unless its library is already built; returns
    the library's path. Raises RuntimeError with g++'s output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name} (rc "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The polygon-fill library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.rasterize_polygon.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float)]
            lib.rasterize_polygon.restype = None
            lib.rasterize_polygons.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float)]
            lib.rasterize_polygons.restype = None
            _lib = lib
    return _lib


def _points(poly) -> np.ndarray:
    return np.ascontiguousarray(poly, np.float64).reshape(-1, 2)


def rasterize_polygon(poly: np.ndarray, size: int) -> np.ndarray:
    """poly (k, 2) float64 in [0,1] box-local coords -> (size, size)
    float32, 1.0 inside (even-odd at pixel centres)."""
    poly = _points(poly)
    out = np.empty((size, size), np.float32)
    load().rasterize_polygon(
        poly.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(poly.shape[0]), int(size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def rasterize_polygons(polys: Sequence[np.ndarray], size: int) -> np.ndarray:
    """List of (k_i, 2) arrays -> (n, size, size) float32, one C call."""
    if not len(polys):
        return np.zeros((0, size, size), np.float32)
    pts = [_points(p) for p in polys]
    flat = np.ascontiguousarray(np.concatenate(pts, axis=0))
    offsets = np.zeros((len(pts) + 1,), np.int64)
    np.cumsum([p.shape[0] for p in pts], out=offsets[1:])
    out = np.empty((len(pts), size, size), np.float32)
    load().rasterize_polygons(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(pts), int(size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
