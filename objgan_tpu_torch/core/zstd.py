"""zstd decompression with nothing installed: the system ``libzstd.so.1``
through ctypes. An Orbax checkpoint is zstd twice over
(``core/ocdbt.py``'s nodes, ``core/zarr.py``'s chunks); the host of the
port need not have the ``zstandard`` package, and Python 3.12 has no zstd
module. The GPU host and the CPU hosts the port is tested on have the
library; a host without it gets a RuntimeError that names it.

``decompress(data, size_hint=None)`` decodes every frame of ``data``
(skippable frames are skipped). A frame whose header does not give its
content size (tensorstore writes such frames) still decodes: the buffer
grows from ``size_hint`` until the data fits. ``version()`` names the
library, as "libzstd 1.5.4".
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Optional

_UNKNOWN = (1 << 64) - 1
_ERROR = (1 << 64) - 2


class ZstdError(ValueError):
    """Malformed or truncated zstd data."""


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    for name in (ctypes.util.find_library("zstd"), "libzstd.so.1"):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_versionString.restype = ctypes.c_char_p
        lib.ZSTD_versionString.argtypes = []
        return lib
    raise RuntimeError("reading an Orbax checkpoint needs the system zstd "
                       "library (libzstd.so.1), which this host lacks: "
                       "install it (Debian/Ubuntu: libzstd1)")


def version() -> str:
    """The library's name and version, as "libzstd 1.5.4"."""
    return f"libzstd {_lib().ZSTD_versionString().decode()}"


def decompress(data: bytes, size_hint: Optional[int] = None) -> bytes:
    """Every frame of ``data`` decoded, concatenated. ``size_hint``: the
    expected decoded size, where the caller knows it (a zarr chunk's).
    Raises ZstdError for bad data, RuntimeError without the library."""
    lib = _lib()
    data = bytes(data)
    if not data:
        raise ZstdError("empty input: no zstd frame")
    src = ctypes.c_char_p(data)
    size = lib.ZSTD_getFrameContentSize(src, len(data))
    if size == _ERROR:
        raise ZstdError("not a zstd frame (bad magic or header)")
    # the first frame's size, when its header gives one; more frames after
    # it make the buffer too small, and it grows
    cap = size if size != _UNKNOWN else max(size_hint or 0, 4 * len(data),
                                             1 << 16)
    while True:
        dst = ctypes.create_string_buffer(max(cap, 1))
        n = lib.ZSTD_decompress(dst, cap, src, len(data))
        if not lib.ZSTD_isError(n):
            return dst.raw[:n]
        err = lib.ZSTD_getErrorName(n).decode()
        if "too small" not in err or cap >= 1 << 34:
            raise ZstdError(f"libzstd: {err}")
        cap = max(2 * cap, 1 << 16)
