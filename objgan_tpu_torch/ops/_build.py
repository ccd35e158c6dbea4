"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for ``sm_90a`` into ``objgan_tpu_torch/_build/lib<name>-<hash>.so`` (the hash
is of the source, so an edited source rebuilds) and loaded with ``ctypes``.
Nothing here runs at import: the CPU tests import every module, and a CPU
host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels are "
            "built on a host with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def build(name: str, force: bool = False) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Returns (library path, compiler log: ptxas register/spill report)."""
    out = library_path(name)
    if out.exists() and not force:
        return out, ""
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {name}.cu (rc {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The kernel library for ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path, _ = build(name)
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib
