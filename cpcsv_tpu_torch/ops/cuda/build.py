"""Builds the port's CUDA kernels with `nvcc` and loads them with `ctypes`.

Each source `cpcsv_tpu_torch/csrc/<name>.cu` (SOURCES: `dfn`, `bn`) exposes a
plain C interface and becomes `build/kernels/lib<name>-<hash>.so` at the root
of the checkout, the hash being that of the source, so an edited source is
rebuilt and a built one is reused. Builds happen at first CUDA use, never at
import, one nvcc process per source.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = "arch=compute_90a,code=sm_90a"
SOURCES = ("dfn", "bn")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of cpcsv_tpu_torch need the CUDA toolkit")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless it is built already. Returns nvcc's
    output (register and shared-memory use), empty when nothing was built."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build of {name} failed (nvcc exited "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        if name not in _loaded:
            build(name)
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]
