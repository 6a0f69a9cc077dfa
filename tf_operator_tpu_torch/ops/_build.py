"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes``. The build runs
at first use into ``build/torch_kernels/`` at the root of the checkout,
keyed on a hash of the source, every ``csrc/*.cuh`` header and the flags,
so an edited source or header rebuilds. The libraries link libcuda
(``-lcuda``) for the TMA tensor-map encoder. A missing or failing
``nvcc`` raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# After the source, so the linker keeps the library that the object needs.
LINK_FLAGS = ("-lcuda",)
# Toolkit roots searched after PATH, $CUDA_HOME and $CUDA_PATH.
NVCC_ROOTS = ("/usr/local/cuda",)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# nvcc's stderr per built library (ptxas register/shared-memory report).
build_logs: dict[str, str] = {}


class KernelBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME/bin or /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 *NVCC_ROOTS):
        if root:
            cand = Path(root) / "bin" / "nvcc"
            if cand.is_file() and os.access(cand, os.X_OK):
                return str(cand)
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built, and nothing falls back to a plain "
        "version on a CUDA tensor")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    every header beside it and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hash-keyed library exists."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"), *LINK_FLAGS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_logs[name] = proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}) for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
