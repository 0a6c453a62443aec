"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds. The library lands in the package's
``_build/`` folder, keyed by a hash of the source and the flags, and is
reused while neither changes. No ``nvcc``, or a failed build, raises with
the compiler's output: nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: str
    log: str         # nvcc and ptxas output; "" when the library existed
    seconds: float


_lock = threading.Lock()
_built: dict[str, Built] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else the
    ``nvcc`` on ``PATH``; raise if there is neither."""
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.access(cand, os.X_OK):
        return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        f"nvcc not found ({cand} is missing and PATH has none): the port's "
        "CUDA kernels are built from csrc/ at first use and need the CUDA "
        "toolkit")


def build(name: str) -> Built:
    """Build (once per process) and load ``csrc/<name>.cu``."""
    with _lock:
        if name in _built:
            return _built[name]
        src = os.path.join(CSRC, f"{name}.cu")
        with open(src, "rb") as f:
            key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
        path = os.path.join(BUILD_DIR, f"lib{name}-{key.hexdigest()[:16]}.so")
        log = ""
        t0 = time.perf_counter()
        if not os.path.exists(path):
            nvcc = find_nvcc()
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                                      capture_output=True, text=True)
                log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed to build {src} (exit "
                        f"{proc.returncode}):\n{log}")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        built = Built(ctypes.CDLL(path), path, log, time.perf_counter() - t0)
        _built[name] = built
        return built
