"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds. The library lands in the package's
``_build/`` folder, keyed by a hash of the source, of every file of
``csrc/`` it includes (``#include "..."``, followed through the headers),
and of the full flag list, and is reused while none of them changes. A
source that includes CUTLASS or CuTe (``<cutlass/...>``, ``<cute/...>``)
gets ``-I`` of CUTLASS's headers when that folder exists. No ``nvcc``, or
a failed build, raises with the compiler's output: nothing falls back to
another path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CUTLASS_INCLUDE = "/usr/local/cutlass/include"
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)
_CUTLASS_INCLUDE = re.compile(rb"^\s*#\s*include\s*<(cutlass|cute)/", re.M)


@dataclasses.dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: str
    log: str         # nvcc and ptxas output; "" when the library existed
    seconds: float


_lock = threading.Lock()            # guards _locks
_locks: dict[str, threading.Lock] = {}
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


def sources(name: str) -> list[str]:
    """``csrc/<name>.cu`` and every file of ``csrc/`` it includes with
    ``#include "..."``, directly or through another such file, in the
    order first reached. An included name that is not in ``csrc/`` (a
    toolkit header) is left to the compiler."""
    order, todo = [], [os.path.join(CSRC, f"{name}.cu")]
    while todo:
        path = todo.pop(0)
        if path in order:
            continue
        order.append(path)
        with open(path, "rb") as f:
            text = f.read()
        for inc in _LOCAL_INCLUDE.findall(text):
            cand = os.path.normpath(os.path.join(os.path.dirname(path),
                                                 inc.decode()))
            if os.path.isfile(cand):
                todo.append(cand)
    return order


def flags(files: list[str]) -> list[str]:
    """The nvcc flags for a source and its includes: NVCC_FLAGS, plus
    ``-I`` CUTLASS's headers when one of the files includes CUTLASS or CuTe
    and that folder exists."""
    out = list(NVCC_FLAGS)
    if os.path.isdir(CUTLASS_INCLUDE):
        for path in files:
            with open(path, "rb") as f:
                if _CUTLASS_INCLUDE.search(f.read()):
                    return out + ["-I", CUTLASS_INCLUDE]
    return out


def build(name: str) -> Built:
    """Build (once per process) and load ``csrc/<name>.cu``. Two sources
    build at once from two threads; one source builds once."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _built:
            return _built[name]
        files = sources(name)
        src = files[0]
        cmd_flags = flags(files)
        key = hashlib.sha256(" ".join(cmd_flags).encode())
        for file in files:
            with open(file, "rb") as f:
                key.update(b"\0" + os.path.relpath(file, CSRC).encode()
                           + b"\0" + f.read())
        path = os.path.join(BUILD_DIR, f"lib{name}-{key.hexdigest()[:16]}.so")
        log = ""
        t0 = time.perf_counter()
        if not os.path.exists(path):
            nvcc = find_nvcc()
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                proc = subprocess.run([nvcc, *cmd_flags, "-o", tmp, src],
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


def current_stream(index: int) -> int:
    """The handle of device ``index``'s current CUDA stream, as an int for
    a C entry. The same value as
    ``torch.cuda.current_stream(index).cuda_stream``, read without making a
    Stream object (a few microseconds a launch on the host)."""
    return torch._C._cuda_getCurrentRawStream(index)
