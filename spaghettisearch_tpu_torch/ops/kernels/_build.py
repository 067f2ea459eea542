"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each kernel source compiles with nvcc into a shared library with a plain C
interface, loaded through ctypes. The build happens at first use, under a
per-library lock (so several libraries can build at once from threads),
into a content-hashed directory under `build/kernels/` at the root of
the checkout (git-ignored): a changed source or flag builds a new library,
an unchanged one is reused. Only the sources in this package are compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass

CSRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "csrc",
)
BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(CSRC_DIR)), "build", "kernels"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_lock = threading.Lock()  # guards _locks
_locks: dict[str, threading.Lock] = {}
_built: dict[str, "KernelLibrary"] = {}


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: str
    log: str  # nvcc/ptxas output of the build (registers, smem, spills)
    seconds: float  # build time, 0.0 when reused


def nvcc_path() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def load_library(name: str) -> KernelLibrary:
    """Compile csrc/<name>.cu (+ the shared headers) once and load it."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _built:
            return _built[name]
        import time

        src = os.path.join(CSRC_DIR, f"{name}.cu")
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for fn in sorted(os.listdir(CSRC_DIR)):
            if fn == f"{name}.cu" or fn.endswith(".cuh"):
                with open(os.path.join(CSRC_DIR, fn), "rb") as f:
                    h.update(fn.encode() + f.read())
        out_dir = os.path.join(BUILD_ROOT, f"{name}-{h.hexdigest()[:16]}")
        so = os.path.join(out_dir, f"lib{name}.so")
        log_path = os.path.join(out_dir, "build.log")
        seconds = 0.0
        if not os.path.exists(so):
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, src],
                capture_output=True, text=True, timeout=600,
            )
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{log}")
            with open(log_path, "w", encoding="utf-8") as f:
                f.write(log)
            os.replace(tmp, so)
        with open(log_path, encoding="utf-8") as f:
            log = f.read()
        built = KernelLibrary(ctypes.CDLL(so), so, log, seconds)
        _built[name] = built
        return built
