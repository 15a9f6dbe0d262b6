"""Build and load the port's CUDA kernels.

``csrc/farneback_iter.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/kernels/`` at the repo
root (git-ignored), named by a hash of the source and flags so an edited
source rebuilds. The library loads with ``ctypes``; the wrappers pass
``tensor.data_ptr()`` and the current stream's handle as ``c_void_p``.

Only the repo's own source is compiled; there is no prebuilt artifact and
no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent
SOURCE = PKG_DIR / "csrc" / "farneback_iter.cu"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"

# -fmad=false keeps multiply and add as separate IEEE ops, as the reference
# evaluates them; the Farneback kernel relies on it for bit-exactness.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
BUILD_LOG = ""   # nvcc output of the last build (ptxas register report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "build from csrc/ at first use and need the CUDA toolkit")


def _build() -> Path:
    """Compile the source unless already built; returns the library path.
    Raises with the compiler's output if the build fails."""
    global BUILD_LOG
    h = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{SOURCE.stem}-{h.hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    BUILD_LOG = proc.stdout
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.farneback_iterate_fused.argtypes = [p, p, p, p, p, i, i, i,
                                                    i, i, f, i, p]
            lib.farneback_iterate_fused.restype = i
            lib.farneback_iterate_fused_info.argtypes = [i, i, i, p]
            lib.farneback_iterate_fused_info.restype = i
            _LIB = lib
        return _LIB


def build_seconds() -> float:
    """Build and load the kernel library; returns the seconds it took."""
    t0 = time.perf_counter()
    load()
    return time.perf_counter() - t0
