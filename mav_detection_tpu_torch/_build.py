"""Build and load the port's native libraries.

Seven sources, each compiled at first use into a shared library with a
plain C interface and loaded with ``ctypes``:

* ``"farneback_iter"``: ``csrc/farneback_iter.cu``, the solver iteration's
  CUDA kernels (``farneback_iterate_fused`` on row-streaming strips or on
  tiles), with ``nvcc`` for ``sm_90a`` into ``build/kernels/``. The
  wrappers pass ``tensor.data_ptr()`` and the current stream's handle as
  ``c_void_p``.
* ``"farneback_expand"``: ``csrc/farneback_expand.cu``, the polynomial
  expansion's band kernels (``ops/flow/farneback_expand.py``), the same way
  but with multiply-add contraction on (``NVCC_FMA_FLAGS``): the kernel is
  held to a tolerance, not bit for bit.
* ``"detect_rates"``: ``csrc/detect_rates.cu``, the detection step's
  per-frame rates (``ops/image/detect_rates.py``), the same way and with
  ``farneback_iter``'s flags (the rotational field rounds as the plain
  version's float32 operations do).
* ``"raft_lookup"``: ``csrc/raft_lookup.cu``, the published RAFT's all-pairs
  lookup (``models/raft_lookup.py``), the same way and with
  ``farneback_iter``'s flags (the taps round as the sampler's float32
  operations do).
* ``"shift_probes"``: ``csrc/shift_probes.cu``, the probe kernels of the
  warp's shifted reads (``ops/flow/shift_probes.py``), the same way and with
  ``farneback_iter``'s flags.
* ``"loader"``: ``runtime/native/loader.cpp``, the host ``.flo`` codec and
  prefetcher, with ``g++`` into ``build/native/``.
* ``"png"``: ``runtime/native/png.cpp``, the PNG row unfilter of
  ``data/dataset.py``'s decoder, with ``g++`` into ``build/native/``.

Both directories lie under ``build/`` at the repo root (git-ignored). A
library is named by a hash of its source and flags, so an edited source
rebuilds. ``build`` starts one compiler process per source that is not built
yet, all together, and then waits for them; ``load`` builds what it needs
(either flow kernel builds the whole Farneback main path, ``MAIN_PATH``, in
parallel, the RAFT lookup the rates beside it, ``RAFT_PATH``; the rates
alone build only themselves: ``BUILT_WITH``) and sets
the library's argtypes once.

Only the repo's own sources are compiled; there is no prebuilt artifact. A
missing compiler raises ``CompilerMissing``, a failed build ``RuntimeError``
(of which ``CompilerMissing`` is a subclass).

Every hand kernel is launched, checked and counted here too (the launch
seam): ``launch`` calls a kernel's C entry point on the current stream,
raises on its ``cudaError`` and counts it in ``LAUNCHES`` under the names
its module declares with ``counted``; ``check_tensor`` is the wrappers'
one tensor check, ``sm_count`` and ``MAX_SMEM_BYTES`` the card's limits,
and ``kernel_resources`` reads what a kernel's info entry point reports.
They import ``torch`` when called, so this module and the g++ libraries
stay free of it.

By hand: ``python -m mav_detection_tpu_torch._build [name ...]`` builds the
named libraries (all of them without names) and prints their paths.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parent
BUILD_ROOT = PKG_DIR.parent / "build"
SOURCE = PKG_DIR / "csrc" / "farneback_iter.cu"
BUILD_DIR = BUILD_ROOT / "kernels"

# -fmad=false keeps multiply and add as separate IEEE ops, as the reference
# evaluates them; the Farneback kernel relies on it for bit-exactness.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# the expansion's sums run in another order than the matmuls they replace,
# so it is held to a tolerance and may contract multiply and add
NVCC_FMA_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-fmad=false")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


class CompilerMissing(RuntimeError):
    """The compiler a source needs is not installed here."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise CompilerMissing(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "build from csrc/ at first use and need the CUDA toolkit")


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise CompilerMissing(
        "g++ not found on the PATH: the native .flo loader and PNG unfilter "
        "build from runtime/native/*.cpp at first use")


def _bind_kernels(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.farneback_iterate_fused.argtypes = [p, p, p, p, p, i, i, i, i, i, f,
                                            i, i, i, i, p]
    lib.farneback_iterate_fused.restype = i
    lib.farneback_iterate_fused_info.argtypes = [i, i, i, i, p]
    lib.farneback_iterate_fused_info.restype = i


def _bind_expand(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.farneback_expand_fused.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p, i, i,
                                           p, p, p, i, i, f, f, f, f, i, i, i, p]
    lib.farneback_expand_vertical.argtypes = [p, p, p, i, i, i, i, p, p, p, i, i, i, i,
                                              i, p]
    lib.farneback_expand_horizontal.argtypes = [p, p, p, i, i, i, i, p, p, p, i, i, f,
                                                f, f, f, i, i, p]
    for fn in (lib.farneback_expand_fused, lib.farneback_expand_vertical,
               lib.farneback_expand_horizontal):
        fn.restype = i
    lib.farneback_expand_smem.argtypes = [i, i, i, i]
    lib.farneback_expand_smem.restype = ctypes.c_longlong
    lib.farneback_expand_info.argtypes = [i, i, p]
    lib.farneback_expand_info.restype = i


def _bind_detect_rates(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.detect_rates_max.argtypes = [p, ll, p, ll, i, i, i, i, p, p]
    lib.detect_rates_count.argtypes = [p, ll, p, ll, p, ll, p, ll, p, ll, p, ll, p, p, i, i,
                                       i, i, i, p, p, p, p]
    lib.detect_rates_finish.argtypes = [p, p, i, i, i, i, p, p, p, p]
    for fn in (lib.detect_rates_max, lib.detect_rates_count, lib.detect_rates_finish):
        fn.restype = i


def _bind_raft_lookup(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.raft_lookup.argtypes = [p, p, p, p] + [i] * 9 + [p, i, i, i, i, p, p]
    lib.raft_lookup.restype = i
    lib.raft_lookup_info.argtypes = [p]
    lib.raft_lookup_info.restype = i


def _bind_shift_probes(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.shift_chain, lib.shift_gather):
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = i
    lib.y_stage.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.y_stage.restype = i
    lib.shift_probe_info.argtypes = [i, i, i, i, p]
    lib.shift_probe_info.restype = i


def _bind_loader(lib: ctypes.CDLL) -> None:
    import numpy as np

    i, p = ctypes.c_int, ctypes.c_void_p
    s = ctypes.c_char_p
    ip = ctypes.POINTER(ctypes.c_int)
    sp = ctypes.POINTER(ctypes.c_char_p)
    floats = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.flo_probe.argtypes = [s, ip, ip]
    lib.flo_probe.restype = i
    lib.flo_read.argtypes = [s, floats, i, i]
    lib.flo_read.restype = i
    lib.flo_write.argtypes = [s, floats, i, i]
    lib.flo_write.restype = i
    lib.flo_read_batch.argtypes = [sp, i, floats, i, i, i]
    lib.flo_read_batch.restype = i
    lib.prefetcher_create.argtypes = [sp, i, i, i, i, i]
    lib.prefetcher_create.restype = p
    lib.prefetcher_next.argtypes = [p, floats]
    lib.prefetcher_next.restype = i
    lib.prefetcher_inflight.argtypes = [p]
    lib.prefetcher_inflight.restype = i
    lib.prefetcher_destroy.argtypes = [p]
    lib.prefetcher_destroy.restype = None


def _bind_png(lib: ctypes.CDLL) -> None:
    import numpy as np

    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.png_unfilter.argtypes = [u8, u8, i64, i64, ctypes.c_int]
    lib.png_unfilter.restype = ctypes.c_int


class _Source(NamedTuple):
    path: Path
    compiler: Callable[[], str]
    flags: Tuple[str, ...]
    out_dir: Path
    bind: Callable[[ctypes.CDLL], None]


SOURCES: Dict[str, _Source] = {
    "farneback_iter": _Source(SOURCE, _nvcc, NVCC_FLAGS, BUILD_DIR,
                              _bind_kernels),
    "farneback_expand": _Source(PKG_DIR / "csrc" / "farneback_expand.cu", _nvcc,
                                NVCC_FMA_FLAGS, BUILD_DIR, _bind_expand),
    "detect_rates": _Source(PKG_DIR / "csrc" / "detect_rates.cu", _nvcc, NVCC_FLAGS,
                            BUILD_DIR, _bind_detect_rates),
    "raft_lookup": _Source(PKG_DIR / "csrc" / "raft_lookup.cu", _nvcc, NVCC_FLAGS,
                           BUILD_DIR, _bind_raft_lookup),
    "shift_probes": _Source(PKG_DIR / "csrc" / "shift_probes.cu", _nvcc,
                            NVCC_FLAGS, BUILD_DIR, _bind_shift_probes),
    "loader": _Source(PKG_DIR / "runtime" / "native" / "loader.cpp", _gxx,
                      GXX_FLAGS, BUILD_ROOT / "native", _bind_loader),
    "png": _Source(PKG_DIR / "runtime" / "native" / "png.cpp", _gxx, GXX_FLAGS,
                   BUILD_ROOT / "native", _bind_png),
}

# the Farneback main path's kernels: loading either flow kernel builds all
# three, in parallel; the published RAFT's path needs neither flow kernel:
# loading its lookup builds the rates beside it; loading the rates alone
# builds only the rates
MAIN_PATH = ("farneback_iter", "farneback_expand", "detect_rates")
RAFT_PATH = ("raft_lookup", "detect_rates")
BUILT_WITH: Dict[str, Tuple[str, ...]] = {"farneback_iter": MAIN_PATH,
                                          "farneback_expand": MAIN_PATH,
                                          "raft_lookup": RAFT_PATH}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# compiler output of the build of each source (for the kernels, the ptxas
# register report), kept beside its library so that a later process that
# finds the library built reads it too
BUILD_LOGS: Dict[str, str] = {}


def _target(src: _Source) -> Path:
    h = hashlib.sha1(src.path.read_bytes() + " ".join(src.flags).encode())
    return src.out_dir / f"lib{src.path.stem}-{h.hexdigest()[:12]}.so"


def _build_locked(names: Sequence[str]) -> Dict[str, Path]:
    targets = {n: _target(SOURCES[n]) for n in names}
    running = []
    for n, out in targets.items():
        if out.exists():
            if n not in BUILD_LOGS and out.with_suffix(".log").exists():
                BUILD_LOGS[n] = out.with_suffix(".log").read_text()
            continue
        src = SOURCES[n]
        compiler = src.compiler()
        src.out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        proc = subprocess.Popen(
            [compiler, *src.flags, "-o", str(tmp), str(src.path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((n, proc, tmp, out))
    failed = []
    for n, proc, tmp, out in running:
        BUILD_LOGS[n] = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{SOURCES[n].path.name}:\n{BUILD_LOGS[n]}")
        else:
            out.with_suffix(".log").write_text(BUILD_LOGS[n])
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    return targets


def raise_on(err: int, kernel: str) -> None:
    """Raise on a launch's nonzero ``cudaError`` return (the C interface of
    every CUDA library here returns one)."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def build(names: Optional[Sequence[str]] = None) -> Dict[str, Path]:
    """Compile every named source (all of them by default) that is not
    built yet, one compiler process each, started together; returns the
    libraries' paths. Raises with the compiler's output if a build fails."""
    with _LOCK:
        return _build_locked(list(SOURCES) if names is None else list(names))


def load(name: str = "farneback_iter") -> ctypes.CDLL:
    """The loaded library ``name``, built at first use."""
    with _LOCK:
        if name not in _LIBS:
            built = _build_locked(BUILT_WITH.get(name, (name,)))
            lib = ctypes.CDLL(str(built[name]))
            SOURCES[name].bind(lib)
            _LIBS[name] = lib
        return _LIBS[name]


# ------------------------------------------------------------ launch seam
# launches per kernel since the last ``reset_launches`` (plain ints; counted
# by ``launch``, nowhere else), one key per name a module declared
LAUNCHES: Dict[str, int] = {}

# dynamic shared memory one block may opt in to on the H100 (227 KB)
MAX_SMEM_BYTES = 232448

# what the kernels' info entry points write, in their order (the probes'
# ``shift_probe_info`` writes its own)
RESOURCES = ("smem_bytes", "registers", "blocks_per_sm", "local_bytes")


def counted(*kernels: str) -> Tuple[str, ...]:
    """Declare ``kernels`` (a module's ``KERNELS``) to the launch counter,
    at zero; returns them."""
    for k in kernels:
        LAUNCHES.setdefault(k, 0)
    return kernels


def reset_launches() -> None:
    """Zero every kernel's launch count."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch(library: str, kernel: str, device, *args, entry: Optional[str] = None) -> None:
    """Launch ``kernel`` of ``library``: its C entry point (``entry``, the
    kernel's name by default) with ``args`` and the current stream of
    ``device`` last. Raises on a nonzero ``cudaError``; counts the launch
    under ``kernel``, which ``counted`` must have declared."""
    import torch

    fn = getattr(load(library), entry or kernel)
    raise_on(fn(*args, torch.cuda.current_stream(device).cuda_stream), kernel)
    LAUNCHES[kernel] += 1


def check_tensor(name: str, t, shape=None, dtype=None) -> None:
    """ValueError unless ``t`` is a CUDA tensor of ``dtype`` (float32 by
    default) and, with ``shape``, a contiguous one of that shape (without
    it the caller takes the layout as it comes)."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    layout = "" if shape is None else "contiguous "
    if t.dtype != dtype or not t.is_cuda or (shape is not None and not t.is_contiguous()):
        raise ValueError(f"{name} must be a {layout}{dtype} CUDA tensor, got {t.dtype} "
                         f"on {t.device} (contiguous={t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


@functools.lru_cache(maxsize=None)
def sm_count(device_index: Optional[int]) -> int:
    """Multiprocessors of card ``device_index`` (the current card for
    None), read once."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


def kernel_resources(library: str, entry: str, *args,
                     keys: Sequence[str] = RESOURCES) -> Dict[str, int]:
    """The ints a kernel's info entry point (``entry`` of ``library``)
    writes for ``args`` into an out-array of ``len(keys)``, by name."""
    out = (ctypes.c_int * len(keys))()
    raise_on(getattr(load(library), entry)(*args, out), entry)
    return dict(zip(keys, out))


def build_seconds(names: Optional[Sequence[str]] = None) -> float:
    """Build (in parallel) and load the named libraries, all of them by
    default; returns the seconds it took."""
    t0 = time.perf_counter()
    names = list(SOURCES) if names is None else list(names)
    build(names)
    for n in names:
        load(n)
    return time.perf_counter() - t0


if __name__ == "__main__":
    for lib_name, lib_path in build(sys.argv[1:] or None).items():
        print(lib_name, lib_path)
