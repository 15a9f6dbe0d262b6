"""ctypes bindings for the native loader: the ``.flo`` codec, a threaded
batch reader and the bounded in-order prefetcher
(``mav_detection_tpu.runtime.native_loader``).

``runtime/native/loader.cpp`` (a copy of the reference's, held equal by a
test) builds with ``g++`` at first use into ``build/native/`` (see
``_build.py``; by hand: ``python -m mav_detection_tpu_torch._build loader``).
Every function here raises when the library cannot be built. Callers that
have a numpy reader to fall back on ask ``available()`` first, which says
once, at INFO, which reader a process uses.
"""
from __future__ import annotations

import ctypes
import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mav_detection_tpu_torch import _build

_LOG = logging.getLogger("mav_detection_tpu_torch.runtime")
_AVAILABLE: Optional[bool] = None


def _load() -> ctypes.CDLL:
    return _build.load("loader")


def available() -> bool:
    """Whether the native library can be built and loaded here. The first
    call tries, and logs the outcome once at INFO: the native reader, or the
    numpy reader with the reason."""
    global _AVAILABLE
    if _AVAILABLE is None:
        try:
            _load()
        except (RuntimeError, OSError) as e:
            _AVAILABLE = False
            _LOG.info(f".flo files are read with numpy: the native loader "
                      f"is unavailable ({e})")
        else:
            _AVAILABLE = True
            _LOG.info(".flo files are read with the native loader")
    return _AVAILABLE


def _c_paths(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def probe(path: str) -> Tuple[int, int]:
    """(width, height) from the header of a ``.flo`` file."""
    lib = _load()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.flo_probe(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"flo_probe failed ({rc}) for {path}")
    return w.value, h.value


def read_flow(path: str) -> np.ndarray:
    lib = _load()
    w, h = probe(path)
    out = np.empty((h, w, 2), np.float32)
    rc = lib.flo_read(path.encode(), out.reshape(-1), w, h)
    if rc != 0:
        raise IOError(f"flo_read failed ({rc}) for {path}")
    return out


def write_flow(path: str, flow: np.ndarray) -> None:
    lib = _load()
    flow = np.ascontiguousarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"expected (h, w, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    rc = lib.flo_write(path.encode(), flow.reshape(-1), w, h)
    if rc != 0:
        raise IOError(f"flo_write failed ({rc}) for {path}")


def read_flow_batch(paths: List[str], n_threads: int = 4) -> np.ndarray:
    """Read same-shaped ``.flo`` files into (n, h, w, 2) on ``n_threads``
    native threads; a missing, corrupt, truncated or differently shaped file
    raises."""
    if not paths:
        return np.zeros((0, 0, 0, 2), np.float32)
    lib = _load()
    w, h = probe(paths[0])
    out = np.empty((len(paths), h, w, 2), np.float32)
    ok = lib.flo_read_batch(_c_paths(paths), len(paths), out.reshape(-1),
                            w, h, n_threads)
    if ok != len(paths):
        raise IOError(f"flo_read_batch: {len(paths) - ok} files failed")
    return out


class FloPrefetcher:
    """In-order ``.flo`` reader on native background threads, at most
    ``depth`` files claimed ahead of the consumer. Iterate it, or call
    ``next``; ``close`` joins the threads."""

    def __init__(self, paths: Sequence[str], depth: int = 4,
                 n_threads: int = 2) -> None:
        self._handle = None
        self._lib = _load()
        if not paths:
            raise ValueError("no paths")
        self._w, self._h = probe(paths[0])
        self._n = len(paths)
        self._keepalive = _c_paths(paths)
        self._handle = self._lib.prefetcher_create(
            self._keepalive, self._n, self._w, self._h, depth, n_threads)
        self._delivered = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is None or self._delivered >= self._n:
            raise StopIteration
        out = np.empty((self._h, self._w, 2), np.float32)
        idx = self._lib.prefetcher_next(self._handle, out.reshape(-1))
        if idx == -1:
            raise StopIteration
        if idx < -1:  # (-2 - index): that file failed to read
            bad = -2 - idx
            raise IOError(
                f"prefetcher: failed to read .flo file #{bad} "
                f"(missing/corrupt/truncated/mismatched dimensions)")
        self._delivered += 1
        return out

    def inflight(self) -> int:
        """Claimed-but-unconsumed count; bounded by the ``depth`` argument."""
        if self._handle is None:
            return 0
        return int(self._lib.prefetcher_inflight(self._handle))

    def close(self) -> None:
        if self._handle:
            self._lib.prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
