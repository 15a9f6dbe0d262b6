"""Middlebury ``.flo`` optical-flow file IO (numpy codec).

Format: float32 magic ``202021.25``, int32 width, int32 height, then
``h*w*2`` float32s interleaved ``u,v`` — the same contract as
``mav_detection_tpu.core.flo``. Single files are read with numpy; batches
with the native threaded reader (``runtime/native_loader.py``) where its
library can be built, else sequentially with numpy.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

TAG_FLOAT = 202021.25


def read_flow(filename: str) -> np.ndarray:
    """Read a ``.flo`` file into an ``(h, w, 2)`` float32 array."""
    with open(filename, "rb") as f:
        head = np.fromfile(f, np.float32, count=1)
        if head.size == 0:
            raise ValueError(f"Empty/truncated .flo file: {filename}")
        magic = head[0]
        if magic != TAG_FLOAT:
            raise ValueError(f"Flow number {magic!r} incorrect. Invalid .flo file: {filename}")
        dims = np.fromfile(f, np.int32, count=2)
        if dims.size != 2:
            raise ValueError(f"Empty/truncated .flo file: {filename}")
        w, h = int(dims[0]), int(dims[1])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    if data.size != 2 * w * h:
        # truncated trailing bytes: pad like the reference reader
        data = np.resize(data, 2 * w * h)
    return data.reshape(h, w, 2)


def write_flow(filename: str, uv: np.ndarray) -> None:
    """Write an ``(h, w, 2)`` flow field to a ``.flo`` file."""
    uv = np.asarray(uv)
    if uv.ndim != 3 or uv.shape[2] != 2:
        raise ValueError(f"expected (h, w, 2), got {uv.shape}")
    height, width = uv.shape[:2]
    with open(filename, "wb") as f:
        np.array([TAG_FLOAT], np.float32).tofile(f)
        np.array(width, np.int32).tofile(f)
        np.array(height, np.int32).tofile(f)
        uv.astype(np.float32).reshape(height, width * 2).tofile(f)


def read_flow_batch(filenames: Sequence[str]) -> np.ndarray:
    """Read many same-shaped ``.flo`` files into an ``(n, h, w, 2)`` array:
    with the native loader where it is available (which of the two readers a
    process uses is logged once, at INFO), else file by file with numpy. The
    native reader raises on a truncated file; the numpy one pads it."""
    from mav_detection_tpu_torch.runtime import native_loader

    if native_loader.available():
        return native_loader.read_flow_batch(list(filenames))
    if not filenames:
        return np.zeros((0, 0, 0, 2), np.float32)
    first = read_flow(filenames[0])
    out = np.empty((len(filenames),) + first.shape, np.float32)
    out[0] = first
    for i, name in enumerate(filenames[1:], start=1):
        out[i] = read_flow(name)
    return out


def flow_exists(directory: str, pattern: str = "%06d.flo", count: int = 1) -> bool:
    """Idempotent artifact check used by dataset preprocessing."""
    return all(os.path.exists(os.path.join(directory, pattern % i)) for i in range(count))
