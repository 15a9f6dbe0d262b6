"""The Farneback polynomial expansion of a pyramid layer as a band kernel:
its bands, the launch plan and the CUDA wrapper.

Replaces no TPU kernel: the reference computes the layer's smooth, resize
and moment correlations as two dense matmuls left to XLA's dot
(``mav_detection_tpu/ops/flow/farneback.py::_poly_exp_pyr_cf``), and
``farneback.poly_exp_pyr_cf`` keeps those matmuls as the plain version that
runs on CPU tensors. On the card the dense (3lh, h) and (w, 3lw) matrices
multiply zeros almost everywhere: each output's products are non-zero over
a band of 19 taps at scale 1, 38 at 1/2 and 80 at 1/4. This module takes
the same float32 matrices apart into bands (``compact_band``: per output
its first input and its taps, padded to the layer's widest band) and lays
them out in groups of four outputs for ``csrc/farneback_expand.cu``
(``group_band``), which multiplies only the bands' taps.

``plan`` picks the launches from the layer's shape by one rule: one fused
launch per layer (both frames of every pair, t kept in shared memory) on the
widest column tile whose block fits two an SM, else two launches (the
vertical stage into a buffer in device memory, then the horizontal stage),
each on its widest such tile. A block's shared memory is the CUDA source's
own count (``farneback_expand_smem``). The bound is ``expand_bound``: each
frame read once and its five planes written once, against the function's
least operations at the fp32 rate (the cascade of smooth, resize and
moments, fewer than the bands' multiply-adds).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mav_detection_tpu_torch import _build

KERNELS = _build.counted("farneback_expand_fused", "farneback_expand_vertical",
                         "farneback_expand_horizontal")

THREADS = 256          # kThreads in the CUDA source
GROUP = 4              # outputs per band group (kGroup)
ROWS = 16              # output rows of a fused or horizontal tile (kRows)
VERTICAL_ROWS = 32     # output rows of a vertical tile
# the column tiles, narrowest first: the plan takes the widest that fits
# two blocks an SM (wider tiles ran slower on the finest layers, PERF.md)
COLS = (32, 64, 96, 128, 160, 192)
# two blocks an SM: 228 KB of shared memory an SM, 1 KB of it per block
# reserved by the runtime
TWO_BLOCKS_SMEM = 228 * 1024 // 2 - 1024


# ------------------------------------------------------------------ bands
def compact_band(M: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(start, taps) of a banded (n, m) matrix: for each row its first
    non-zero column (moved left where the band would pass column m) and the
    row's entries from there, K of them, K the widest row's span from its
    first to its last non-zero entry."""
    nz = M != 0
    m = M.shape[1]
    first = np.where(nz.any(1), nz.argmax(1), 0)
    last = np.where(nz.any(1), m - 1 - nz[:, ::-1].argmax(1), 0)
    K = int((last - first + 1).max())
    start = np.minimum(first, m - K).astype(np.int32)
    cols = start[:, None] + np.arange(K)[None, :]
    taps = np.take_along_axis(M, cols, axis=1).astype(np.float32)
    return start, taps


def group_band(start: np.ndarray, taps: np.ndarray, m: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's layout of a compact band of 3 n rows (the g, xg and xxg
    blocks of n outputs each): per group of GROUP outputs one first input
    ``base`` (ng,) and, per tap step u < U, the taps of its outputs' three
    moments as [output][moment], zero where a band does not reach: group g's
    are ``table[index[g]]``, the table (nu, U, GROUP x 3) holding each
    distinct group once. U is the widest group's span; a group's base is
    moved left where its U inputs would pass input m - 1. Bases must not
    decrease from group to group (the kernel's windows rely on it)."""
    n = len(start) // 3
    K = taps.shape[1]
    s = start.reshape(3, n).astype(np.int64)
    lo, hi = s.min(0), s.max(0) + K
    if np.any(np.diff(lo) < 0):
        raise ValueError("band starts decrease: the kernel's windows need "
                         "them non-decreasing")
    heads = np.arange(0, n, GROUP)
    lo_g = np.minimum.reduceat(lo, heads)
    U = int((np.maximum.reduceat(hi, heads) - lo_g).max())
    base = np.minimum(lo_g, m - U)
    out = np.zeros((len(heads), U, GROUP, 3), np.float32)
    for k in range(3):
        for i in range(n):
            d = s[k, i] - base[i // GROUP]
            out[i // GROUP, d:d + K, i % GROUP, k] = taps[k * n + i]
    table, index = np.unique(out.reshape(len(heads), U * GROUP * 3), axis=0,
                             return_inverse=True)
    return (base.astype(np.int32), index.reshape(-1).astype(np.int32),
            table.reshape(-1, U, GROUP * 3))



class Bands(NamedTuple):
    """A layer's bands in the kernel's layout (``group_band``) and the
    widths of the compact bands they came from."""
    vbase: np.ndarray    # (ceil(lh / 4),) int32
    vidx: np.ndarray     # (ceil(lh / 4),) int32, into vtaps
    vtaps: np.ndarray    # (distinct groups, UV, 12) float32
    hbase: np.ndarray    # (ceil(lw / 4),) int32
    hidx: np.ndarray     # (ceil(lw / 4),) int32, into htaps
    htaps: np.ndarray    # (distinct groups, UH, 12) float32
    Kv: int
    Kh: int


def bands_from_dense(V: np.ndarray, Hm: np.ndarray) -> Bands:
    """The bands of ``_poly_pyr_mats_np``'s V (3lh, h) and Hm (w, 3lw)."""
    sv, tv = compact_band(V)
    sh, th = compact_band(Hm.T)
    return Bands(*group_band(sv, tv, V.shape[1]), *group_band(sh, th, Hm.shape[0]),
                 tv.shape[1], th.shape[1])


# ------------------------------------------------------------------- plan
def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _window(base: np.ndarray, U: int, groups: int) -> int:
    """The largest span of inputs that a tile of ``groups`` groups reads."""
    heads = np.arange(0, len(base), groups)
    tails = np.minimum(heads + groups, len(base)) - 1
    return int((base[tails].astype(np.int64) + U - base[heads]).max())


class Launch(NamedTuple):
    """One launch of a layer: the kernel, its tile (rows, columns: output
    columns, input columns for the vertical stage), the largest window of
    any tile (rows, columns; 0 where the kernel has none), shared-memory
    bytes a block, blocks."""
    kernel: str
    th: int
    tw: int
    wr: int
    wc: int
    smem: int
    blocks: int


# smem(kind, tw, wr, wc): a block's shared-memory bytes, the CUDA source's
# farneback_expand_smem (kind: the index in KERNELS)
SmemFn = Callable[[int, int, int, int], int]


def _card_smem(kind: int, tw: int, wr: int, wc: int) -> int:
    return int(_build.load("farneback_expand").farneback_expand_smem(kind, tw, wr, wc))


def _fused(b: Bands, frames: int, lh: int, lw: int, tw: int, smem: SmemFn) -> Launch:
    UV, UH = b.vtaps.shape[1], b.htaps.shape[1]
    wr, wc = _window(b.vbase, UV, ROWS // GROUP), _window(b.hbase, UH, tw // GROUP)
    return Launch(KERNELS[0], ROWS, tw, wr, wc, smem(0, tw, wr, wc),
                  frames * _cdiv(lh, ROWS) * _cdiv(lw, tw))


def _vertical(b: Bands, frames: int, lh: int, w: int, th: int, tw: int,
              smem: SmemFn) -> Launch:
    wr = _window(b.vbase, b.vtaps.shape[1], th // GROUP)
    return Launch(KERNELS[1], th, tw, wr, 0, smem(1, tw, wr, 0),
                  frames * _cdiv(lh, th) * _cdiv(w, tw))


def _horizontal(b: Bands, frames: int, lh: int, lw: int, tw: int, smem: SmemFn) -> Launch:
    wc = _window(b.hbase, b.htaps.shape[1], tw // GROUP)
    return Launch(KERNELS[2], ROWS, tw, 0, wc, smem(2, tw, 0, wc),
                  frames * _cdiv(lh, ROWS) * _cdiv(lw, tw))


def _widest(launches, limit: int) -> Optional[Launch]:
    fits = [k for k in launches if k.smem <= limit]
    return fits[-1] if fits else None


def plan(b: Bands, frames: int, h: int, w: int, lh: int, lw: int,
         smem: Optional[SmemFn] = None) -> Tuple[Launch, ...]:
    """The launches of one layer for ``frames`` frames, by one rule: the
    fused kernel on the widest of ``COLS`` whose block fits two an SM;
    where none does (a tile's input window is too large: the coarse layers'
    80-tap bands), the vertical launch (tiles of ``VERTICAL_ROWS`` rows) and
    the horizontal one, each on the widest of ``COLS`` whose block fits two
    an SM, else one. ``smem`` gives a block's bytes (by default the CUDA
    source's, on the card). Raises ValueError where no tile fits."""
    smem = smem or _card_smem
    fused = _widest([_fused(b, frames, lh, lw, tw, smem) for tw in COLS], TWO_BLOCKS_SMEM)
    if fused is not None:
        return (fused,)
    vertical = [_vertical(b, frames, lh, w, VERTICAL_ROWS, tw, smem) for tw in COLS]
    horizontal = [_horizontal(b, frames, lh, lw, tw, smem) for tw in COLS]
    v = _widest(vertical, TWO_BLOCKS_SMEM) or _widest(vertical, _build.MAX_SMEM_BYTES)
    hz = _widest(horizontal, TWO_BLOCKS_SMEM) or _widest(horizontal, _build.MAX_SMEM_BYTES)
    if v is None or hz is None:
        raise ValueError(f"layer {lh}x{lw} of {h}x{w}: bands of {b.vtaps.shape[1]} "
                         f"x {b.htaps.shape[1]} taps fit no block's shared memory")
    return v, hz


# ------------------------------------------------------------------ bound
def expand_bytes(frames: int, h: int, w: int, lh: int, lw: int) -> int:
    """Bytes the layer's expansion must move: each frame read once, its
    five coefficient planes written once (the bands' few KB not counted)."""
    return 4 * frames * (h * w + 5 * lh * lw)


def expand_ops(frames: int, h: int, w: int, lh: int, lw: int,
               taps: Tuple[int, int, int, int]) -> int:
    """fp32 operations of the expansion's least work (a multiply-add is
    two): the cascade of the composed matrices' factors, with ``taps`` = (ks,
    kv, kh, km) the smooth's taps, the vertical and horizontal resize's
    (0 where the size does not change) and the moments'. Per frame: the
    vertical smooth over h x w and resize to lh x w, the horizontal smooth
    over lh x w and resize to lh x lw, then at the layer's size the three
    vertical moments and the six horizontal products. The band kernel
    multiplies the composed bands instead (3 lh w Kv + 6 lh lw Kh): 1.1x
    this at scale 1, 2.5x at 1/2 and 3.9x at 1/4 on the product's layers."""
    ks, kv, kh, km = taps
    return 2 * frames * (h * w * ks + lh * w * (kv + ks) + lh * lw * (kh + 9 * km))


def expand_bound(frames: int, h: int, w: int, lh: int, lw: int,
                 taps: Tuple[int, int, int, int]):
    """(least ms on the H100, "bytes" or "operations")."""
    from mav_detection_tpu_torch.utils.timing import bound_ms

    return bound_ms(expand_bytes(frames, h, w, lh, lw),
                    expand_ops(frames, h, w, lh, lw, taps))


# ---------------------------------------------------------------- wrapper
class DeviceBands(NamedTuple):
    """``Bands`` on the card, as the kernel reads them."""
    vbase: torch.Tensor
    vidx: torch.Tensor
    vtaps: torch.Tensor
    hbase: torch.Tensor
    hidx: torch.Tensor
    htaps: torch.Tensor


def to_device(b: Bands, device: torch.device) -> DeviceBands:
    return DeviceBands(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                         for a in b[:6]))


def expand_cuda(prev: torch.Tensor, curr: torch.Tensor, R0: torch.Tensor,
                R1: torch.Tensor, bands: DeviceBands, launches: Tuple[Launch, ...],
                ig: Tuple[float, float, float, float]) -> None:
    """Expand ``prev`` and ``curr`` (b, h, w) into ``R0`` and ``R1`` (b, 5,
    lh, lw) in the same launches, with the ``plan`` for these shapes
    (``launches``) and the inverse moments ig = (ig11, ig03, ig33, ig55)."""
    b, h, w = prev.shape
    lh, lw = R0.shape[2], R0.shape[3]
    _build.check_tensor("prev", prev, (b, h, w))
    _build.check_tensor("curr", curr, (b, h, w))
    _build.check_tensor("R0", R0, (b, 5, lh, lw))
    _build.check_tensor("R1", R1, (b, 5, lh, lw))
    ngv, ngh = _cdiv(lh, GROUP), _cdiv(lw, GROUP)
    for name, n in (("v", ngv), ("h", ngh)):
        _build.check_tensor(name + "base", getattr(bands, name + "base"), (n,), torch.int32)
        _build.check_tensor(name + "idx", getattr(bands, name + "idx"), (n,), torch.int32)
        taps = getattr(bands, name + "taps")
        _build.check_tensor(name + "taps", taps, (taps.shape[0], taps.shape[1], 3 * GROUP))
    UV, UH = bands.vtaps.shape[1], bands.htaps.shape[1]
    dev = prev.device
    p = lambda t: t.data_ptr()  # noqa: E731
    f = [ctypes.c_float(v) for v in ig]
    if len(launches) == 1:
        (k,) = launches
        _build.launch("farneback_expand", KERNELS[0], dev,
                      p(prev), p(curr), p(R0), p(R1), b, h, w, lh, lw, p(bands.vbase),
                      p(bands.vidx), p(bands.vtaps), ngv, UV, p(bands.hbase), p(bands.hidx),
                      p(bands.htaps), ngh, UH, *f, k.tw, k.wr, k.wc)
        return
    v, hz = launches
    t = torch.empty((2 * b, 3, lh, w), dtype=torch.float32, device=dev)
    _build.launch("farneback_expand", KERNELS[1], dev,
                  p(prev), p(curr), p(t), b, h, w, lh, p(bands.vbase), p(bands.vidx),
                  p(bands.vtaps), ngv, UV, v.th, v.tw, v.wr)
    _build.launch("farneback_expand", KERNELS[2], dev,
                  p(t), p(R0), p(R1), b, w, lh, lw, p(bands.hbase), p(bands.hidx),
                  p(bands.htaps), ngh, UH, *f, hz.tw, hz.wc)


def kernel_info(launch: Launch) -> Dict[str, int]:
    """Launch resources of ``launch``'s kernel on the current card:
    shared-memory bytes a block, registers per thread, blocks per SM,
    local-memory bytes per thread."""
    return _build.kernel_resources("farneback_expand", "farneback_expand_info",
                                   KERNELS.index(launch.kernel), launch.smem)
