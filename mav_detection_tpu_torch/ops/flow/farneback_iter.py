"""The Farneback solver iteration: its CUDA kernels, the plain PyTorch
version, and the launch counters.

Replaces ``mav_detection_tpu/ops/flow/farneback_pallas.py::
farneback_iterate_pallas`` (the reference's only TPU kernel). One iteration
is one launch of ``farneback_iterate_fused`` (``csrc/farneback_iter.cu``):
warp R1 by the current flow, form the five normal-equation planes M, take
their (2m+1)^2 box mean with replicate edges and solve the 2x2 system, M
kept in shared memory and registers throughout, the new flow written to the
other of two buffers (Jacobi: every pixel reads the previous iterate).
``fused_schedule`` picks its blocks per layer: rows streamed down column
strips (``strip_geometry`` picks the strips and the runs of rows per block;
the shared memory is ``strip_smem_bytes``) wherever the runs are long
enough, the earlier design's 32-row tiles (``TILES``, ``tile_for``,
``tiled_*``) on the layers too short to stream. ``chip_smoke.py`` phase 3
times both designs at every layer (``geometry=`` forces one).

Its plain version is ``box_solve_ref(update_matrices_ref(...))``: the same
function in two steps. The TPU kernel's warp is a shift/select chain over
2S+2 shifted planes, because Mosaic has no vector gather; only two taps per
stage carry weight, so both versions here read those two taps directly. The
semantics that must hold (separable warp with the x-neighbour's y weights,
clamped coordinates, edge-padded planes, replicate-edge M, operation order)
are listed in the CUDA source, with the design notes. Both designs are
held to the iteration's own bound (``fused_bound``: ``fused_bytes``, and
``fused_ops`` with no halo).

Wrappers dispatch on the tensors' device: CPU tensors take the plain
version, CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

KERNELS = ("farneback_iterate_fused",)

# launches per kernel since the last reset (plain ints; counted where the
# kernel is launched, nowhere else), on either design of blocks
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain version
def _warp_coords(flow: torch.Tensor, S: int, row0=None, global_h: int = 0):
    """Per-pixel (fx, fy, sx, sy, x1, y1) of the reference's coordinate
    block: ``inside`` gating of the fractions, shifts clipped to +-S, and the
    floored source coordinates (floats). flow: (b, 2, H, W).

    With ``row0`` the arrays are a haloed row slab of a ``global_h``-row
    image whose first row is global row ``row0`` (an int or a 0-dim tensor):
    the inside gate then tests global rows, so that a slab's edge is not
    taken for the image's."""
    _, _, H, W = flow.shape
    dev = flow.device
    xs = torch.arange(W, device=dev, dtype=torch.float32)[None, None, :]
    ys = torch.arange(H, device=dev, dtype=torch.float32)[None, :, None]
    fx_t = xs + flow[:, 0]
    fy_t = ys + flow[:, 1]
    x1 = torch.floor(fx_t)
    y1 = torch.floor(fy_t)
    fx = fx_t - x1
    fy = fy_t - y1
    if row0 is None:
        inside = (x1 >= 0) & (x1 < W - 1) & (y1 >= 0) & (y1 < H - 1)
    else:
        y1g = y1 + row0
        inside = (x1 >= 0) & (x1 < W - 1) & (y1g >= 0) & (y1g < global_h - 1)
    zero = torch.zeros((), device=dev, dtype=torch.float32)
    fx = torch.where(inside, fx, zero)
    fy = torch.where(inside, fy, zero)
    sx = torch.clamp(x1 - xs, -S, S).to(torch.int64)
    sy = torch.clamp(y1 - ys, -S, S).to(torch.int64)
    return fx, fy, sx, sy, x1, y1


def warp_separable(R1: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                   sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """The reference's two-stage warp of R1 (b, 5, H, W): a y stage in which
    every column mixes two rows with its own (fy, sy), then an x stage in
    which the pixel's fx mixes that result at columns x+sx and x+sx+1.
    Indices clamp to the plane (the reference's edge padding). The reference
    sums 2S+2 shifted planes of which two carry weight; the two are gathered
    here."""
    b, c, H, W = R1.shape
    dev = R1.device
    rows = torch.arange(H, device=dev)[None, :, None]
    cols = torch.arange(W, device=dev)[None, None, :]

    def rows_of(shift):
        idx = torch.clamp(rows + shift, 0, H - 1)
        return torch.gather(R1, 2, idx[:, None].expand(b, c, H, W))

    fy5 = fy[:, None]
    A = (1.0 - fy5) * rows_of(sy) + fy5 * rows_of(sy + 1)

    def cols_of(shift):
        idx = torch.clamp(cols + shift, 0, W - 1)
        return torch.gather(A, 3, idx[:, None].expand(b, c, H, W))

    fx5 = fx[:, None]
    return (1.0 - fx5) * cols_of(sx) + fx5 * cols_of(sx + 1)


def normal_equations(R0: torch.Tensor, r: torch.Tensor, flow: torch.Tensor,
                     border: torch.Tensor) -> torch.Tensor:
    """The five normal-equation planes M = [G11, G12, G22, h1, h2]
    (b, 5, H, W) from R0 and the warped R1 ``r``, in the reference's
    operation order."""
    dx = flow[:, 0]
    dy = flow[:, 1]
    r4 = (R0[:, 2] + r[:, 2]) * 0.5
    r5 = (R0[:, 3] + r[:, 3]) * 0.5
    r6 = (R0[:, 4] + r[:, 4]) * 0.25
    r2 = (R0[:, 0] - r[:, 0]) * 0.5
    r3 = (R0[:, 1] - r[:, 1]) * 0.5
    r2 = (r2 + r4 * dy + r6 * dx) * border
    r3 = (r3 + r6 * dy + r5 * dx) * border
    r4 = r4 * border
    r5 = r5 * border
    r6 = r6 * border
    return torch.stack([r4 * r4 + r6 * r6,
                        (r4 + r5) * r6,
                        r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3,
                        r6 * r2 + r5 * r3], dim=1)


def update_matrices_ref(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                        border: torch.Tensor, max_shift: int) -> torch.Tensor:
    """Warp and normal equations, the first half of the plain version of
    ``farneback_iterate_fused``: (b, 5, H, W) M."""
    fx, fy, sx, sy, _, _ = _warp_coords(flow, max_shift)
    return normal_equations(R0, warp_separable(R1, fx, fy, sx, sy), flow,
                            border)


def box_solve_ref(M: torch.Tensor, winsize: int) -> torch.Tensor:
    """Box mean and solve, the second half of the plain version of
    ``farneback_iterate_fused``: (b, 5, H, W) M ->
    (b, 2, H, W) flow. Replicate-edge M, (2m+1)^2 shifted sums in the
    reference's order (vertical then horizontal, tap 0 first), divided by
    winsize^2 (an even winsize sums one extra row/column, as upstream)."""
    _, _, H, W = M.shape
    m = winsize // 2
    taps = 2 * m + 1
    Mp = F.pad(M, (m, m, m, m), mode="replicate")
    v = torch.zeros(M.shape[:2] + (H, W + 2 * m), dtype=M.dtype, device=M.device)
    for d in range(taps):
        v = v + Mp[:, :, d:d + H, :]
    hsum = torch.zeros_like(M)
    for d in range(taps):
        hsum = hsum + v[:, :, :, d:d + W]
    g = hsum * (1.0 / (winsize * winsize))
    g11, g12, g22, h1, h2 = g.unbind(1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet,
                        (g22 * h1 - g12 * h2) * idet], dim=1)


def farneback_iterate_ref(R0: torch.Tensor, R1: torch.Tensor,
                          flow0: torch.Tensor, border: torch.Tensor,
                          iterations: int, winsize: int = 12,
                          max_shift: int = 16) -> torch.Tensor:
    """Plain PyTorch version of ``farneback_iterate`` (same arguments)."""
    flow = flow0
    for _ in range(iterations):
        flow = box_solve_ref(update_matrices_ref(R0, R1, flow, border,
                                                 max_shift), winsize)
    return flow


# ------------------------------------------------------------ CUDA wrappers
# a farneback_iterate_fused block: 128 M columns (kCols in the CUDA source)
# x STRIP_ROWS rows a step (kRows), one thread each, 2 outputs per thread
# of its h stage (kNX); the largest m the run-time-m kernel takes
# (kMaxGenericM; m = 6 is compiled in), the largest max_shift (kMaxShift)
STRIP_COLS = 128
STRIP_ROWS = 4
STRIP_H_COLS = 2
MAX_GENERIC_M = 32
MAX_STRIP_SHIFT = 63
# steps between a ring row's copy and its first read (kPrefetch)
STRIP_PREFETCH = 1
# dynamic shared memory one block may opt in to on the H100 (227 KB)
MAX_SMEM_BYTES = 232448
# SMs of an H100 SXM, for bounds reckoned without a card
H100_SMS = 132


def _pad_rows(n: int) -> int:
    """Smallest v >= n with v = 32 / STRIP_ROWS (mod 32) (``pad_rows`` in
    the source)."""
    return n + (32 // STRIP_ROWS - n) % 32


def strip_smem_bytes(strip: int, m: int, S: int) -> int:
    """Shared-memory bytes of one ``farneback_iterate_fused`` block for a
    strip of ``strip`` output columns: the R1 ring (2S + 1 + STRIP_ROWS
    (STRIP_PREFETCH + 1) rows) and two A groups (STRIP_ROWS rows each), 5
    planes of the A window (strip + 2m + 2S + 1 columns, 6 more for
    16-byte-aligned copies, padded), and two V groups (STRIP_ROWS rows x 5
    planes of strip + 2m + STRIP_H_COLS - 1 columns, padded). The same sum
    as ``strip::smem_bytes`` in the source."""
    awp = _pad_rows(strip + 2 * m + 2 * S + 1 + 6)
    vs = _pad_rows(strip + 2 * m + STRIP_H_COLS - 1)
    rr = 2 * S + 1 + STRIP_ROWS * (STRIP_PREFETCH + 1)
    return 4 * 5 * (awp * (rr + 2 * STRIP_ROWS) + 2 * STRIP_ROWS * vs)


def strip_launch_smem(strip: int, winsize: int, max_shift: int) -> int:
    """The block's shared-memory bytes for this strip width, winsize and
    max_shift, or ValueError where the kernel cannot take them."""
    m = winsize // 2
    if winsize < 1 or max_shift < 0:
        raise ValueError(f"winsize={winsize}, max_shift={max_shift}")
    if m != 6 and m > MAX_GENERIC_M:
        raise ValueError(f"winsize={winsize}: the kernel takes m = winsize // 2 "
                         f"up to {MAX_GENERIC_M}")
    if not 1 <= strip <= STRIP_COLS - 2 * m:
        raise ValueError(f"strip {strip}: a block covers 1 to "
                         f"{STRIP_COLS - 2 * m} columns at winsize={winsize}")
    nbytes = strip_smem_bytes(strip, m, max_shift)
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"winsize={winsize}, max_shift={max_shift}: a strip of {strip} "
            f"columns needs {nbytes} B of shared memory, over the "
            f"{MAX_SMEM_BYTES} B a block may have")
    if max_shift > MAX_STRIP_SHIFT:   # past the shared memory already
        raise ValueError(f"max_shift={max_shift}: the kernel takes up to "
                         f"{MAX_STRIP_SHIFT}")
    return nbytes


@dataclass(frozen=True)
class StripGeometry:
    """One row-streaming launch of ``farneback_iterate_fused``: ``strips``
    strips of ``strip`` output columns; the b x strips columns of H rows cut
    into runs of ``rows`` rows, one block each: ``runs_per_col`` runs of each
    column (never crossing into the next), or with ``runs_per_col`` 0 the
    columns laid end to end and cut every ``rows`` rows. A block (512
    threads at up to 128 registers each: one an SM) walks its run STRIP_ROWS
    rows a step."""
    strip: int
    strips: int
    rows: int
    runs_per_col: int
    blocks: int
    smem_bytes: int

    def __str__(self) -> str:
        cut = (f"{self.runs_per_col} runs of {self.rows} rows a column"
               if self.runs_per_col else f"runs of {self.rows} rows")
        return f"{self.strips} strips of {self.strip} x {cut}, {self.blocks} blocks"


def strip_segments(b: int, H: int, strips: int, rows: int,
                   runs_per_col: int = 0):
    """Per block, the row counts of the segments it walks: its run of rows
    cut where it crosses from one strip column to the next."""
    if runs_per_col:
        return [[min(rows, H - r * rows)] for _ in range(b * strips)
                for r in range(runs_per_col)]
    total = b * strips * H
    out = []
    for start in range(0, total, rows):
        g, end, segs = start, min(total, start + rows), []
        while g < end:
            n = min(H - g % H, end - g)
            segs.append(n)
            g += n
        out.append(segs)
    return out


# a segment's start costs STEP_PROLOGUE steps more than its rows' (the ring
# fill, the pipeline's two steps of drain are counted with the rows)
STEP_PROLOGUE = 2


def _run_steps(segs, m: int) -> int:
    return sum(-(-(n + 2 * m) // STRIP_ROWS) + 2 + STEP_PROLOGUE for n in segs)


@functools.lru_cache(maxsize=256)
def strip_geometry(b: int, H: int, W: int, winsize: int, max_shift: int,
                   sm_count: int, strip=None, rows=None) -> StripGeometry:
    """The row-streaming launch on a card with ``sm_count`` SMs (cached:
    every launch asks). Strips as wide as a block's 128 columns and shared
    memory allow, of equal width (or ``strip`` columns); one block per SM at
    most, so there is no wave tail. The runs are the cut whose longest run
    takes the fewest steps among: each column into sm_count // columns equal
    runs, and all rows laid end to end and cut evenly over the SMs; ``rows``
    fixes an end-to-end cut."""
    m = winsize // 2
    if strip is None:
        # the widest equal strips; narrower where the ring would overrun
        # shared memory (a max_shift past the product's)
        widest = STRIP_COLS - 2 * m
        ns = -(-W // widest) if widest >= 1 else W
        while ns < W and strip_smem_bytes(-(-W // ns), m, max_shift) > MAX_SMEM_BYTES:
            ns += 1
        strip = -(-W // ns) if widest >= 1 else 0
    strips = -(-W // strip) if strip >= 1 else 0
    smem = strip_launch_smem(strip, winsize, max_shift)
    total = b * strips * H
    cols = b * strips
    if rows is not None:
        cuts = [(rows, 0)]
    else:
        cuts = [(-(-total // sm_count), 0)]
        k = sm_count // cols
        if k >= 1:
            r = -(-H // min(k, H))
            cuts.append((r, -(-H // r)))
    rows, rpc = min(cuts, key=lambda cut: max(
        _run_steps(sg, m) for sg in strip_segments(b, H, strips, *cut)))
    blocks = cols * rpc if rpc else -(-total // rows)
    return StripGeometry(strip, strips, rows, rpc, blocks, smem)


# A layer streams where its runs hold at least STRIP_MIN_RUN_PER_SHIFT x
# max_shift rows; below that (the coarsest layer at every batch size, every
# layer but the finest at b = 1) the 2m halo rows and the ring fill of each short run cost more
# than the tile design's halo, and farneback_iterate_fused runs the tile
# design's blocks there. Read off both designs' times at every layer of
# chip_smoke.py phase 3 on an H100 (PERF.md): strips won at runs of 27 and
# more rows at S = 8 and of 74 and more at S = 16, tiles at 15 and fewer at
# S = 8 and 43 and fewer at S = 16.
STRIP_MIN_RUN_PER_SHIFT = 3


def fused_schedule(b: int, H: int, W: int, winsize: int, max_shift: int,
                   sm_count: int):
    """The launch ``farneback_iterate_fused`` makes for a (b, H, W) layer on
    a card with ``sm_count`` SMs: the row-streaming ``strip_geometry``, or,
    where its runs are shorter than STRIP_MIN_RUN_PER_SHIFT x max_shift
    rows, the tile design's ``tile_for`` tile (a (rows, columns) tuple)."""
    g = strip_geometry(b, H, W, winsize, max_shift, sm_count)
    if g.rows < STRIP_MIN_RUN_PER_SHIFT * max_shift:
        return tile_for(b, H, W, sm_count)
    return g


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 CUDA tensor, "
                         f"got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def _check_all(R0, R1, flow, border, flow_out) -> None:
    b, _, H, W = R0.shape
    for name, t, shape in (("R0", R0, (b, 5, H, W)), ("R1", R1, (b, 5, H, W)),
                           ("flow", flow, (b, 2, H, W)),
                           ("border", border, (H, W)),
                           ("flow_out", flow_out, (b, 2, H, W))):
        _check(name, t, shape)
    if flow_out.data_ptr() == flow.data_ptr():
        raise ValueError("flow_out must not be flow (Jacobi reads the "
                         "previous iterate everywhere)")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def iterate_fused_cuda(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                       border: torch.Tensor, flow_out: torch.Tensor,
                       winsize: int, max_shift: int, geometry=None) -> None:
    """Launch ``farneback_iterate_fused``: one iteration from ``flow`` into
    ``flow_out`` (b, 2, H, W), a different buffer. ``geometry`` (a
    ``StripGeometry``, or a tile of ``TILES`` for the tile design's blocks)
    defaults to ``fused_schedule`` of the launch on this card."""
    from mav_detection_tpu_torch import _build

    _check_all(R0, R1, flow, border, flow_out)
    b, _, H, W = R0.shape
    if geometry is None:
        geometry = fused_schedule(b, H, W, winsize, max_shift,
                                  _sm_count(R0.device.index))
    if isinstance(geometry, StripGeometry):
        strip_launch_smem(geometry.strip, winsize, max_shift)
        args = (geometry.strip, geometry.rows, geometry.runs_per_col, -1)
    else:
        tiled_launch_smem(geometry, winsize, max_shift)
        args = (0, 0, 0, TILES[tuple(geometry)])
    lib = _build.load()
    stream = torch.cuda.current_stream(R0.device).cuda_stream
    err = lib.farneback_iterate_fused(
        R0.data_ptr(), R1.data_ptr(), flow.data_ptr(), border.data_ptr(),
        flow_out.data_ptr(), b, H, W, int(max_shift), winsize // 2,
        1.0 / (winsize * winsize), *args, stream)
    _raise_on(err, "farneback_iterate_fused")
    LAUNCHES["farneback_iterate_fused"] += 1


def _info(fn, kernel: str, *args) -> Dict[str, int]:
    import ctypes

    out = (ctypes.c_int * 4)()
    _raise_on(fn(*args, out), kernel)
    return {"smem_bytes": out[0], "registers": out[1], "blocks_per_sm": out[2],
            "local_bytes": out[3]}


def fused_kernel_info(winsize: int, max_shift: int, geometry) -> Dict[str, int]:
    """Launch resources of ``farneback_iterate_fused`` on the current card
    on this ``StripGeometry``'s strip width or on this tile: shared-memory
    bytes per block, registers per thread, blocks per SM, local-memory
    bytes per thread."""
    from mav_detection_tpu_torch import _build

    if isinstance(geometry, StripGeometry):
        strip_launch_smem(geometry.strip, winsize, max_shift)
        args = (geometry.strip, -1)
    else:
        tiled_launch_smem(geometry, winsize, max_shift)
        args = (0, TILES[tuple(geometry)])
    return _info(_build.load().farneback_iterate_fused_info,
                 "farneback_iterate_fused_info", args[0], winsize // 2,
                 int(max_shift), args[1])


# The tile design: farneback_iterate_fused's blocks on the layers too short
# to stream (and, forced with geometry=, the yardstick chip_smoke.py phase 3
# times the strips against).
# output tile (rows, columns) -> the kernel's tile index in the CUDA source
TILES = {(32, 64): 0, (32, 32): 1}
# 32x64 recomputes the least halo per output pixel; where it would leave
# SMs without a block (the coarsest pyramid layers), 32x32 gives twice the
# blocks
TILE = (32, 64)
SMALL_TILE = (32, 32)
# rows of the M region per chunk of the y and x stages (kCH in the source)
# and threads per block (kThreads)
CHUNK_ROWS = 8
THREADS = 512


def tiled_smem_bytes(tile, m: int, S: int) -> int:
    """Shared-memory bytes of one tile-design block: two A
    chunks (5 planes of CHUNK_ROWS rows of the +-S A window) and M (5 planes
    over the M region, its rows padded to a multiple of 4 floats where the
    horizontal sums read float4, else to an odd length). The same sum as
    ``tiled::smem_bytes`` in the CUDA source."""
    th, tw = tile
    mrh, mrw = th + 2 * m, tw + 2 * m
    aw = mrw + 2 * S + 1
    ms = (mrw + 3) & ~3 if (th * tw // THREADS) % 4 == 0 else mrw | 1
    return 4 * 5 * (2 * CHUNK_ROWS * aw + mrh * ms)


def tiled_launch_smem(tile, winsize: int, max_shift: int) -> int:
    """The block's shared-memory bytes for this tile, winsize and max_shift,
    or ValueError where the kernel cannot take them."""
    if tuple(tile) not in TILES:
        raise ValueError(f"tile {tile}: the kernel has tiles {sorted(TILES)}")
    if winsize < 1 or max_shift < 0:
        raise ValueError(f"winsize={winsize}, max_shift={max_shift}")
    nbytes = tiled_smem_bytes(tile, winsize // 2, max_shift)
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"winsize={winsize}, max_shift={max_shift}: a {tile[0]}x{tile[1]} "
            f"block needs {nbytes} B of shared memory, over the "
            f"{MAX_SMEM_BYTES} B a block may have")
    return nbytes


def tile_for(b: int, H: int, W: int, sm_count: int):
    """The tiled design's output tile for a (b, H, W) launch on a card with
    ``sm_count`` SMs: TILE where it gives every SM a block, else
    SMALL_TILE."""
    th, tw = TILE
    blocks = b * -(-H // th) * -(-W // tw)
    return TILE if blocks >= sm_count else SMALL_TILE


# fp32 operations per cell, counted from csrc/farneback_iter.cu (integer
# index work not counted): the y stage per A-window cell (coordinate block
# 20, 5 planes x 3, 1 - fx), the x stage and normal equations per M cell
# (1 - fx, 5 x 3, combination 37; the tiled design adds the coordinate
# block's 20 again), and the mean and 2x2 solve per output pixel; the box sums
# add 5 planes x taps per vertical and per horizontal sum
OPS_Y_STAGE = 36
OPS_UPDATE = 73
OPS_X_STAGE = 53
OPS_SOLVE = 18


def fused_bytes(b: int, h: int, w: int) -> int:
    """Bytes one launch of either design must move: R0 and R1 (5 planes
    each), the flow in and out (2 each) once per pixel, the border map
    once."""
    return 4 * (14 * b * h * w + h * w)


def fused_ops(b: int, h: int, w: int, winsize: int) -> int:
    """fp32 operations the iteration itself needs, whatever the design: per
    output pixel one y-stage cell, one x-stage cell with its normal
    equations, the 5 x taps adds of its vertical and of its horizontal box
    sums, the mean and the solve. No halo: a design that recomputes cells
    does more (``strip_ops``, ``tiled_ops``), which the bound does not
    count."""
    taps = 2 * (winsize // 2) + 1
    return b * h * w * (OPS_Y_STAGE + OPS_X_STAGE + 2 * 5 * taps + OPS_SOLVE)


def fused_bound(b: int, h: int, w: int, winsize: int) -> tuple:
    """(least ms of one iteration on the H100, "bytes" or "operations"):
    the larger of ``fused_bytes`` over the HBM rate and ``fused_ops`` over
    the fp32 rate. Both designs are held to it."""
    from mav_detection_tpu_torch.utils.timing import bound_ms

    return bound_ms(fused_bytes(b, h, w), fused_ops(b, h, w, winsize))


def strip_ops(b: int, h: int, w: int, winsize: int, max_shift: int,
              geometry: StripGeometry) -> int:
    """fp32 operations one ``farneback_iterate_fused`` launch does, its
    halo recompute included (a diagnostic; the bound is ``fused_ops``): per
    segment s ceil((rows + 2m) / s) A and M rows (s = STRIP_ROWS; A over
    the window's strip + 2m + 2S + 1 columns, M over strip + 2m with its 5 x
    taps vertical adds), and per output row of the segment the h stage's
    outputs (strip rounded up to STRIP_H_COLS; 5 x taps horizontal adds,
    mean and solve)."""
    m = winsize // 2
    taps = 2 * m + 1
    mrw = geometry.strip + 2 * m
    aw = mrw + 2 * max_shift + 1
    per_row = aw * OPS_Y_STAGE + mrw * (OPS_X_STAGE + 5 * taps)
    per_out_row = (STRIP_H_COLS * -(-geometry.strip // STRIP_H_COLS)
                   * (5 * taps + OPS_SOLVE))
    segs = [n for run in strip_segments(b, h, geometry.strips, geometry.rows,
                                        geometry.runs_per_col) for n in run]
    sr = STRIP_ROWS
    return (sum(sr * -(-(n + 2 * m) // sr) for n in segs) * per_row
            + sum(segs) * per_out_row)


def tiled_ops(b: int, h: int, w: int, winsize: int, max_shift: int, tile) -> int:
    """fp32 operations one tile-design launch does on these
    shapes, its halo recompute included (a diagnostic, as ``strip_ops``)."""
    th, tw = tile
    m = winsize // 2
    taps = 2 * m + 1
    mrh, mrw = th + 2 * m, tw + 2 * m
    aw = mrw + 2 * max_shift + 1
    per_tile = (OPS_Y_STAGE * mrh * aw + OPS_UPDATE * mrh * mrw
                + 5 * taps * (th * mrw + th * tw) + OPS_SOLVE * th * tw)
    return per_tile * b * -(-h // th) * -(-w // tw)


def farneback_iterate(R0: torch.Tensor, R1: torch.Tensor, flow0: torch.Tensor,
                      border: torch.Tensor, iterations: int,
                      winsize: int = 12, max_shift: int = 16) -> torch.Tensor:
    """Run ``iterations`` Farneback solver iterations; returns (b, 2, H, W).

    R0, R1: (b, 5, H, W) channel-first coefficients; flow0: (b, 2, H, W);
    border: (H, W). CPU tensors run the plain version; CUDA tensors launch
    the fused kernel once per iteration (two flow buffers allocated once per
    call, nothing else)."""
    if R0.device.type == "cpu":
        return farneback_iterate_ref(R0, R1, flow0, border, iterations,
                                     winsize, max_shift)
    if R0.device.type != "cuda":
        raise ValueError(f"farneback_iterate: unsupported device {R0.device}")
    flow = flow0.contiguous()
    if iterations <= 0:
        return flow
    bufs = (torch.empty_like(flow), torch.empty_like(flow))
    for it in range(iterations):
        out = bufs[it % 2]
        iterate_fused_cuda(R0, R1, flow, border, out, winsize, max_shift)
        flow = out
    return flow
