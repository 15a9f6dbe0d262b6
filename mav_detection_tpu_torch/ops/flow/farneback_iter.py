"""The Farneback solver iteration: its CUDA kernel, the plain PyTorch
version, and the launch counter.

Replaces ``mav_detection_tpu/ops/flow/farneback_pallas.py::
farneback_iterate_pallas`` (the reference's only TPU kernel). One iteration
is one launch of ``farneback_iterate_fused`` (``csrc/farneback_iter.cu``):
warp R1 by the current flow, form the five normal-equation planes M, take
their (2m+1)^2 box mean with replicate edges and solve the 2x2 system, M
kept in shared memory throughout, the new flow written to the other of two
ping-pong buffers (Jacobi: every pixel reads the previous iterate).

Its plain version is ``box_solve_ref(update_matrices_ref(...))``: the same
function in two steps. The TPU kernel's warp is a shift/select chain over
2S+2 shifted planes, because Mosaic has no vector gather; only two taps per
stage carry weight, so both versions here read those two taps directly. The
semantics that must hold (separable warp with the x-neighbour's y weights,
clamped coordinates, edge-padded planes, replicate-edge M, operation order)
are listed in the CUDA source. Bound and design notes are there too.

Wrappers dispatch on the tensors' device: CPU tensors take the plain
version, CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F

KERNELS = ("farneback_iterate_fused",)

# launches per kernel since the last reset (plain ints; counted where the
# kernel is launched, nowhere else)
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
# dynamic shared memory one block may opt in to on the H100 (227 KB)
MAX_SMEM_BYTES = 232448


def fused_smem_bytes(tile, m: int, S: int) -> int:
    """Shared-memory bytes of one ``farneback_iterate_fused`` block: two A
    chunks (5 planes of CHUNK_ROWS rows of the +-S A window) and M (5 planes
    over the M region, its rows padded to a multiple of 4 floats where the
    horizontal sums read float4, else to an odd length). The same sum as
    ``smem_bytes`` in the CUDA source."""
    th, tw = tile
    mrh, mrw = th + 2 * m, tw + 2 * m
    aw = mrw + 2 * S + 1
    ms = (mrw + 3) & ~3 if (th * tw // THREADS) % 4 == 0 else mrw | 1
    return 4 * 5 * (2 * CHUNK_ROWS * aw + mrh * ms)


def fused_launch_smem(tile, winsize: int, max_shift: int) -> int:
    """The block's shared-memory bytes for this tile, winsize and max_shift,
    or ValueError where the kernel cannot take them."""
    if tuple(tile) not in TILES:
        raise ValueError(f"tile {tile}: the kernel has tiles {sorted(TILES)}")
    if winsize < 1 or max_shift < 0:
        raise ValueError(f"winsize={winsize}, max_shift={max_shift}")
    nbytes = fused_smem_bytes(tile, winsize // 2, max_shift)
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"winsize={winsize}, max_shift={max_shift}: a {tile[0]}x{tile[1]} "
            f"block needs {nbytes} B of shared memory, over the "
            f"{MAX_SMEM_BYTES} B a block may have")
    return nbytes


def tile_for(b: int, H: int, W: int, sm_count: int):
    """The output tile for a (b, H, W) launch on a card with ``sm_count``
    SMs: TILE where it gives every SM a block, else SMALL_TILE."""
    th, tw = TILE
    blocks = b * -(-H // th) * -(-W // tw)
    return TILE if blocks >= sm_count else SMALL_TILE


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


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def iterate_fused_cuda(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                       border: torch.Tensor, flow_out: torch.Tensor,
                       winsize: int, max_shift: int, tile=None) -> None:
    """Launch ``farneback_iterate_fused``: one iteration from ``flow`` into
    ``flow_out`` (b, 2, H, W), a different buffer. ``tile`` defaults to
    ``tile_for`` the launch."""
    from mav_detection_tpu_torch import _build

    b, _, H, W = R0.shape
    for name, t, shape in (("R0", R0, (b, 5, H, W)), ("R1", R1, (b, 5, H, W)),
                           ("flow", flow, (b, 2, H, W)),
                           ("border", border, (H, W)),
                           ("flow_out", flow_out, (b, 2, H, W))):
        _check(name, t, shape)
    if flow_out.data_ptr() == flow.data_ptr():
        raise ValueError("flow_out must not be flow (Jacobi reads the "
                         "previous iterate everywhere)")
    if tile is None:
        tile = tile_for(b, H, W, _sm_count(R0.device.index))
    fused_launch_smem(tile, winsize, max_shift)
    lib = _build.load()
    stream = torch.cuda.current_stream(R0.device).cuda_stream
    err = lib.farneback_iterate_fused(
        R0.data_ptr(), R1.data_ptr(), flow.data_ptr(), border.data_ptr(),
        flow_out.data_ptr(), b, H, W, int(max_shift), winsize // 2,
        1.0 / (winsize * winsize), TILES[tuple(tile)], stream)
    _raise_on(err, "farneback_iterate_fused")
    LAUNCHES["farneback_iterate_fused"] += 1


def fused_kernel_info(winsize: int, max_shift: int, tile=TILE) -> Dict[str, int]:
    """Launch resources of ``farneback_iterate_fused`` on the current card:
    shared-memory bytes per block, registers per thread, blocks per SM."""
    import ctypes

    from mav_detection_tpu_torch import _build

    fused_launch_smem(tile, winsize, max_shift)
    out = (ctypes.c_int * 3)()
    _raise_on(_build.load().farneback_iterate_fused_info(
        TILES[tuple(tile)], winsize // 2, int(max_shift), out),
        "farneback_iterate_fused_info")
    return {"smem_bytes": out[0], "registers": out[1], "blocks_per_sm": out[2]}


# fp32 operations of farneback_iterate_fused, counted from
# csrc/farneback_iter.cu, per cell of each stage (integer index work not
# counted): the y stage per A-window cell (coordinate block 20, 5 planes x 3,
# 1 - fy), the x stage and normal equations per M-region cell (coordinate
# block 20, 1 - fx, 5 x 3, combination 37), and the mean and 2x2 solve per
# output pixel; the box sums add 5 planes x taps per vertical and per
# horizontal sum
OPS_Y_STAGE = 36
OPS_UPDATE = 73
OPS_SOLVE = 18


def fused_bytes(b: int, h: int, w: int) -> int:
    """Bytes one ``farneback_iterate_fused`` launch must move: R0 and R1
    (5 planes each), the flow in and out (2 each) once per pixel, the border
    map once."""
    return 4 * (14 * b * h * w + h * w)


def fused_ops(b: int, h: int, w: int, winsize: int, max_shift: int, tile) -> int:
    """fp32 operations of one launch on these shapes, halo recompute
    included."""
    th, tw = tile
    m = winsize // 2
    taps = 2 * m + 1
    mrh, mrw = th + 2 * m, tw + 2 * m
    aw = mrw + 2 * max_shift + 1
    per_tile = (OPS_Y_STAGE * mrh * aw + OPS_UPDATE * mrh * mrw
                + 5 * taps * (th * mrw + th * tw) + OPS_SOLVE * th * tw)
    return per_tile * b * -(-h // th) * -(-w // tw)


def fused_bound(b: int, h: int, w: int, winsize: int, max_shift: int, tile) -> tuple:
    """(least ms of one launch on the H100, "bytes" or "operations"): the
    larger of ``fused_bytes`` over the HBM rate and ``fused_ops`` over the
    fp32 rate."""
    from mav_detection_tpu_torch.utils.timing import bound_ms

    return bound_ms(fused_bytes(b, h, w), fused_ops(b, h, w, winsize, max_shift, tile))


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
