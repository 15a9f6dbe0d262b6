"""The Farneback solver iteration: CUDA kernels, their plain PyTorch version,
and launch counters.

Replaces ``mav_detection_tpu/ops/flow/farneback_pallas.py::
farneback_iterate_pallas`` (the reference's only TPU kernel). One iteration
is two kernels in ``csrc/farneback_iter.cu``:

* ``farneback_update_matrices`` — warp R1 by the current flow and form the
  five normal-equation planes M (one thread per pixel, M to a scratch
  buffer allocated once per call);
* ``farneback_box_solve`` — (2m+1)^2 box mean of M with replicate edges and
  the 2x2 solve, into the other of two ping-pong flow buffers (Jacobi: every
  pixel reads the previous iterate).

The TPU kernel's warp is a shift/select chain over 2S+2 shifted planes,
because Mosaic has no vector gather; only two taps per stage carry weight,
so both versions here read those two taps directly. The semantics that must
hold (separable warp with the x-neighbour's y weights, clamped coordinates,
edge-padded planes, replicate-edge M, operation order) are listed in the
CUDA source. Bound and design notes are there too.

Wrappers dispatch on the tensors' device: CPU tensors take the plain
version, CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

KERNELS = ("farneback_update_matrices", "farneback_box_solve")

# launches per kernel since the last reset (plain ints; counted where the
# kernel is launched, nowhere else)
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain version
def _warp_coords(flow: torch.Tensor, S: int):
    """Per-pixel (fx, fy, sx, sy) of the reference's coordinate block:
    clamped coordinates, ``inside`` gating of the fractions, shifts clipped
    to +-S. flow: (b, 2, H, W)."""
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
    inside = (x1 >= 0) & (x1 < W - 1) & (y1 >= 0) & (y1 < H - 1)
    zero = torch.zeros((), device=dev, dtype=torch.float32)
    fx = torch.where(inside, fx, zero)
    fy = torch.where(inside, fy, zero)
    sx = torch.clamp(x1 - xs, -S, S).to(torch.int64)
    sy = torch.clamp(y1 - ys, -S, S).to(torch.int64)
    return fx, fy, sx, sy


def update_matrices_ref(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                        border: torch.Tensor, max_shift: int) -> torch.Tensor:
    """Plain version of ``farneback_update_matrices``: (b, 5, H, W) M."""
    b, _, H, W = R0.shape
    dev = R0.device
    fx, fy, sx, sy = _warp_coords(flow, max_shift)
    rows = torch.arange(H, device=dev)[None, :, None]
    cols = torch.arange(W, device=dev)[None, None, :]

    # y stage at every column with that column's own fy, sy
    def rows_of(shift):
        idx = torch.clamp(rows + shift, 0, H - 1)
        return torch.gather(R1, 2, idx[:, None].expand(b, 5, H, W))

    fy5 = fy[:, None]
    A = (1.0 - fy5) * rows_of(sy) + fy5 * rows_of(sy + 1)

    # x stage: the pixel's fx mixes A at x+sx and x+sx+1 (clamped columns)
    def cols_of(shift):
        idx = torch.clamp(cols + shift, 0, W - 1)
        return torch.gather(A, 3, idx[:, None].expand(b, 5, H, W))

    fx5 = fx[:, None]
    r = (1.0 - fx5) * cols_of(sx) + fx5 * cols_of(sx + 1)

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


def box_solve_ref(M: torch.Tensor, winsize: int) -> torch.Tensor:
    """Plain version of ``farneback_box_solve``: (b, 5, H, W) M ->
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


def update_matrices_cuda(R0: torch.Tensor, R1: torch.Tensor,
                         flow: torch.Tensor, border: torch.Tensor,
                         M: torch.Tensor, max_shift: int) -> None:
    """Launch ``farneback_update_matrices``: writes M (b, 5, H, W)."""
    from mav_detection_tpu_torch import _build

    b, _, H, W = R0.shape
    for name, t, shape in (("R0", R0, (b, 5, H, W)), ("R1", R1, (b, 5, H, W)),
                           ("flow", flow, (b, 2, H, W)),
                           ("border", border, (H, W)), ("M", M, (b, 5, H, W))):
        _check(name, t, shape)
    lib = _build.load()
    stream = torch.cuda.current_stream(R0.device).cuda_stream
    err = lib.farneback_update_matrices(
        R0.data_ptr(), R1.data_ptr(), flow.data_ptr(), border.data_ptr(),
        M.data_ptr(), b, H, W, int(max_shift), stream)
    _raise_on(err, "farneback_update_matrices")
    LAUNCHES["farneback_update_matrices"] += 1


def box_solve_cuda(M: torch.Tensor, flow_out: torch.Tensor,
                   winsize: int) -> None:
    """Launch ``farneback_box_solve``: writes flow_out (b, 2, H, W)."""
    from mav_detection_tpu_torch import _build

    b, _, H, W = M.shape
    _check("M", M, (b, 5, H, W))
    _check("flow_out", flow_out, (b, 2, H, W))
    if winsize // 2 > 8:
        raise ValueError(f"winsize={winsize}: the box kernel takes m <= 8")
    lib = _build.load()
    stream = torch.cuda.current_stream(M.device).cuda_stream
    err = lib.farneback_box_solve(M.data_ptr(), flow_out.data_ptr(), b, H, W,
                                  winsize // 2, 1.0 / (winsize * winsize),
                                  stream)
    _raise_on(err, "farneback_box_solve")
    LAUNCHES["farneback_box_solve"] += 1


def farneback_iterate(R0: torch.Tensor, R1: torch.Tensor, flow0: torch.Tensor,
                      border: torch.Tensor, iterations: int,
                      winsize: int = 12, max_shift: int = 16) -> torch.Tensor:
    """Run ``iterations`` Farneback solver iterations; returns (b, 2, H, W).

    R0, R1: (b, 5, H, W) channel-first coefficients; flow0: (b, 2, H, W);
    border: (H, W). CPU tensors run the plain version; CUDA tensors launch
    the two kernels per iteration (M scratch and the second flow buffer are
    allocated once per call)."""
    if R0.device.type == "cpu":
        return farneback_iterate_ref(R0, R1, flow0, border, iterations,
                                     winsize, max_shift)
    if R0.device.type != "cuda":
        raise ValueError(f"farneback_iterate: unsupported device {R0.device}")
    flow = flow0.contiguous()
    if iterations <= 0:
        return flow
    M = torch.empty_like(R0)
    bufs = (torch.empty_like(flow), torch.empty_like(flow))
    for it in range(iterations):
        out = bufs[it % 2]
        update_matrices_cuda(R0, R1, flow, border, M, max_shift)
        box_solve_cuda(M, out, winsize)
        flow = out
    return flow
