"""The least time of the Farneback solver iteration on an H100: the bytes
and operations the algorithm needs, whatever implements it, at the card's
published peaks.

Frozen copies of the program's ``fused_bytes`` / ``fused_ops`` count and
``bound_ms``: per output pixel R0 and R1 (5 float32 planes each) and the
flow in and out (2 planes each) are moved once, the border map once; the
operations are one y-stage cell (36), one x-stage cell with its normal
equations (53), 5 planes x taps adds of the vertical and of the horizontal
box sums, the mean and the 2x2 solve (18), with no halo recompute.

Peaks: NVIDIA H100 SXM data sheet at 700 W, 3.35 TB/s of HBM3 and
67 TFLOP/s of float32 outside the tensor cores.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

OPS_Y_STAGE = 36
OPS_X_STAGE = 53
OPS_SOLVE = 18


def iterate_bytes(b: int, h: int, w: int) -> int:
    return 4 * (14 * b * h * w + h * w)


def iterate_ops(b: int, h: int, w: int, winsize: int) -> int:
    taps = 2 * (winsize // 2) + 1
    return b * h * w * (OPS_Y_STAGE + OPS_X_STAGE + 2 * 5 * taps + OPS_SOLVE)


def iterate_bound_ms(b: int, h: int, w: int, winsize: int, iterations: int = 1):
    """(least ms of ``iterations`` iterations, "bytes" or "operations")."""
    tb = iterate_bytes(b, h, w) / HBM_BYTES_PER_S * 1e3
    to = iterate_ops(b, h, w, winsize) / FP32_FLOPS_PER_S * 1e3
    return max(tb, to) * iterations, ("bytes" if tb >= to else "operations")
