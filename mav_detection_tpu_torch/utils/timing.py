"""Timing on the card and the host, and the H100's peak rates for bounds.

The card's time comes from CUDA events around eager calls, or from a CUDA
graph of many launches replayed (device time only, without the host's time
per launch); the CPU's from the host clock, which no card metric may quote.
A bound is the least time the card could take: the larger of the bytes
moved over the HBM rate and the operations over the peak rate of their type.
"""
from __future__ import annotations

import time

import torch

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 rate, fp32 non-tensor
# rate, dense bf16 tensor rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12


def bound_ms(nbytes: float, fp32_ops: float, bf16_ops: float = 0.0):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the operations over their peak rates."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = (fp32_ops / FP32_FLOPS_PER_S + bf16_ops / BF16_FLOPS_PER_S) * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def share_of_bound(bound: float, t: float, dev: torch.device):
    """The bound's share of the time ``t`` (same unit) on a card; None on
    the CPU, whose host-clock times are no card's."""
    return bound / t if dev.type == "cuda" else None


def fmt_share(share) -> str:
    return "not measured (CPU)" if share is None else f"{share:.3f}"


def events_ms(fn, reps: int, warm: int = 3) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn`` (kernel launches on the current
    stream), from a CUDA graph of ``reps`` calls replayed after warm-up, so
    that the host's time per launch does not show between short kernels."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return events_ms(graph.replay, 5, 2) / reps


def host_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean host-clock ms per call over ``reps`` calls (the CPU)."""
    for _ in range(warm):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def kernel_ms(fn, dev: torch.device, reps: int) -> float:
    """ms per call of a kernel launch: a replayed CUDA graph on a card, the
    host clock on the CPU."""
    return graph_ms(fn, reps) if dev.type == "cuda" else host_ms(fn, reps)


def eager_ms(fn, dev: torch.device, reps: int, warm: int = 3) -> float:
    """ms per call of eager work: CUDA events on a card, the host clock on
    the CPU."""
    return events_ms(fn, reps, warm) if dev.type == "cuda" else host_ms(fn, reps, warm)


def nbytes(*tensors) -> int:
    """Bytes the tensors hold."""
    return sum(t.numel() * t.element_size() for t in tensors)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
