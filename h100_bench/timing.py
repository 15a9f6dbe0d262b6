"""Device timing of captured work: a frozen copy of the program's
graph-replay timer.

``capture(fn)`` runs ``fn`` three times (which builds its kernels and
constants), captures one call in a CUDA graph and returns the graph;
``replay_ms(graph, reps)`` replays it ``reps`` times back to back between
two CUDA events and gives the device ms per replay, so the host's time per
launch does not show between short kernels.
"""
from __future__ import annotations

from typing import Callable

import torch


def capture(fn: Callable[[], object]) -> torch.cuda.CUDAGraph:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    return graph


def replay_ms(graph: torch.cuda.CUDAGraph, reps: int, warm: int = 2) -> float:
    for _ in range(warm):
        graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn: Callable[[], object], reps: int) -> float:
    """Device ms per call of ``fn``, captured once and replayed ``reps``
    times."""
    return replay_ms(capture(fn), reps)
