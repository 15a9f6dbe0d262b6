"""Per-stage host wall-clock tracing and a device trace capture
(``mav_detection_tpu.utils.tracing``: ``Tracer``, ``stage``, ``trace_to``).

Device work is asynchronous: a stage that only enqueues kernels records the
enqueue time, and the stage that first synchronizes (the batch's host pull)
absorbs the device time.

Usage::

    tracer = Tracer()
    with tracer.stage("flow"):
        flow = farneback_flow_batch(...)
    print(tracer.summary())

    with trace_to("/tmp/torch-trace"):   # torch.profiler capture, Chrome trace
        run()
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class Tracer:
    """Accumulating per-stage wall-clock timer (host side)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        total = sum(self.totals.values())
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(
                f"{name:>16}: {t * 1e3:9.1f} ms total, {t / max(n, 1) * 1e3:8.2f} ms/call"
                f" x{n:<5d} ({t / max(total, 1e-9) * 100:5.1f}%)")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "calls": self.counts[k]}
                for k in self.totals}


# module-level convenience tracer
_GLOBAL = Tracer()


def stage(name: str):
    """``with stage("flow"):`` using the module-global tracer."""
    return _GLOBAL.stage(name)


def global_summary() -> str:
    return _GLOBAL.summary()


@contextlib.contextmanager
def trace_to(log_dir: Optional[str]) -> Iterator[object]:
    """Capture a ``torch.profiler`` trace around the block (CPU activity,
    and the card's kernels and copies where CUDA is available) and write it
    as a Chrome trace JSON, ``trace_<pid>_<ns>.json``, under ``log_dir``.
    Yields the profiler (its ``key_averages()`` and ``events()``); a None or
    empty ``log_dir`` makes this a no-op that yields None."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
