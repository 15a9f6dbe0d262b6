"""Per-stage host wall-clock tracing (``mav_detection_tpu.utils.tracing``'s
``Tracer`` and ``stage``; the profiler capture is not ported yet).

Device work is asynchronous: a stage that only enqueues kernels records the
enqueue time, and the stage that first synchronizes (the batch's host pull)
absorbs the device time.

Usage::

    tracer = Tracer()
    with tracer.stage("flow"):
        flow = farneback_flow_batch(...)
    print(tracer.summary())
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


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
