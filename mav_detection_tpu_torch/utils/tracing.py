"""Per-stage tracing: host totals, recorded spans with device events, and a
device trace capture (``mav_detection_tpu.utils.tracing``: ``Tracer``,
``stage``, ``trace_to``).

``Tracer.stage(name)`` always adds the block's host wall-clock time to the
tracer's totals (``summary``, ``as_dict``). Device work is asynchronous: a
stage that only enqueues kernels records the enqueue time, and the stage
that first synchronizes absorbs the device time.

``recording(tracer)`` makes one tracer the one the program's spans go to:
the module-level ``stage(name)`` calls inside the Flow layer
(``flow``, ``flow.expand``, ``flow.iterate``) and the detection step
(``detect``, ``detect.derotate``, ``detect.foe_vote``, ``detect.masks``,
``detect.rates``). While nothing records, ``stage`` returns one shared null
context: no allocation, no event, no ``record_function``, no clock read.
While a tracer records, each of its stages also keeps a ``Span``: its
name, its parent (the innermost span of the tracer still open), the step
it belongs to (one identifier for the spans of one outermost span), host
start and end on the ``time.time_ns()`` clock that ``torch.profiler``
stamps its events on, a ``torch.profiler.record_function`` range of the
same name, and, where the tracer's device is a CUDA device, two timing
events recorded on the current stream at entry and exit. The events are
created ``external``: under ``torch.cuda.graph`` capture they become
event-record nodes of the graph, and every replay stamps them again, so
``device_ms()`` after a replay reads each span's device time inside the
graph. Spans live in the tracer until ``clear()``; a graph captured with
them must not be replayed after that.

Usage::

    tracer = Tracer("cuda")
    with recording(tracer):
        flow = farneback_flow_batch(prev, curr)
    print(tracer.device_ms())       # {"flow": ..., "flow.expand": ..., ...}

    with trace_to("/tmp/torch-trace"):   # torch.profiler capture, Chrome trace
        run()                            # with the program's spans named
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

_RECORDING: Optional["Tracer"] = None
_NULL = contextlib.nullcontext()


@dataclass
class Span:
    """One recorded stage: ``parent`` is the index in ``Tracer.spans`` of
    the innermost span open at entry (None for an outermost one), ``step``
    the identifier shared by the spans of one outermost span, the stamps
    ``time.time_ns()`` values, ``events`` the (start, end) CUDA events."""
    name: str
    parent: Optional[int]
    step: int
    start_ns: int = 0
    end_ns: int = 0
    events: Optional[Tuple[object, object]] = None


class Tracer:
    """Accumulating per-stage wall-clock timer (host side); while it
    records (``recording``), also a store of ``Span``s. ``device``: where
    the traced work runs; on a CUDA device each span records two timing
    events."""

    def __init__(self, device=None) -> None:
        self._events = device is not None and str(device).startswith("cuda")
        self.clear()

    def clear(self) -> None:
        """Forget the totals and every span (and their events)."""
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.spans: List[Span] = []
        self._open: List[int] = []
        self._steps = 0

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            if _RECORDING is self:
                with self._span(name):
                    yield
            else:
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    @contextlib.contextmanager
    def _span(self, name: str) -> Iterator[None]:
        import torch

        parent = self._open[-1] if self._open else None
        if parent is None:
            self._steps += 1
        span = Span(name, parent, self._steps)
        self._open.append(len(self.spans))
        self.spans.append(span)
        try:
            with torch.profiler.record_function(name):
                span.start_ns = time.time_ns()
                if self._events:
                    span.events = (torch.cuda.Event(enable_timing=True, external=True),
                                   torch.cuda.Event(enable_timing=True, external=True))
                    span.events[0].record()
                try:
                    yield
                finally:
                    if span.events is not None:
                        span.events[1].record()
                    span.end_ns = time.time_ns()
        finally:
            self._open.pop()

    def device_ms(self) -> Dict[str, float]:
        """Device ms of each span name, summed over the spans recorded
        since the last ``clear()`` (for spans captured in a CUDA graph: at
        its last replay), after a synchronise. Empty without events."""
        timed = [s for s in self.spans if s.events is not None]
        if not timed:
            return {}
        import torch

        torch.cuda.synchronize()
        out: Dict[str, float] = defaultdict(float)
        for s in timed:
            out[s.name] += s.events[0].elapsed_time(s.events[1])
        return dict(out)

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


@contextlib.contextmanager
def recording(tracer: Tracer) -> Iterator[Tracer]:
    """Send the program's spans (``stage``) to ``tracer`` for the block;
    the tracer that recorded before is restored after it."""
    global _RECORDING
    before = _RECORDING
    _RECORDING = tracer
    try:
        yield tracer
    finally:
        _RECORDING = before


def stage(name: str):
    """``with stage("flow"):``, a span of the recording tracer, or the
    shared null context while nothing records."""
    tracer = _RECORDING
    if tracer is None:
        return _NULL
    return tracer.stage(name)


@contextlib.contextmanager
def trace_to(log_dir: Optional[str]) -> Iterator[object]:
    """Capture a ``torch.profiler`` trace around the block (CPU activity,
    and the card's kernels and copies where CUDA is available), with a
    recording ``Tracer`` so that the program's spans appear in it by name,
    and write it as a Chrome trace JSON, ``trace_<pid>_<ns>.json``, under
    ``log_dir``. Yields the profiler (its ``key_averages()`` and
    ``events()``); a None or empty ``log_dir`` makes this a no-op that
    yields None."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, recording(Tracer()):
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
