"""The device trace of a traced slice, reduced to what the result reports.

``Profiled`` runs ``torch.profiler`` (CPU and CUDA activity) around a
slice of work inside one CPU span, ``SLICE``. ``reduce`` turns the raw
events into: the slice's wall seconds (``window_s``), the seconds in which
a device operation (kernel, copy or set) ran (``busy_s``, the union of
their intervals), the device operations that took the most time by name,
and the device's idle gaps summed by what the host was doing meanwhile (the
CPU operation that overlaps the gap most; of those that overlap it at least
half as much, the shortest).
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

SLICE = "h100_bench.slice"
TOP = 10


def _raw_events(prof) -> List[Tuple[str, bool, int, int]]:
    """(name, on_device, start_ns, end_ns) of every event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() != torch.autograd.DeviceType.CPU
        if dev and e.is_user_annotation():
            continue     # a CPU span's mirror on the device timeline
        start = int(e.start_ns())
        out.append((e.name(), dev, start, start + int(e.duration_ns())))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def reduce(events: List[Tuple[str, bool, int, int]]) -> Optional[Dict]:
    """The slice's numbers from raw events, or None without the SLICE span
    or without any device operation in it."""
    spans = [(s, e) for name, dev, s, e in events if name == SLICE and not dev]
    if not spans:
        return None
    w0, w1 = spans[0]
    dev_ops = [(n, max(s, w0), min(e, w1)) for n, dev, s, e in events
               if dev and n != SLICE and e > w0 and s < w1]
    if not dev_ops:
        return None
    by_op: Dict[str, int] = defaultdict(int)
    for n, s, e in dev_ops:
        by_op[n] += e - s
    busy = _union([(s, e) for _, s, e in dev_ops])
    busy_ns = sum(e - s for s, e in busy)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    host = sorted((s, e, n) for n, dev, s, e in events
                  if not dev and n != SLICE and e > w0 and s < w1)
    by_gap: Dict[str, int] = defaultdict(int)
    active: List[Tuple[int, int, str]] = []
    nxt = 0
    for g0, g1 in gaps:          # in order: a sweep over the host events
        while nxt < len(host) and host[nxt][0] < g1:
            active.append(host[nxt])
            nxt += 1
        active = [ev for ev in active if ev[1] > g0]
        best: List[Tuple[int, int, str]] = []
        for s, e, n in active:
            ov = min(e, g1) - max(s, g0)
            if ov > 0:
                best.append((ov, e - s, n))
        if not best:
            by_gap["(no host operation)"] += g1 - g0
            continue
        top = max(ov for ov, _, _ in best)
        name = min((d, n) for ov, d, n in best if 2 * ov >= top)[1]
        by_gap[name] += g1 - g0

    def ranked(d: Dict[str, int]) -> List[List]:
        return [[n, v / 1e9] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "device_ops": ranked(by_op), "idle_gaps": ranked(by_gap)}


class Profiled:
    """``with Profiled(dev) as p: ...`` profiles the block inside the SLICE
    span (synchronised at both ends on a card); ``p.result`` is ``reduce``'s
    answer afterwards."""

    def __init__(self, device: torch.device) -> None:
        self.device = torch.device(device)
        self.result: Optional[Dict] = None
        self._stack: Optional[contextlib.ExitStack] = None
        self._prof = None

    def __enter__(self) -> "Profiled":
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._stack = contextlib.ExitStack()
        self._prof = self._stack.enter_context(profile(activities=acts))
        self._stack.enter_context(record_function(SLICE))
        return self

    def __exit__(self, *exc) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self._stack.close()
        if exc[0] is None:
            self.result = reduce(_raw_events(self._prof))

