"""The program's own stage spans in a step cell, read once per traced run
for the ``*_span_ms`` and ``*_launches`` readers: every span name that the
program's tracer recorded in the profiled step, none named here.

On the card: one eager step (``run.state["step"]``) under ``torch.profiler``
with a ``Tracer`` recording, in which each device operation (kernel, copy,
set) goes to the innermost program span whose ``record_function`` range
holds its launch (the CUDA API call, ``cuda*`` or ``cu*``, of the same
correlation id), counted per span per batch; it also warms the step up. Then
the step captured in a fresh CUDA graph while a tracer with timing events
records (the events become event-record nodes of that graph) and replayed
``REPLAYS`` times, with ``Tracer.device_ms()`` (which synchronises) after
each: a span's value is the median over the replays, in ms per frame pair.
Standard error gets the per-span counts and ms (in ``ordered``'s order), the
recording graph's replay ms beside the set-up graph's in turns (what tracing
costs when it is on), and whether the output rings still hold what the
window wrote; they are restored to it either way, so the judge reads the
window's outputs.

Off the card: three eager steps with a tracer recording, each span's
host-clock ms (the median), and the leaf CPU operations in place of device
operations (of the first step, profiled), so that a CPU rehearsal reads
every metric.

Nothing (every reader gives None) outside a step cell, where the control
stands in for the program, or where the program records no span (no
``utils.tracing.recording``).
"""
from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Optional, Tuple

import torch

REPLAYS = 20


def span_ms(run, name: str) -> Optional[float]:
    r = read(run)
    return None if r is None else r["ms"].get(name)


def launches(run, name: str) -> Optional[float]:
    r = read(run)
    return None if r is None else r["launches"].get(name)


def read(run) -> Optional[Dict[str, Dict[str, float]]]:
    """``{"ms": {span: ms per pair}, "launches": {span: operations per
    batch, its child spans' included}}``, computed once per run."""
    st = run.state
    if "spans" not in st:
        st["spans"] = _measure(run)
    return st["spans"]


def _measure(run) -> Optional[Dict[str, Dict[str, float]]]:
    st = run.state
    if "step" not in st or run.control is not None:
        return None
    try:
        from mav_detection_tpu_torch.utils.tracing import Tracer, recording
    except ImportError:
        return None
    on_card = run.device.type == "cuda"
    rings = [st["out_flow"], st["out_sc"]]
    kept = [r.clone() for r in rings]
    events, host, names = _profiled_step(st["step"], on_card, Tracer, recording)
    counts = _counts(events, on_card, set(names))
    if on_card:
        ms = _graph_ms(st, run.device, Tracer, recording)
    else:
        ms = _host_ms(st["step"], Tracer, recording, host)
    same = all(torch.allclose(k, r, rtol=0, atol=0, equal_nan=True)
               for k, r in zip(kept, rings))
    for k, r in zip(kept, rings):
        r.copy_(k)
    if not ms:
        return None
    B = st["batch"]
    inside, own, outside = counts
    unit = "device operations" if on_card else "leaf CPU operations"
    print(f"spans: {unit} per batch, inside / own: "
          + ", ".join(f"{n} {inside.get(n, 0)} / {own.get(n, 0)}" for n in names)
          + f"; outside every span {outside}", file=sys.stderr)
    print("spans: ms per pair " + ", ".join(f"{n} {ms[n] / B:.6g}" for n in names if n in ms)
          + f"; output rings unchanged: {same}", file=sys.stderr)
    return {"ms": {n: v / B for n, v in ms.items()},
            "launches": {n: float(inside[n]) for n in inside}}


def ordered(names) -> List[str]:
    """Span names once each, grouped by their top-level name in the order
    each group first opened, by name within a group (so a span comes before
    its children): flow, flow.expand, flow.iterate, detect, detect.derotate,
    detect.foe_vote, detect.masks, detect.rates."""
    names = list(names)
    first: Dict[str, int] = {}
    for n in names:
        first.setdefault(n.split(".", 1)[0], len(first))
    return sorted(dict.fromkeys(names), key=lambda n: (first[n.split(".", 1)[0]], n))


def _profiled_step(step, on_card: bool, Tracer, recording
                   ) -> Tuple[list, Dict[str, float], List[str]]:
    """The raw events of one eager step profiled with a tracer recording,
    that tracer's host ms per span, and the names of the spans it recorded
    (``ordered``)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    tracer = Tracer()
    with profile(activities=acts) as prof, recording(tracer):
        step()
        if on_card:
            torch.cuda.synchronize()
    host = {n: v * 1e3 for n, v in tracer.totals.items()}
    names = ordered(s.name for s in tracer.spans)
    return list(prof.profiler.kineto_results.events()), host, names


def _counts(events, on_card: bool, names) -> Tuple[Dict[str, int], Dict[str, int], int]:
    """Operations per span of ``names``: inside it (its child spans'
    included), its own (innermost), and outside every span."""
    cpu = torch.autograd.DeviceType.CPU
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
             if e.device_type() == cpu and e.is_user_annotation() and e.name() in names]
    if on_card:
        call = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() == cpu and e.name().startswith("cu")}
        times = [call.get(e.correlation_id()) for e in events
                 if e.device_type() != cpu and not e.is_user_annotation()]
    else:
        ops = sorted((e.start_ns(), -(e.start_ns() + e.duration_ns())) for e in events
                     if e.device_type() == cpu and not e.is_user_annotation())
        times = [s for i, (s, neg_end) in enumerate(ops)
                 if i + 1 == len(ops) or ops[i + 1][0] >= -neg_end]
    inside: Dict[str, int] = {}
    own: Dict[str, int] = {}
    outside = 0
    for t in times:
        holding = [(s, n) for s, e, n in spans if t is not None and s <= t < e]
        if not holding:
            outside += 1
            continue
        for n in {n for _, n in holding}:
            inside[n] = inside.get(n, 0) + 1
        n = max(holding)[1]
        own[n] = own.get(n, 0) + 1
    return inside, own, outside


def _graph_ms(st, device, Tracer, recording) -> Dict[str, float]:
    """Median device ms per batch of each span over ``REPLAYS`` replays of
    the step captured with a recording tracer; the replay ms of that graph
    and of the set-up graph, in turns, to standard error."""
    from h100_bench import timing

    tracer = Tracer(device)
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with recording(tracer), torch.cuda.graph(graph):
        st["step"]()
    per: List[Dict[str, float]] = []
    for _ in range(REPLAYS):
        graph.replay()
        per.append(tracer.device_ms())
    setup_graph = getattr(st["replay"], "__self__", None)
    if isinstance(setup_graph, torch.cuda.CUDAGraph):
        turns = [("set-up", setup_graph), ("recording", graph), ("recording", graph),
                 ("set-up", setup_graph)]
        print("spans: replay ms " + ", ".join(f"{k} {timing.replay_ms(g, REPLAYS):.6g}"
                                              for k, g in turns), file=sys.stderr)
    graph.reset()   # before the tracer's events, which its nodes record
    return {n: statistics.median(p[n] for p in per) for n in per[0]}


def _host_ms(step, Tracer, recording, host: Dict[str, float]) -> Dict[str, float]:
    """Median host ms per batch of each span over two recorded eager steps
    and the profiled one (``host``)."""
    per = [host]
    for _ in range(2):
        tracer = Tracer()
        with recording(tracer):
            step()
        per.append({n: v * 1e3 for n, v in tracer.totals.items()})
    return {n: statistics.median(p.get(n, 0.0) for p in per) for n in per[0]}

