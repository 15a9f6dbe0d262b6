"""The port's tracer (``utils/tracing.py``) and the stage spans of the Flow
layer and the detection step: the null path while nothing records, the
spans' names, parents, steps and stamps, their device events (faked on the
CPU, real in a replayed CUDA graph on the card), and outputs that do not
depend on whether a tracer records.

The card test (``-m cuda``) skips without one; on a machine with one:

    python -m pytest --noconftest tests/test_torch_tracing.py -q -m cuda
"""
import contextlib
import glob
import json
import time
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from mav_detection_tpu_torch.ops.flow.farneback import (
    _pyramid_scales,
    farneback_flow_batch,
    tuned_flow_params,
)
from mav_detection_tpu_torch.pipeline.detector import (
    DetectionStep,
    detect_frame_batch_scalars,
    pack_frame_scalars,
)
from mav_detection_tpu_torch.utils import tracing
from mav_detection_tpu_torch.utils.tracing import Tracer, recording, stage, trace_to

torch.set_num_threads(1)

# each program span and its parent's name
SPANS = {"flow": None, "flow.expand": "flow", "flow.iterate": "flow",
         "detect": None, "detect.derotate": "detect", "detect.foe_vote": "detect",
         "detect.masks": "detect", "detect.rates": "detect"}
N_SAMPLES = 64


def _inputs(dev, b=2, h=48, w=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    frames = torch.rand(b + 1, h, w, generator=g) * 255
    seg = torch.zeros(b, h, w, dtype=torch.uint8)
    seg[:, 10:20, 20:34] = 255
    sky = torch.zeros(b, h, w, dtype=torch.bool)
    sky[:, :8] = True
    syx = torch.stack([torch.randint(0, h, (b, 2 * N_SAMPLES), generator=g),
                       torch.randint(0, w, (b, 2 * N_SAMPLES), generator=g)], -1)
    d = dict(prev=frames[:-1], curr=frames[1:], gt_flow=torch.zeros(b, h, w, 2),
             omega=torch.randn(b, 3, generator=g) * 0.01, dt=torch.full((b,), 1 / 30),
             seg=seg, sky=sky, depth=torch.rand(b, h, w, generator=g) + 1.0,
             gt_foe=torch.tensor([[w / 2, h / 2]] * b), syx=syx)
    return {k: v.to(dev) for k, v in d.items()}


def _step(x, dev):
    """The benchmark's step: the product flow, then the detection step's
    scalars packed; (flow, packed)."""
    flow = farneback_flow_batch(x["prev"], x["curr"], None, dev)
    s = detect_frame_batch_scalars(flow, x["gt_flow"], x["omega"], x["dt"], x["seg"],
                                   x["sky"], x["depth"], x["gt_foe"], sample_yx=x["syx"],
                                   config=DetectionStep(foe_samples=N_SAMPLES))
    return flow, pack_frame_scalars(s)


def _levels(x):
    h, w = x["prev"].shape[1:]
    return len(_pyramid_scales(h, w, tuned_flow_params(h, w)))


def _counting(monkeypatch):
    """Count what a span may touch: ``record_function`` entries, CUDA
    events made, and the tracer module's clock reads."""
    counts = Counter()
    real_rf = torch.profiler.record_function

    def record_function(name, *a, **k):
        counts["record_function"] += 1
        return real_rf(name, *a, **k)

    def event(*a, **k):
        counts["Event"] += 1
        return FakeEvent(*a, **k)

    def clock(name, fn):
        def read():
            counts[name] += 1
            return fn()
        return read

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(tracing, "time", SimpleNamespace(
        perf_counter=clock("perf_counter", time.perf_counter),
        time_ns=clock("time_ns", time.time_ns)))
    return counts


class FakeEvent:
    """A CUDA timing event on the host clock, for the CPU: ``record`` stamps,
    ``elapsed_time`` gives ms between two stamps."""

    def __init__(self, enable_timing=False, blocking=False, interprocess=False,
                 external=False):
        assert enable_timing and external
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.mark.parametrize("records", [False, True])
def test_stage_costs_nothing_unless_a_tracer_records(monkeypatch, records):
    """With nothing recording, ``stage`` is one shared null context and the
    flow and detection step enter no ``record_function``, make no CUDA
    event and read no clock; a recording tracer on the CPU enters one
    ``record_function`` a span and makes no event."""
    x = _inputs("cpu")
    assert stage("flow") is stage("detect")
    counts = _counting(monkeypatch)
    tracer = Tracer()
    if records:
        with recording(tracer):
            _step(x, "cpu")
        assert counts["record_function"] == len(tracer.spans) > 0
        assert counts["Event"] == 0
    else:
        _step(x, "cpu")
        assert counts == Counter()
        assert tracer.spans == [] and not tracer.totals


def test_outputs_do_not_depend_on_recording():
    x = _inputs("cpu")
    flow0, packed0 = _step(x, "cpu")
    with recording(Tracer()):
        flow1, packed1 = _step(x, "cpu")
    assert torch.equal(flow0, flow1) and torch.equal(packed0, packed1)


def test_recorded_step_names_parents_and_one_step_id():
    """Inside a caller's outermost span, the step records exactly the
    program's spans, each under its parent, all with the caller's step
    identifier; ``flow.expand`` and ``flow.iterate`` once a pyramid layer,
    each ``detect.*`` stage once."""
    x = _inputs("cpu")
    tracer = Tracer()
    with recording(tracer):
        with tracer.stage("step"):
            _step(x, "cpu")
    spans = tracer.spans
    assert spans[0].name == "step" and spans[0].parent is None
    program = spans[1:]
    assert {s.name for s in program} == set(SPANS)
    for s in program:
        want = SPANS[s.name] or "step"
        assert spans[s.parent].name == want, s.name
        assert spans[s.parent].start_ns <= s.start_ns <= s.end_ns <= spans[s.parent].end_ns
    assert {s.step for s in spans} == {spans[0].step}
    n = Counter(s.name for s in program)
    levels = _levels(x)
    assert n == Counter({"flow": 1, "flow.expand": levels, "flow.iterate": levels,
                         "detect": 1, "detect.derotate": 1, "detect.foe_vote": 1,
                         "detect.masks": 1, "detect.rates": 1})
    assert tracer.counts == {"step": 1, **n}
    assert tracer.device_ms() == {}


def test_each_outermost_span_starts_a_step_and_clear_forgets():
    x = _inputs("cpu")
    tracer = Tracer()
    with recording(tracer):
        _step(x, "cpu")
    by_root = {}
    for s in tracer.spans:
        root = s
        while root.parent is not None:
            root = tracer.spans[root.parent]
        by_root.setdefault(root.name, set()).add(s.step)
    assert set(by_root) == {"flow", "detect"}
    assert all(len(ids) == 1 for ids in by_root.values())
    assert by_root["flow"] != by_root["detect"]
    tracer.clear()
    assert tracer.spans == [] and not tracer.totals and tracer.device_ms() == {}


def test_recording_nests_and_restores():
    a, b = Tracer(), Tracer()
    with recording(a):
        with recording(b):
            with stage("flow"):
                pass
        with stage("detect"):
            pass
    assert [s.name for s in a.spans] == ["detect"]
    assert [s.name for s in b.spans] == ["flow"]
    assert stage("flow") is stage("detect")


def test_span_stamps_lie_inside_their_record_function():
    """Each span's host stamps, on the profiler's clock, lie inside the
    ``record_function`` range of its name that a CPU profile holds."""
    from torch.profiler import ProfilerActivity, profile

    x = _inputs("cpu")
    tracer = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof, recording(tracer):
        _step(x, "cpu")
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name() in SPANS:
            ranges.setdefault(e.name(), []).append((e.start_ns(),
                                                    e.start_ns() + e.duration_ns()))
    for name in SPANS:
        mine = [(s.start_ns, s.end_ns) for s in tracer.spans if s.name == name]
        theirs = sorted(ranges[name])
        assert len(mine) == len(theirs), name
        for (s, e), (r0, r1) in zip(mine, theirs):
            assert r0 <= s <= e <= r1, name


def test_trace_to_names_the_program_spans(tmp_path):
    x = _inputs("cpu")
    with trace_to(str(tmp_path / "tr")):
        _step(x, "cpu")
    [path] = glob.glob(str(tmp_path / "tr" / "trace_*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(SPANS) <= names
    assert stage("flow") is stage("detect")


def test_device_ms_sums_each_name_over_its_events(monkeypatch):
    """On a CUDA tracer each span records a start and an end event (timing,
    external); ``device_ms`` sums the elapsed ms by name (here on fake
    events that stamp the host clock)."""
    counts = _counting(monkeypatch)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    x = _inputs("cpu")
    tracer = Tracer("cuda")
    with recording(tracer):
        _step(x, "cpu")
    assert counts["Event"] == 2 * len(tracer.spans)
    ms = tracer.device_ms()
    assert set(ms) == set(SPANS)
    for name in SPANS:
        want = sum(s.events[0].elapsed_time(s.events[1]) for s in tracer.spans
                   if s.name == name)
        assert ms[name] == pytest.approx(want, rel=1e-12) and ms[name] > 0
    assert ms["flow.expand"] + ms["flow.iterate"] <= ms["flow"]
    children = [n for n, p in SPANS.items() if p == "detect"]
    assert sum(ms[n] for n in children) <= ms["detect"]


@pytest.mark.cuda
def test_recording_graph_replays_equal_and_reads_each_span():
    """A CUDA graph of the step captured while a tracer records replays to
    the outputs of one captured with nothing recording, bit for bit; each
    span's ``device_ms()`` after a replay is > 0, each child at most its
    parent, ``detect``'s children together at most ``detect``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    from mav_detection_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    x = _inputs(dev, b=4, h=240, w=376)
    outs = {}

    def capture(tracer):
        slot = outs.setdefault(tracer is not None, [None, None])

        def step():
            flow, packed = _step(x, dev)
            slot[0], slot[1] = flow, packed

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with (recording(tracer) if tracer is not None else contextlib.nullcontext()):
            with torch.cuda.graph(graph):
                step()
        return graph

    plain = capture(None)
    tracer = Tracer(dev)
    traced = capture(tracer)
    for _ in range(2):
        plain.replay()
        traced.replay()
        ms = tracer.device_ms()
        assert torch.equal(outs[False][0], outs[True][0])
        assert torch.equal(outs[False][1], outs[True][1])
        assert set(ms) == set(SPANS)
        assert all(v > 0 for v in ms.values()), ms
        for name, parent in SPANS.items():
            if parent is not None:
                assert ms[name] <= ms[parent], (name, ms)
        assert ms["flow.expand"] + ms["flow.iterate"] <= ms["flow"]
        assert sum(v for n, v in ms.items() if SPANS[n] == "detect") <= ms["detect"]
    traced.reset()
