"""What a configuration names is what it is judged against: the flow
reference found by name (``spec.flow_reference``), its weights drawn by
the judge from the seed, its control, the spans the program records, and
the tests' small sizes and fault sites from the traffic kind. A learned-flow
configuration is wired in with new files only: the test-only configuration,
traffic kind and references under ``toy/`` are judged, traced, controlled
and fault-tested through the same harness, judge, control, spans and
conftest as the cells of ``BENCHMARK.json``."""
from __future__ import annotations

import json
import math
import random
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import SEED, full_bench, run_tiny, tiny_config, tiny_params
from test_h100_bench_faults import _altered, _half_batch, _stale

from h100_bench import harness, judge, spans, spec
from h100_bench.control import Control
from h100_bench.reference import farneback as ref_farneback
from mav_detection_tpu_torch.utils import tracing

TOY = Path(__file__).resolve().parent / "toy"
STEP_CELL = "midgard752-step-b8"
EIGHT = ("flow", "flow.expand", "flow.iterate", "detect", "detect.derotate",
         "detect.foe_vote", "detect.masks", "detect.rates")


@pytest.fixture
def toy(monkeypatch):
    """The benchmark with the test-only cell ``toy-step``, and ``toy/``
    searched after the harness's own directories."""
    monkeypatch.setattr(spec, "ROOTS", spec.ROOTS + (TOY,))
    b = full_bench()
    with open(TOY / "bench.json") as f:
        extra = json.load(f)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        b[key] = b[key] + extra[key]
    return b


def _run(bench, cell, config=None, params=None, traced=False, seed=SEED):
    return harness.run_cell(bench, cell, seed, 0.2, traced, "cpu", time.time(),
                            config=config if config is not None else tiny_config(bench, cell),
                            params=params if params is not None else tiny_params(cell))


def _prepared(bench, cell, seed=SEED):
    """A tiny run of ``cell`` through its window, for the tests that read
    its state."""
    run = harness.Run(cell=cell, seed=seed, seconds=0.2, device=torch.device("cpu"),
                      config=tiny_config(bench, cell), params=tiny_params(cell))
    kind = spec.traffic_kind(run.params["kind"])
    kind.prepare(run)
    kind.window(run)
    return run, kind


@pytest.mark.parametrize("offset_px, correct", [(0.0, True), (0.01, False)])
def test_named_reference_judges_the_flow(toy, offset_px, correct):
    """The program's Farneback flow against a reference that returns that
    same flow, and against one 0.01 px off."""
    cfg = dict(tiny_config(toy, STEP_CELL), flow_reference="program_farneback",
               offset_px=offset_px)
    r = _run(toy, STEP_CELL, config=cfg)
    epe = r["checked"]["flow_epe_px"]
    assert r["correct"] is correct
    if correct:
        assert epe["value"] == 0.0
    else:
        assert epe["value"] > epe["limit"]
        assert epe["value"] == pytest.approx(offset_px, rel=1e-3)


@pytest.mark.parametrize("name", ["no_such_reference", "../judge", ""])
def test_unknown_reference_raises_before_set_up(bench, name, monkeypatch):
    def prepare(run):
        raise AssertionError("set-up ran")
    monkeypatch.setattr(spec.traffic_kind("step"), "prepare", prepare)
    cfg = dict(tiny_config(bench, STEP_CELL), flow_reference=name)
    with pytest.raises(KeyError):
        _run(bench, STEP_CELL, config=cfg)


@pytest.mark.parametrize("offset, correct", [(0, True), (1, False)])
def test_weights_come_from_the_seed(toy, offset, correct):
    """A program that draws its weights from seed + 1 is not correct; the
    same program drawing from the seed is."""
    params = dict(tiny_params("toy-step"), program_seed_offset=offset)
    r = _run(toy, "toy-step", params=params)
    epe = r["checked"]["flow_epe_px"]
    assert r["correct"] is correct
    assert (epe["value"] <= epe["limit"]) is correct


def test_weights_are_drawn_from_the_seed_alone(toy):
    ref = spec.flow_reference(tiny_config(toy, "toy-step"))
    a, b = ref.weights({}, SEED, "cpu"), ref.weights({}, SEED, "cpu")
    other = ref.weights({}, SEED + 1, "cpu")
    assert set(a) == set(b) == {"scale", "bias"}
    for k in a:
        assert a[k].dtype == torch.float32
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], other[k])
    assert ref_farneback.weights({}, SEED, "cpu") is None


def test_default_reference_is_farneback_by_hand(bench):
    """The default reference's ``flow_epe_px`` equals the worst pair's mean
    end-point distance to ``reference.farneback.flow`` on gray frames,
    worked out here in the judge's batches."""
    cfg = tiny_config(bench, STEP_CELL)
    assert "flow_reference" not in cfg
    assert spec.flow_reference(cfg) is ref_farneback
    run, kind = _prepared(bench, STEP_CELL)
    pairs = kind.pairs(run)
    worst = 0.0
    for b0 in range(0, len(pairs), judge.BATCH):
        batch = pairs[b0:b0 + judge.BATCH]
        prev = torch.stack([ref_farneback.gray(torch.from_numpy(p.prev)[None])[0]
                            for p in batch])
        curr = torch.stack([ref_farneback.gray(torch.from_numpy(p.curr)[None])[0]
                            for p in batch])
        ref = ref_farneback.flow(prev, curr, cfg)
        prog = torch.stack([p.flow for p in batch])
        epe = torch.linalg.vector_norm(prog - ref, dim=-1).mean(dim=(1, 2))
        worst = max(worst, float(epe.max()))
    numbers = judge.judge(pairs, cfg, SEED, "cpu")
    assert numbers["flow_epe_px"] == worst


def test_gray_is_bt601_rounded_half_to_even():
    """The reference's gray of BGR frames is the cameras' conversion: BT.601
    weights in float32, rounded half to even (numpy's)."""
    rng = np.random.default_rng(5)
    bgr = rng.integers(0, 256, (3, 40, 50, 3), dtype=np.uint8)
    x = bgr.astype(np.float32)
    want = np.round(0.114 * x[..., 0] + 0.587 * x[..., 1] + 0.299 * x[..., 2]).astype(np.uint8)
    got = ref_farneback.gray(torch.from_numpy(bgr))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    g = torch.from_numpy(want)
    assert ref_farneback.gray(g) is g


def test_spans_are_what_the_program_records(bench):
    """Today's step records the eight spans, and they print in their
    order whatever order they opened in."""
    run, _ = _prepared(bench, STEP_CELL)
    r = spans.read(run)
    assert set(r["ms"]) == set(EIGHT)
    assert set(r["launches"]) == set(EIGHT)
    shuffled = list(EIGHT)
    random.Random(3).shuffle(shuffled)
    shuffled.remove("flow")
    shuffled.insert(0, "flow")      # the first to open is the outermost flow span
    assert spans.ordered(shuffled + shuffled[:3]) == list(EIGHT)


def test_a_ninth_span_is_counted_and_timed(bench, monkeypatch):
    step = spec.traffic_kind("step")
    orig = step.farneback_flow_batch

    def flow(*args, **kwargs):
        with tracing.stage("source"):
            return orig(*args, **kwargs)
    monkeypatch.setattr(step, "farneback_flow_batch", flow)
    run, _ = _prepared(bench, STEP_CELL)
    r = spans.read(run)
    assert set(r["ms"]) == set(EIGHT) | {"source"}
    assert r["launches"]["source"] >= r["launches"]["flow"] > 0
    assert r["ms"]["source"] >= r["ms"]["flow"] > 0


def test_a_new_model_is_judged_traced_and_controlled(toy):
    """The toy cell: its traced run is correct and reads the program's
    detection spans; its control is not correct."""
    r = run_tiny(toy, "toy-step", traced=True)
    assert r["correct"] is True and r["failed"] == 0
    assert {"detect_span_ms", "detect_launches"} <= set(r["metrics"])
    assert "flow_span_ms" not in r["metrics"]       # the toy flow records no span
    cfg = tiny_config(toy, "toy-step")
    c = run_tiny(toy, "toy-step", control=Control(cfg, SEED, "cpu"), seed=SEED)
    assert c["correct"] is False
    assert c["checked"]["flow_epe_px"]["value"] > c["checked"]["flow_epe_px"]["limit"]


@pytest.mark.parametrize("fault", ["altered", "half_batch", "stale"])
def test_a_new_model_is_fault_tested(toy, fault, monkeypatch):
    """The planted faults of ``test_h100_bench_faults`` at the toy kind's
    own flow sites."""
    if fault == "altered":
        mod = spec.traffic_kind("step")
        monkeypatch.setattr(mod, "pack_frame_scalars", _altered(mod.pack_frame_scalars))
        number = "foe_snap_px"
    else:
        wrap = _half_batch if fault == "half_batch" else _stale
        for mod, name in spec.traffic_kind("toy_step").FLOW_SITES:
            monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
        number = "flow_epe_px"
    r = run_tiny(toy, "toy-step")
    assert r["correct"] is False
    value = r["checked"][number]["value"]
    assert math.isfinite(value) and value > r["checked"][number]["limit"]
