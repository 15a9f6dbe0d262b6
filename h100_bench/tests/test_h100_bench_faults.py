"""A run with the timed path broken underneath comes out not correct: once
for each fault a cell can have. An answer altered where it is made (one
frame's FoE moved by 7.5 px as its scalars are packed); half of a batch
left out, its lanes given the mean flow of the rest (the cells that batch
pairs); a step that returns its state unchanged (every flow call answers
with the previous call's flow). One card: no exchange between chips to leave
out. The harness's look for a card is skipped: the runs are on the CPU."""
from __future__ import annotations

import pytest
import torch
from conftest import run_tiny

from h100_bench import spec
from mav_detection_tpu_torch.pipeline import processor as processor_mod
from mav_detection_tpu_torch.pipeline import temporal as temporal_mod

CELLS = ["midgard752-step-b8", "midgard752-batch8-seq", "airsim1920-scan-seq"]


def _flow_sites(bench, cell):
    """(module, name) of the flow function the cell's timed path calls."""
    kind = spec.traffic_params(cell)["kind"]
    if kind == "step":
        return [(spec.traffic_kind("step"), "farneback_flow_batch")]
    return [(processor_mod, "_farneback_cf"), (temporal_mod, "_farneback_cf")]


def _altered(pack):
    def packed(s):
        out = pack(s).clone()
        out[0, 0] += 7.5
        return out
    return packed


def _half_batch(fn):
    def flow(prev, curr, *args):
        k = prev.shape[0] // 2
        out = fn(prev[:k], curr[:k], *args)
        rest = out.mean(0, keepdim=True).expand((prev.shape[0] - k,) + out.shape[1:])
        return torch.cat([out, rest])
    return flow


def _stale(fn):
    last = []

    def flow(prev, curr, *args):
        out = fn(prev, curr, *args)
        if not last or last[0].shape != out.shape:
            last[:] = [out.clone()]
            return out
        stale, last[0] = last[0], out.clone()
        return stale
    return flow


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered(bench, cell, monkeypatch):
    sites = [(spec.traffic_kind("step"), "pack_frame_scalars"), (processor_mod, "pack_frame_scalars")]
    for mod, name in sites:
        monkeypatch.setattr(mod, name, _altered(getattr(mod, name)))
    r = run_tiny(bench, cell)
    assert r["correct"] is False
    assert r["checked"]["foe_snap_px"]["value"] > r["checked"]["foe_snap_px"]["limit"]


@pytest.mark.parametrize("cell", ["midgard752-step-b8", "midgard752-batch8-seq"])
def test_half_batch_left_out(bench, cell, monkeypatch):
    for mod, name in _flow_sites(bench, cell):
        monkeypatch.setattr(mod, name, _half_batch(getattr(mod, name)))
    r = run_tiny(bench, cell)
    assert r["correct"] is False
    assert r["checked"]["flow_epe_px"]["value"] > r["checked"]["flow_epe_px"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_state_unchanged(bench, cell, monkeypatch):
    for mod, name in _flow_sites(bench, cell):
        monkeypatch.setattr(mod, name, _stale(getattr(mod, name)))
    r = run_tiny(bench, cell)
    assert r["correct"] is False
    assert r["checked"]["flow_epe_px"]["value"] > r["checked"]["flow_epe_px"]["limit"]
