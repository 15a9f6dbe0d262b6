"""Small sizes for the benchmark's tests on the CPU: each cell's
configuration and traffic shrunk to frames of 64x96 and rings of a few
pairs, so that a whole run (set-up, window, comparison) takes seconds. The
cells held out of ``BENCHMARK.json`` (``held_out.json``) are tested with
the rest."""
from __future__ import annotations

import json
import time

import pytest
import torch

from h100_bench import harness, spec

H, W = 64, 96


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def full_bench():
    """``BENCHMARK.json`` with the held-out cells and their metrics."""
    b = spec.benchmark()
    with open(spec.HERE / "held_out.json") as f:
        held = json.load(f)
    for key in ("workloads", "end_to_end", "per_layer"):
        b[key] = b[key] + held[key]
    return b


@pytest.fixture
def bench():
    return full_bench()


def tiny_config(bench, cell):
    cfg = spec.config(bench, spec.cell(bench, cell)["config"])
    cfg = dict(cfg, height=H, width=W, sequence_frames=10, foe_samples=64)
    cfg["scene"] = dict(cfg["scene"], drone_radius=5.0, max_flow_px=3.0)
    return cfg


def tiny_params(cell):
    p = dict(spec.traffic_params(cell))
    if p["kind"] == "step":
        p.update(ring_bytes=2 * p["batch"] * H * W, chunk_s=0.02, trace_s=0.05,
                 check_slots=1)
    else:
        p.update(ring_extra=3, batch=min(p["batch"], 4), min_seqs=2, check_seqs=1,
                 check_calls=2, trace_seqs=1)
    return p


def run_tiny(bench, cell, traced=False, control=None, seed=2 ** 31 + 17, seconds=0.2):
    return harness.run_cell(bench, cell, seed, seconds, traced, "cpu", time.time(),
                            config=tiny_config(bench, cell), params=tiny_params(cell),
                            control=control)


@pytest.fixture
def cuda_device():
    """The card, decided here and not at import: skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")
