"""Small sizes for the benchmark's tests on the CPU: each cell's
configuration shrunk to frames of 64x96, and its traffic by its kind's
``TINY`` (rings of a few pairs), so that a whole run (set-up, window,
comparison) takes seconds. The cells held out of ``BENCHMARK.json``
(``held_out.json``) are tested with the rest; the tests' lists of cells are
derived from both files."""
from __future__ import annotations

import json
import time

import pytest
import torch

from h100_bench import harness, spec

H, W = 64, 96
SEED = 2 ** 31 + 17


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


def all_cells():
    """Every cell of ``BENCHMARK.json`` and ``held_out.json``."""
    return [w["name"] for w in full_bench()["workloads"]]


def one_cell_per_path():
    """One cell (the first) for each pair of traffic kind and flow
    reference that the cells use."""
    b = full_bench()
    first = {}
    for w in b["workloads"]:
        kind = spec.traffic_params(w["name"])["kind"]
        reference = spec.flow_reference(spec.config(b, w["config"])).__name__
        first.setdefault((kind, reference), w["name"])
    return list(first.values())


def tiny_config(bench, cell):
    cfg = spec.config(bench, spec.cell(bench, cell)["config"])
    cfg = dict(cfg, height=H, width=W, sequence_frames=10, foe_samples=64)
    cfg["scene"] = dict(cfg["scene"], drone_radius=5.0, max_flow_px=3.0)
    return cfg


def tiny_params(cell):
    p = dict(spec.traffic_params(cell))
    p.update(spec.traffic_kind(p["kind"]).TINY)
    return p


def run_tiny(bench, cell, traced=False, control=None, seed=SEED, seconds=0.2):
    return harness.run_cell(bench, cell, seed, seconds, traced, "cpu", time.time(),
                            config=tiny_config(bench, cell), params=tiny_params(cell),
                            control=control)


@pytest.fixture
def cuda_device():
    """The card, decided here and not at import: skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")
