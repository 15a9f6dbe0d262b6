"""The control, the reference in the program's place in the nearest
precision below float32 (TF32 matrix products, bfloat16 detection), comes
out not correct in every cell of ``BENCHMARK.json`` and ``held_out.json``,
at a size a test run holds (on the card the same readings come from
``python3 -m h100_bench.control`` at the cells' own sizes)."""
from __future__ import annotations

import pytest
from conftest import SEED, all_cells, run_tiny, tiny_config

from h100_bench.control import Control


@pytest.mark.parametrize("cell", all_cells())
def test_control_is_not_correct(bench, cell):
    cfg = tiny_config(bench, cell)
    r = run_tiny(bench, cell, control=Control(cfg, SEED, "cpu"), seed=SEED)
    assert r["correct"] is False
    assert r["checked"]["flow_epe_px"]["value"] > r["checked"]["flow_epe_px"]["limit"]
