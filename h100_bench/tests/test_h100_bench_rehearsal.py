"""The last line of a small CPU rehearsal of each traffic kind, traced and
not: its keys, the cell's metrics, and the numbers compared last."""
from __future__ import annotations

import json

import pytest
from conftest import one_cell_per_path, run_tiny

from h100_bench import judge, spec

CELLS = one_cell_per_path()


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line_schema(bench, cell, traced):
    r = run_tiny(bench, cell, traced=traced)
    json.dumps(r, allow_nan=False)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checked"
    assert r["correct"] is True
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checked"]) == set(judge.NUMBERS)
    for v in r["checked"].values():
        assert set(v) == {"value", "limit"}
    want = spec.per_layer(bench, cell) if traced else spec.end_to_end(bench, cell)
    units = {m["name"]: m["unit"] for m in want}
    assert set(r["metrics"]) <= set(units)
    for name, m in r["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    if not traced:
        # a CPU run reports no device number, but every end-to-end metric
        assert set(r["metrics"]) == set(units)
    else:
        # the device metrics are not measured on the CPU; the host counters are
        device_only = {m["name"] for m in want if m["source"] == "device_trace"}
        assert set(r["metrics"]) == set(units) - device_only


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_card_run_reports_device_metrics(bench, cell, cuda_device):
    """On the card, at the small size: correct, and the traced run reads
    the device (its busy time and every per-layer metric of the cell)."""
    import time

    from conftest import tiny_config, tiny_params

    from h100_bench import harness
    r = harness.run_cell(bench, cell, 2 ** 31 + 99, 0.5, True, cuda_device, time.time(),
                         config=tiny_config(bench, cell), params=tiny_params(cell))
    assert r["correct"] is True
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert set(r["metrics"]) == {m["name"] for m in spec.per_layer(bench, cell)}
