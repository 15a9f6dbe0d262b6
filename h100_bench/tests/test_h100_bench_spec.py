"""BENCHMARK.json and every file it names load, and each cell's metrics and
their arrows are consistent with the contract."""
from __future__ import annotations

import json
import re

import pytest

from h100_bench import judge, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("height", "width", "winsize", "poly_n", "foe_samples")


def test_top_level_keys():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["h100_bench"]
    assert bench["command"][:3] == ["python3", "-m", "h100_bench.run"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_lengths(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] == 1
    for c in bench["configs"]:
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200


def test_configs_and_traffic_files(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
        cfg = spec.config(bench, c["name"])
        assert cfg["name"] == c["name"]
        for key in c["reduced"]:
            assert key in cfg and key not in WIDTHS
        for key in ("height", "width", "flow", "foe_samples", "sequence_frames", "scene",
                    "depth", "imu", "gt_foe"):
            assert key in cfg, (c["name"], key)
    pairs = set()
    for w in bench["workloads"]:
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        params = spec.traffic_params(w["name"])
        kind = spec.traffic_kind(params["kind"])
        for fn in ("prepare", "window", "traced", "pairs", "release"):
            assert callable(getattr(kind, fn)), (w["name"], fn)
        assert set(params["limits"]) == set(judge.NUMBERS)
        assert params["limits"]["missing"] == 0


def test_each_cell_reports_setup_another_metric_and_a_layer(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        reported = [m["name"] for m in spec.end_to_end(bench, w["name"])]
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        layers = spec.per_layer(bench, w["name"])
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in reported, (w["name"], m["name"])


@pytest.mark.parametrize("kind", ["layer", "reader"])
def test_per_layer_metrics(bench, kind):
    cells = {w["name"] for w in bench["workloads"]}
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert set(m.get("workloads", [])) <= cells
        if kind == "layer":
            layers.setdefault(m["layer"], []).append(m["name"])
            assert 1 <= len(m["layer"]) <= 200
        else:
            assert callable(spec.metric_reader(m["name"]))
        if m["unit"] == "%":
            assert m["name"].endswith("_roofline") or "mfu" in m["name"]


def test_benchmark_alone_is_consistent():
    """BENCHMARK.json without the held-out cells: every metric's cells are
    its cells, and each of them reports what the metric moves."""
    bench = spec.benchmark()
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    for w in cells:
        reported = [m["name"] for m in spec.end_to_end(bench, w)]
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.per_layer(bench, w)
