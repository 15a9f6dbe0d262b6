"""What ``BENCHMARK.json`` names, found by name.

A configuration is ``configs/<config>.json``, a cell's traffic
``workloads/<cell>.json`` (its ``kind`` names the generator
``traffic/<kind>.py``), a per-layer metric's reader ``metrics/<metric>.py``
(a function ``read(ctx)`` giving the value, or None where the run has
nothing to read), and the flow reference a configuration is judged against
``reference/<name>.py``, named by the configuration's ``flow_reference``
(``farneback`` where it names none; ``reference/__init__.py`` gives the
module's contract). A later cell, configuration, metric or reference is
added with files and entries of its own; nothing here names one. A name
that has no file raises: nothing falls back to another.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the directories searched, in order, for ``workloads/``, ``traffic/``,
# ``metrics/`` and ``reference/`` files; the tests add one of test-only files
ROOTS = (HERE,)
FLOW_REFERENCE = "farneback"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _load_json(root / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def _named(sub: str, name: str, suffix: str) -> Path:
    """``<root>/<sub>/<name><suffix>`` in the first of ``ROOTS`` that holds it."""
    if not NAME.match(name):
        raise KeyError(f"{name!r} is not a name")
    for root in ROOTS:
        path = root / sub / f"{name}{suffix}"
        if path.is_file():
            return path
    raise KeyError(f"no {sub}/{name}{suffix} under {', '.join(map(str, ROOTS))}")


def traffic_params(cell_name: str) -> Dict:
    return _load_json(_named("workloads", cell_name, ".json"))


def _module(path: Path, name: str) -> ModuleType:
    """The module of ``path``, loaded once per process under ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _named_module(sub: str, name: str) -> ModuleType:
    return _module(_named(sub, name, ".py"), f"h100_bench.{sub}.{name}")


def traffic_kind(kind: str) -> ModuleType:
    return _named_module("traffic", kind)


def metric_reader(name: str):
    return _named_module("metrics", name).read


def flow_reference(config: Dict) -> ModuleType:
    """The module of the flow reference the configuration names
    (``flow_reference``, else ``farneback``): ``flow``, ``weights`` and
    ``CONTROL_PRECISION``."""
    return _named_module("reference", config.get("flow_reference", FLOW_REFERENCE))


def _applies(metric: Dict, cell_name: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def end_to_end(bench: Dict, cell_name: str) -> List[Dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"] if _applies(m, cell_name, [])]


def per_layer(bench: Dict, cell_name: str) -> List[Dict]:
    """The per-layer metrics the cell reports: those listing it, and those
    without a list whose end-to-end metric the cell reports."""
    reported = [m["name"] for m in end_to_end(bench, cell_name)]
    return [m for m in bench["per_layer"] if _applies(m, cell_name, reported)]
