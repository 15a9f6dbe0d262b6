"""Nothing the benchmark runs loads ``jax``, ``jaxlib``, ``flax`` or the
JAX package, compared by whole top-level names, and the reference imports
nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
import types
from pathlib import Path

from h100_bench import run

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "mav_detection_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_sources_import_nothing_forbidden():
    for path in HERE.rglob("*.py"):
        tops = set(_imports(path))
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        tops = set(_imports(path))
        assert "mav_detection_tpu_torch" not in tops, path
        assert tops <= {"__future__", "contextlib", "functools", "math", "typing",
                        "numpy", "torch"}, (path, tops)


def test_loaded_modules_after_a_run_are_clean():
    """A whole small run in a fresh process, then the loaded modules'
    top-level names, compared whole (``mav_detection_tpu_torch`` is not
    ``mav_detection_tpu``)."""
    code = (
        "import sys; sys.path.insert(0, 'h100_bench/tests'); sys.path.insert(0, '.')\n"
        "import torch; torch.set_num_threads(2)\n"
        "from conftest import full_bench, run_tiny\n"
        "from h100_bench import spec, run\n"
        "b = full_bench()\n"
        "for w in b['workloads']:\n"
        "    spec.traffic_kind(spec.traffic_params(w['name'])['kind'])\n"
        "for m in b['per_layer']:\n"
        "    spec.metric_reader(m['name'])\n"
        "run_tiny(b, 'midgard752-batch8-seq', traced=True)\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    loaded = set(eval(lines[-2]))
    assert "mav_detection_tpu_torch" in loaded
    assert not loaded & FORBIDDEN
    assert lines[-1] == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mav_detection_tpu_torch_extra", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "mav_detection_tpu", types.ModuleType("mav_detection_tpu"))
    assert run.forbidden_modules() == ["jax", "mav_detection_tpu"]


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "midgard752-step-b8", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
