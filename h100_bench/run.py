"""The benchmark of the PyTorch/CUDA port on one NVIDIA H100.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Runs the cell of ``BENCHMARK.json`` named
``--workload``: set-up (inputs drawn from ``--seed`` on the card, the
program built and warmed up), a measured window of ``--seconds``, and the
comparison with the plain reference that decides ``correct``. The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed`` (frame pairs), ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones, read from a
profiled slice of the same work), ``device`` and, traced, ``breakdown``;
the numbers compared with their limits come last, under ``checked``, and as
the last lines of standard error.

Exits non-zero with no result where there is no card or fewer cards than
the cell asks for, and where ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded once the window has closed.
"""
from __future__ import annotations

import time


def _process_start() -> float:
    """This process's start on the ``time.time()`` clock (from /proc where
    it can be read, else now)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        import os
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mav_detection_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not load,
    compared whole (``mav_detection_tpu_torch`` is not ``mav_detection_tpu``)."""
    loaded = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from h100_bench import harness, judge, spec

    bench = spec.benchmark()
    need = int(spec.cell(bench, args.workload)["chips"])
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < need:
        print(f"the cell needs {need} cards, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the process that reports: {', '.join(bad)}", file=sys.stderr)
        return 3
    checked = result.pop("checked")
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                        "count": need, **result["device"]}
    result["checked"] = checked
    print(json.dumps(result), flush=True)
    judge.say(checked, result["correct"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
