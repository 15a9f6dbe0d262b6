"""Readings for the limits of the comparison that decides ``correct``.

    python3 -m h100_bench.control --workload <cell> --seeds 1,2,3 --side control [--seconds 2]

runs the cell once per seed in one process, each with a short window, and
prints one JSON line per seed with the numbers the judge compared.
``--side program`` runs the program (the sound readings, from which each
limit's lower reading comes). ``--side control`` puts the control in the
program's place (from which each limit's upper reading comes): the
reference itself, computed in the nearest precision below the one the
configuration states, float32: its matrix products (the Farneback
pyramid's) in TF32, and its other float32 work (the solver's iterations
stay float32; the detection math) in bfloat16. The benchmark's own runs
never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace
from typing import Dict, Mapping

import torch

from h100_bench import harness, spec
from h100_bench.reference import detect as ref_detect
from h100_bench.reference import farneback as ref_flow


class Control:
    """The reference in the program's place: ``flow`` where the program's
    flow function is called, ``detect`` where its detection step is (the
    same arguments; the per-frame scalars under the program's names)."""

    def __init__(self, flow_params: Mapping, num_samples: int) -> None:
        self.flow_params, self.num_samples = flow_params, num_samples

    def flow(self, prev: torch.Tensor, curr: torch.Tensor) -> torch.Tensor:
        return ref_flow.flow(prev, curr, self.flow_params, "tf32")

    def detect(self, flow, gt_flow, omega, dt, seg, sky, depth, gt_foe,
               sample_yx=None, generator=None, config=None) -> SimpleNamespace:
        sc: Dict[str, torch.Tensor] = ref_detect.scalars(
            flow, gt_flow, omega, dt, seg, sky, depth, gt_foe, sample_yx,
            self.num_samples, dtype=torch.bfloat16)
        return SimpleNamespace(**sc)


def readings(cell: str, seeds, side: str, seconds: float, device="cuda",
             config=None, params=None):
    bench = spec.benchmark()
    cfg = config if config is not None else spec.config(bench, spec.cell(bench, cell)["config"])
    control = (Control(cfg["flow"], int(cfg["foe_samples"])) if side == "control"
               else None)
    for seed in seeds:
        r = harness.run_cell(bench, cell, seed, seconds, False, device, time.time(),
                             config=cfg, params=params, control=control)
        yield {"cell": cell, "side": side, "seed": seed, "correct": r["correct"],
               "numbers": {k: v["value"] for k, v in r["checked"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--side", choices=("program", "control"), required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    for line in readings(args.workload, seeds, args.side, args.seconds):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
