"""Readings for the limits of the comparison that decides ``correct``.

    python3 -m h100_bench.control --workload <cell> --seeds 1,2,3 --side control [--seconds 2]

runs the cell once per seed in one process, each with a short window, and
prints one JSON line per seed with the numbers the judge compared.
``--side program`` runs the program (the sound readings, from which each
limit's lower reading comes). ``--side control`` puts the control in the
program's place (from which each limit's upper reading comes): the
references themselves, computed in the nearest precision below the one the
configuration states: the configuration's flow reference at its
``CONTROL_PRECISION`` (Farneback's: its matrix products in TF32, the
solver's iterations float32), with the weights each run's seed draws, and
the detection math in bfloat16. The benchmark's own runs never run the
control.
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


class Control:
    """The references in the program's place, for one run of ``config`` at
    ``seed``: ``flow`` where the program's flow function is called (the
    frames as it gets them), ``detect`` where its detection step is (the
    same arguments; the per-frame scalars under the program's names)."""

    def __init__(self, config: Mapping, seed: int, device) -> None:
        self.config, self.num_samples = config, int(config["foe_samples"])
        self.reference = spec.flow_reference(config)
        self.weights = self.reference.weights(config, seed, torch.device(device))

    def flow(self, prev: torch.Tensor, curr: torch.Tensor) -> torch.Tensor:
        return self.reference.flow(prev, curr, self.config, self.weights,
                                   self.reference.CONTROL_PRECISION)

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
    for seed in seeds:
        control = Control(cfg, seed, device) if side == "control" else None
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
