"""Chained pan-curriculum RAFT retrain, restartable phase by phase.

The port of ``tools/run_pan_curriculum.sh``, as a module. Phase 1 teaches
large motion (uniform pans to 12 px) at the cost of the small-motion
family; phase 2 consolidates with the pan annealed to 6 px; phase 3 feeds
the sim-like texture family back in (sin-blend 0.85) at pan 9 px and ships
only if every gate passes, the absolute ``shift_ladder<=0.5`` one included.
Each phase is ``tools/finetune_raft`` resumed from the phase before.

A phase counts as done only when its sentinel (``phaseN.done``, JSON) says
so. The phase trains into ``phaseN.msgpack.partial``, renames it to
``phaseN.msgpack`` once its full step count has run, then writes the
sentinel; a restart skips exactly the phases with a sentinel and runs a
phase killed mid-run (its candidate present, no sentinel) again. (The shell
script skipped a phase whenever its candidate file existed, which the
trainer writes at every new best, long before the phase ends.) Phase 3
ships, so ``MAV_CHECKPOINT_PATH`` must be set before phase 1 starts, not
after hours of training::

    MAV_CHECKPOINT_PATH=<dir> python -m mav_detection_tpu_torch.tools.pan_curriculum
        [--dir build/candidates] [--steps 2000]

``--steps`` (steps per phase; the shell script has no such flag) exists to
run the curriculum short, in tests and in the chip smoke run.
``--device cpu`` trains with the plain versions.
"""
from __future__ import annotations

import json
import os
import time

from mav_detection_tpu_torch.tools import finetune_raft as ft
from mav_detection_tpu_torch.tools.common import dumps, parser
from mav_detection_tpu_torch.utils.device import resolve_device

# the shell script's arguments, phase by phase
PHASES = (
    {"name": "phase1", "pan_max": 12.0, "lr": 8e-5, "sin_blend": 0.6, "ship": False},
    {"name": "phase2", "pan_max": 6.0, "lr": 4e-5, "sin_blend": 0.6, "ship": False},
    {"name": "phase3", "pan_max": 9.0, "lr": 3e-5, "sin_blend": 0.85, "ship": True},
)
STEPS = 2000


def paths(root: str, name: str) -> dict:
    base = os.path.join(root, name)
    return {"candidate": base + ".msgpack", "partial": base + ".msgpack.partial",
            "sentinel": base + ".done"}


def is_done(root: str, name: str) -> bool:
    return os.path.exists(paths(root, name)["sentinel"])


def phase_argv(phase: dict, steps: int, root: str, init: str) -> list:
    """finetune_raft's arguments for a phase (training into the partial
    file)."""
    argv = ["--pan-max", f"{phase['pan_max']:g}", "--steps", str(steps),
            "--lr", f"{phase['lr']:g}", "--sin-blend", f"{phase['sin_blend']:g}",
            "--candidate", paths(root, phase["name"])["partial"]]
    if init:
        argv += ["--init", init]
    if phase["ship"]:
        argv.append("--ship")
    return argv


def run_phase(phase: dict, steps: int, root: str, init: str, dev, scene=None) -> dict:
    """One phase to its end: train into the partial file, rename it, write
    the sentinel. Returns the sentinel's content."""
    p = paths(root, phase["name"])
    for stale in (p["partial"], p["candidate"]):
        if os.path.exists(stale):
            os.remove(stale)
    t0 = time.perf_counter()
    res = ft.main(phase_argv(phase, steps, root, init), device=dev, scene=scene)
    os.replace(p["partial"], p["candidate"])
    done = {"phase": phase["name"], "steps": steps, "init": init,
            "candidate": p["candidate"], "evals": res["candidate"], "gates": res["gates"],
            "all_pass": res["all_pass"], "shipped_to": res["shipped_to"],
            "seconds": time.perf_counter() - t0}
    with open(p["sentinel"] + ".tmp", "w") as f:
        f.write(json.dumps(done) + "\n")
    os.replace(p["sentinel"] + ".tmp", p["sentinel"])
    return done


def main(argv=None, device=None, scene=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--dir", default=ft.CANDIDATES,
                    help="where the phases' candidates and sentinels live")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="training steps per phase (the shell script's 2000; shorter "
                         "runs are for tests and the chip smoke run)")
    args = ap.parse_args(argv)
    ft.check_ship(True)
    dev = resolve_device(device if device is not None else args.device)
    os.makedirs(args.dir, exist_ok=True)
    res = {"device": str(dev), "dir": os.path.abspath(args.dir), "steps": args.steps,
           "phases": []}
    init = ""
    for phase in PHASES:
        p = paths(args.dir, phase["name"])
        if is_done(args.dir, phase["name"]):
            with open(p["sentinel"]) as f:
                row = {**json.load(f), "skipped": True}
        else:
            row = {**run_phase(phase, args.steps, args.dir, init, dev, scene),
                   "skipped": False}
        res["phases"].append(row)
        print(f"{phase['name']}: {'skipped (sentinel)' if row['skipped'] else 'ran'}; "
              f"gates {json.dumps(row['gates'])}")
        init = p["candidate"]
    res["shipped_to"] = res["phases"][-1]["shipped_to"]
    print(dumps(res))
    return res


if __name__ == "__main__":
    main()
