"""One run of one cell: set-up, the measured window, the traced slice, the
per-layer readers, the comparison, and the result.

A traffic kind (``traffic/<kind>.py``) provides ``prepare(run)`` (set-up:
inputs made on the device from the seed, the program built and every shape
the window uses warmed up), ``window(run)`` (the measured window: its
``attempted`` and ``failed`` pairs and its end-to-end metrics), ``traced(run)``
(a steady slice of the same work, run inside the profiler), ``pairs(run)``
(the judge's sample of what the window answered) and ``release(run)``
(frees the program's state), and two names the tests read: ``TINY``, the
overrides of its traffic parameters that make a run small enough for the
CPU, and ``FLOW_SITES``, the (module, attribute) pairs where its timed path
makes flow. The configuration's flow reference (``spec.flow_reference``)
is found before set-up, so that a name without a file fails before any
work. ``Run`` carries what they share: the cell,
the configuration, the traffic parameters, the device, the live objects
(``state``), the program's counters read over the window (``counters``)
and the traced slice's reduction (``profile``).
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from h100_bench import judge, spec, trace


@dataclass
class Run:
    cell: str
    seed: int
    seconds: float
    device: torch.device
    config: Dict
    params: Dict
    # the control, put in the program's place (``control.Control``: its
    # ``flow`` and ``detect``); None runs the program
    control: Optional[object] = None
    state: Dict = field(default_factory=dict)
    counters: Dict = field(default_factory=dict)
    profile: Optional[Dict] = None


def run_cell(bench: Dict, cell_name: str, seed: int, seconds: float, traced: bool,
             device, t_start: float, config: Optional[Dict] = None,
             params: Optional[Dict] = None, control: Optional[object] = None
             ) -> Dict:
    """The result of one run (every key of the last line but ``device``'s
    name and count, which the caller adds). ``t_start``: the process's start
    on the ``time.time()`` clock. ``config`` / ``params`` stand in for the
    cell's files (the tests' small sizes)."""
    cell = spec.cell(bench, cell_name)
    run = Run(cell=cell_name, seed=seed, seconds=seconds, device=torch.device(device),
              config=config if config is not None else spec.config(bench, cell["config"]),
              params=params if params is not None else spec.traffic_params(cell_name),
              control=control)
    kind = spec.traffic_kind(run.params["kind"])
    spec.flow_reference(run.config)      # a reference without a file fails here
    on_card = run.device.type == "cuda"

    kind.prepare(run)
    setup_s = time.time() - t_start
    if on_card:
        torch.cuda.reset_peak_memory_stats(run.device)
    out = kind.window(run)
    print(f"window: {out}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(run.device) if on_card else 0

    metrics: Dict[str, Dict] = {}
    if traced:
        with trace.Profiled(run.device) as prof:
            kind.traced(run)
        run.profile = prof.result
        for m in spec.per_layer(bench, cell_name):
            value = spec.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        for m in spec.end_to_end(bench, cell_name):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    pairs = kind.pairs(run)
    kind.release(run)
    del run.state
    if on_card:
        torch.cuda.empty_cache()
    numbers = judge.judge(pairs, run.config, run.seed, run.device)
    correct, checked = judge.verdict(numbers, run.params["limits"])

    device_fields: Dict = {"memory_peak_bytes": peak}
    result: Dict = {"correct": correct, "attempted": out["attempted"],
                    "failed": out["failed"], "metrics": metrics,
                    "device": device_fields}
    if traced and run.profile is not None:
        device_fields["busy_s"] = run.profile["busy_s"]
        device_fields["window_s"] = run.profile["window_s"]
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    result["checked"] = checked
    return result
