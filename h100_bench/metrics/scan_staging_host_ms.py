"""``scan_staging_host_ms`` (Scan engine, moves ``frames_per_s``): the
``stage`` total of each ``Processor.tracer`` (host work of
``_sequence_inputs`` and the pinned uploads of the whole sequence), summed
over the window's sequences, ms per frame pair of the window. None outside
a scan-engine cell."""
from __future__ import annotations


def read(run):
    c = run.counters
    if run.state.get("engine") != "scan" or not c.get("pairs"):
        return None
    return 1e3 * c["scan_stage_s"] / c["pairs"]
