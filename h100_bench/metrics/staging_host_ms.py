"""``staging_host_ms`` (Frame engine, moves ``frames_per_s``): the
Processor's own counter of its staging thread's host seconds
(``Processor._stage_host_seconds``), summed over the window's sequences,
ms per frame pair of the window. None outside a batch-engine cell."""
from __future__ import annotations


def read(run):
    c = run.counters
    if run.state.get("engine") != "batch" or not c.get("pairs"):
        return None
    return 1e3 * c["stage_host_s"] / c["pairs"]
