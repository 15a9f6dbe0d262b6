"""``flow_launches`` (Flow, moves ``step_frames_per_s``): device operations
(kernels, copies, sets) launched inside the program's span ``flow``, its
child spans' included, per batch: ``farneback_flow_batch`` in one eager step
under ``torch.profiler``, each operation given to the span that holds its
launch (``h100_bench/spans.py``); off the card the leaf CPU operations. None
where the program records no such span."""
from __future__ import annotations

from h100_bench import spans


def read(run):
    return spans.launches(run, "flow")
