"""``flow_span_ms`` (Flow, moves ``step_frames_per_s``): device ms per frame
pair of the program's span ``flow``, the whole of _farneback_cf (the resizes
between layers are its own time). Timed by the span's own CUDA events inside
a replayed graph of the step (``h100_bench/spans.py``); off the card its
host-clock ms. None where the program records no such span."""
from __future__ import annotations

from h100_bench import spans


def read(run):
    return spans.span_ms(run, "flow")
