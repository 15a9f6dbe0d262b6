"""``flow_iterate_span_ms`` (Iterate kernel, moves ``step_frames_per_s``):
device ms per frame pair of the program's span ``flow.iterate``,
farneback_iterate at each pyramid layer, summed (ROADMAP B3). Timed by the
span's own CUDA events inside a replayed graph of the step
(``h100_bench/spans.py``); off the card its host-clock ms. None where the
program records no such span."""
from __future__ import annotations

from h100_bench import spans


def read(run):
    return spans.span_ms(run, "flow.iterate")
