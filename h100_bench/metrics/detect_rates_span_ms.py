"""``detect_rates_span_ms`` (Detection step, moves ``step_frames_per_s``):
device ms per frame pair of the program's span ``detect.rates``, step 2 (the
sky rates) and the rest of step 4 (TPR/FPR, the masked mean flow, size, box,
center_phi), two intervals summed. Timed by the span's own CUDA events
inside a replayed graph of the step (``h100_bench/spans.py``); off the card
its host-clock ms. None where the program records no such span."""
from __future__ import annotations

from h100_bench import spans


def read(run):
    return spans.span_ms(run, "detect.rates")
