"""``detect_derotate_span_ms`` (Detection step, moves
``step_frames_per_s``): device ms per frame pair of the program's span
``detect.derotate``, step 1 of detect_frame_batch: the IMU derotation and
the flow's magnitude. Timed by the span's own CUDA events inside a replayed
graph of the step (``h100_bench/spans.py``); off the card its host-clock ms.
None where the program records no such span."""
from __future__ import annotations

from h100_bench import spans


def read(run):
    return spans.span_ms(run, "detect.derotate")
