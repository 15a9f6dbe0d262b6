"""``detect_launches`` (Detection step, moves ``step_frames_per_s``): device
operations (kernels, copies, sets) launched inside the program's span
``detect``, its child spans' included, per batch:
``detect_frame_batch_scalars`` in one eager step under ``torch.profiler``,
each operation given to the span that holds its launch
(``h100_bench/spans.py``); off the card the leaf CPU operations. None where
the program records no such span."""
from __future__ import annotations

from h100_bench import spans


def read(run):
    return spans.launches(run, "detect")
