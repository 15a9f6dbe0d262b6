"""``device_idle_share.step`` (Device, moves ``step_frames_per_s``): 1 -
the union of the device's kernel and copy intervals over the traced
slice's wall seconds (``torch.profiler``, CPU and CUDA, over ``trace_s``
seconds of the step's graph replays after the window): the share of the
time the replayed step leaves the card without work. None without a device
operation in the trace."""
from __future__ import annotations


def read(run):
    p = run.profile
    if not p or p["window_s"] <= 0:
        return None
    return 1.0 - p["busy_s"] / p["window_s"]
