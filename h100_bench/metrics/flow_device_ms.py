"""``flow_device_ms`` (Flow layer, moves ``step_frames_per_s``): the
program's ``farneback_flow_batch`` at the cell's shape and batch on a fixed
batch of the ring, in a replayed CUDA graph, device ms per frame pair (CUDA
events). None outside a step cell or off the card."""
from __future__ import annotations

from h100_bench import timing

REPS = 20


def read(run):
    st = run.state
    if run.device.type != "cuda" or "flow_of" not in st:
        return None
    B = st["batch"]
    prev, curr = st["frames"][:B], st["frames"][1:B + 1]
    return timing.graph_ms(lambda: st["flow_of"](prev, curr), REPS) / B
