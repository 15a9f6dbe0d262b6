"""``raft_mfu`` (Flow, moves ``step_frames_per_s``): the published RAFT's
operations in one replay of the cell's step (``raft_roofline.pair_flops``
times the batch) over the device time of that replay (CUDA events over
``REPS`` replays of the step's captured graph, ``run.state["replay"]``), as
a percentage of the H100's dense BF16 peak. The replay also holds the
detection step, whose work counts nothing. None off the card, outside a
step cell, or where the control stands in for the program."""
from __future__ import annotations

import torch

from h100_bench import raft_roofline, timing

REPS = 10


def read(run):
    st = run.state
    graph = getattr(st.get("replay"), "__self__", None)
    if (run.device.type != "cuda" or run.control is not None or "raft" not in run.config
            or not isinstance(graph, torch.cuda.CUDAGraph)):
        return None
    ms = timing.replay_ms(graph, REPS)
    flops = raft_roofline.pair_flops(run.config) * st["batch"]
    return 100.0 * flops / (ms * 1e-3) / raft_roofline.BF16_FLOPS_PER_S
