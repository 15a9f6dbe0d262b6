"""Traffic kind ``raft_step``: the ``step`` kind with the published RAFT as
the program's flow.

The flow is ``raft_flow_batch_tuned`` (the batch engine's RAFT route) with
``BasicRAFT(RAFT_BASIC)`` and ``TunedRAFT(iters=<the configuration's>,
config=RAFT_BASIC)``, inside the step's CUDA graph; its weights are the
configuration's flow reference's ``weights`` at the run's seed, loaded
under the published names (``load_state_dict(strict=True)``), so the
program and the judge hold the same draw. Everything else (ring, graph,
detection, window, traced slice, the judge's sample) is ``step``'s.
"""
from __future__ import annotations

import sys

from h100_bench import spec
from h100_bench.traffic import step
from h100_bench.traffic.step import pairs, release, traced, window  # noqa: F401
from mav_detection_tpu_torch.models.raft import (
    RAFT_BASIC,
    BasicRAFT,
    TunedRAFT,
    raft_flow_batch_tuned,
)

# the tests' small run: a ring of two slots of a b=2 batch of 64x96 frames
TINY = dict(step.TINY, batch=2, ring_bytes=2 * 2 * 64 * 96)
FLOW_SITES = ((sys.modules[__name__], "raft_flow_batch_tuned"),)


def prepare(run) -> None:
    cfg = run.config
    model = BasicRAFT(RAFT_BASIC).to(run.device)
    model.load_state_dict(spec.flow_reference(cfg).weights(cfg, run.seed, run.device),
                          strict=True)
    tuned = TunedRAFT(iters=int(cfg["raft"]["iters"]), config=RAFT_BASIC)
    step.prepare(run, flow=lambda prev, curr: raft_flow_batch_tuned(
        prev, curr, model, tuned, run.device))
