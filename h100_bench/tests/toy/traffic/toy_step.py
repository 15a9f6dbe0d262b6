"""A test-only traffic kind: the step kind with a toy program flow whose
weights the program draws from its flow reference's ``weights``, at the
run's seed plus ``program_seed_offset`` (a sound program: 0)."""
from __future__ import annotations

import sys

import torch

from h100_bench import spec
from h100_bench.traffic import step
from h100_bench.traffic.step import TINY, pairs, release, traced, window  # noqa: F401

FLOW_SITES = ((sys.modules[__name__], "program_flow"),)


def program_flow(prev: torch.Tensor, curr: torch.Tensor, weights: dict) -> torch.Tensor:
    d = (curr.to(torch.float32) - prev.to(torch.float32)) / 255
    return d[..., None] * weights["scale"] + weights["bias"]


def prepare(run) -> None:
    seed = run.seed + int(run.params["program_seed_offset"])
    weights = spec.flow_reference(run.config).weights(run.config, seed, run.device)
    step.prepare(run, flow=lambda prev, curr: program_flow(prev, curr, weights))
