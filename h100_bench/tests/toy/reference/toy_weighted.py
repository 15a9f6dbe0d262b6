"""A test-only flow reference with weights: per channel, flow = scale x
(curr - prev) / 255 + bias, with scale and bias drawn from the seed. Its
control runs in bfloat16."""
from __future__ import annotations

import torch

from h100_bench.reference.farneback import gray

CONTROL_PRECISION = "bf16"


def weights(config, seed: int, device) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    w = torch.rand((2, 2), generator=g, device=device) * 2 - 1
    return {"scale": 4 * w[0], "bias": w[1].clone()}


def flow(prev, curr, config, weights, precision: str = "fp32") -> torch.Tensor:
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    d = (gray(curr).to(dtype) - gray(prev).to(dtype)) / 255
    out = d[..., None] * weights["scale"].to(dtype) + weights["bias"].to(dtype)
    return out.to(torch.float32)
