"""A test-only flow reference: the program's own Farneback flow, moved by
the configuration's ``offset_px`` along x."""
from __future__ import annotations

from h100_bench.reference.farneback import CONTROL_PRECISION, gray, weights  # noqa: F401
from mav_detection_tpu_torch.ops.flow.farneback import farneback_flow_batch


def flow(prev, curr, config, weights, precision: str = "fp32"):
    out = farneback_flow_batch(gray(prev), gray(curr), None, prev.device)
    out[..., 0] += float(config.get("offset_px", 0.0))
    return out
