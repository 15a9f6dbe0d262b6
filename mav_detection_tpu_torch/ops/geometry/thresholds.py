"""Detection threshold masks (``mav_detection_tpu.ops.geometry.thresholds``).

The dynamic radial-error threshold ``0.25 ± (0.5 + 8/|OF|)`` and the fixed
15° variant, as the upstream hot loop applies them.
"""
from __future__ import annotations

from typing import Tuple

import torch

FIXED_ANGLE_THRESHOLD = 15.0
DYNAMIC_BASE = 0.25
DYNAMIC_OFFSET = 0.5
DYNAMIC_SCALE = 8.0
MIN_FLOW_DYNAMIC = 0.5
MIN_FLOW_FIXED = 1.0


def dynamic_angle_mask(phi_deg: torch.Tensor, flow_mag: torch.Tensor) -> torch.Tensor:
    """phi outside the band 0.25 ± (0.5 + 8/|OF|) degrees."""
    band = DYNAMIC_OFFSET + DYNAMIC_SCALE / flow_mag
    above = phi_deg > (DYNAMIC_BASE + band)
    below = phi_deg < (DYNAMIC_BASE - band)
    return above | below


def fixed_angle_mask(phi_deg: torch.Tensor, flow_mag: torch.Tensor,
                     sky_mask: torch.Tensor) -> torch.Tensor:
    """phi * (|OF| > 1.0) * ~sky > 15°."""
    return (phi_deg * (flow_mag > MIN_FLOW_FIXED) * (~sky_mask)) > FIXED_ANGLE_THRESHOLD


def detection_masks(phi_deg: torch.Tensor, flow_mag: torch.Tensor,
                    sky_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dynamic total_mask, fixed estimate mask)."""
    angle_threshold = dynamic_angle_mask(phi_deg, flow_mag)
    total_mask = (flow_mag > MIN_FLOW_DYNAMIC) & (~sky_mask) & angle_threshold
    estimate_fixed = fixed_angle_mask(phi_deg, flow_mag, sky_mask)
    return total_mask, estimate_fixed
