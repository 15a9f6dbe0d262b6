"""Global ego-motion field synthesis and subtraction
(``mav_detection_tpu.ops.geometry.global_motion``).

The fitted affine/homography is evaluated on the pixel grid to synthesize the
camera-induced flow, which is then subtracted (upstream computes ``global -
flow``, not ``flow - global``; that sign is kept so magnitudes match).
"""
from __future__ import annotations

from typing import Tuple

import torch

from mav_detection_tpu_torch.ops.geometry.warp import (
    _dst_grid,
    warp_affine,
    warp_perspective,
)


def affine_motion_field(M: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(h, w, 2) displacement field of a 2x3 affine: M(p) - p."""
    xs, ys = _dst_grid((height, width), M.device)
    u = M[0, 0] * xs + M[0, 1] * ys + M[0, 2] - xs
    v = M[1, 0] * xs + M[1, 1] * ys + M[1, 2] - ys
    return torch.stack([u, v], dim=-1)


def homography_motion_field(H: torch.Tensor, height: int, width: int,
                            projective: bool = False) -> torch.Tensor:
    """(h, w, 2) displacement field of a 3x3 homography.

    Upstream applies the homography WITHOUT the projective divide (a manual
    2-row matrix multiply); pass ``projective=True`` for the
    geometrically-correct variant.
    """
    xs, ys = _dst_grid((height, width), H.device)
    u = H[0, 0] * xs + H[0, 1] * ys + H[0, 2]
    v = H[1, 0] * xs + H[1, 1] * ys + H[1, 2]
    if projective:
        z = H[2, 0] * xs + H[2, 1] * ys + H[2, 2]
        z = torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))
        u = u / z
        v = v / z
    return torch.stack([u - xs, v - ys], dim=-1)


def subtract_global_motion(flow_uv: torch.Tensor, global_motion: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (residual flow = global - flow, its magnitude)."""
    residual = global_motion - flow_uv
    return residual, torch.linalg.norm(residual, dim=-1)


def warp_diff_method(flow_uv: torch.Tensor, M: torch.Tensor,
                     homography: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp-and-diff ego-motion removal: warp the flow field by the fitted
    transform, backfill zero-warped components from the warp, and return
    (flow difference, its magnitude). The zero mask is per channel, not per
    pixel, as upstream's elementwise mask is."""
    stable = warp_perspective(flow_uv, M) if homography else warp_affine(flow_uv, M)
    patched = torch.where(stable == 0.0, stable, flow_uv)
    diff = patched - stable
    return diff, torch.linalg.norm(diff, dim=-1)
