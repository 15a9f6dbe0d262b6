"""IMU-based flow derotation (``mav_detection_tpu.ops.geometry.derotation``).

Closed-form rotational flow field synthesized from body angular rates and
subtracted from the measured flow. Batched over a leading frame axis.
"""
from __future__ import annotations

import torch


def derotation_field(omega: torch.Tensor, dt: torch.Tensor, width: int,
                     height: int) -> torch.Tensor:
    """Rotational flow field (n, h, w, 2) for angular rates ``omega`` (n, 3)
    in rad/s and frame intervals ``dt`` (n,).

    omega[:, 0] ~ pitch-like, omega[:, 1] ~ yaw-like, omega[:, 2] ~ roll-like
    in the upstream remapped body frame.
    """
    dev = omega.device
    x = torch.arange(width, device=dev, dtype=torch.float32)[None, None, :]
    y = torch.arange(height, device=dev, dtype=torch.float32)[None, :, None]
    # normalized coordinates in [-1, 1], flipped like upstream
    xn = -(x / width - 0.5) * 2.0
    yn = -(y / height - 0.5) * 2.0
    o0, o1, o2 = (omega[:, i, None, None].to(torch.float32) for i in range(3))
    dt = dt.to(torch.float32)[:, None, None]

    u = o0 * xn * yn - o1 * (xn * xn) - o1 + o2 * yn
    v = -o2 * xn + o0 + o0 * (yn * yn) - o1 * xn * yn

    u = u * (width * dt / 2.0)
    v = v * (height * dt / 2.0)
    return torch.stack([u, v], dim=-1)


def derotate(flow_uv: torch.Tensor, omega: torch.Tensor,
             dt: torch.Tensor) -> torch.Tensor:
    """Subtract the rotation-induced component from measured flow
    (n, h, w, 2); ``omega`` (n, 3) is the angular difference over the frame
    interval divided by dt (rad/s)."""
    h, w = flow_uv.shape[1], flow_uv.shape[2]
    return flow_uv - derotation_field(omega, dt, w, h).to(flow_uv.dtype)
