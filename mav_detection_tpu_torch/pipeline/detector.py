"""The fused per-frame detection step, batched
(``mav_detection_tpu.pipeline.detector``).

Derotation, the dense-FoE vote, the phi map, dynamic + fixed threshold
masks, pixel TPR/FPR, sky validation and the per-frame scalars, over a
leading frame axis written out (no vmap). Everything returned has a fixed
shape, so a whole batch of FrameResults leaves the device in one transfer.

Random FoE samples cannot match across frameworks, so the batch functions
take optional ``(n, 2N, 2)`` (y, x) indices ``sample_yx``; without them they
draw from the caller's ``torch.Generator``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mav_detection_tpu_torch.ops.geometry import (
    derotate,
    detection_masks,
    get_foe_dense,
    get_phi,
    sample_points,
)
from mav_detection_tpu_torch.ops.image.detect_rates import detection_rates
from mav_detection_tpu_torch.utils.tracing import stage


class FrameOutputs(NamedTuple):
    """Per-frame scalars + masks, each with a leading frame axis."""
    foe: torch.Tensor                # (n, 2) estimated FoE (x, y)
    tpr: torch.Tensor                # (n,) dynamic-threshold TPR
    fpr: torch.Tensor                # (n,)
    tpr_fixed: torch.Tensor          # (n,) fixed 15-degree TPR
    fpr_fixed: torch.Tensor          # (n,)
    sky_tpr: torch.Tensor            # (n,)
    sky_fpr: torch.Tensor            # (n,)
    drone_size_pixels: torch.Tensor  # (n,) segmentation area
    drone_flow_pixels: torch.Tensor  # (n, 2) mean GT-derotated flow on the drone
    center_phi: torch.Tensor         # (n,) angle of drone center seen from GT FoE
    phi: torch.Tensor                # (n, h, w) angle map (degrees)
    total_mask: torch.Tensor         # (n, h, w) dynamic-threshold detection mask
    estimate_fixed: torch.Tensor     # (n, h, w) fixed-threshold detection mask
    flow_derotated: torch.Tensor     # (n, h, w, 2)


class DetectionStep(NamedTuple):
    """Static configuration for the fused step (the reference's
    ``batch_mode`` picks a JAX vectorization strategy and has no
    counterpart here)."""
    foe_samples: int = 1000


class FrameScalars(NamedTuple):
    """Scalar-only outputs of a batch."""
    foe: torch.Tensor
    tpr: torch.Tensor
    fpr: torch.Tensor
    tpr_fixed: torch.Tensor
    fpr_fixed: torch.Tensor
    sky_tpr: torch.Tensor
    sky_fpr: torch.Tensor
    drone_size_pixels: torch.Tensor
    drone_flow_pixels: torch.Tensor
    center_phi: torch.Tensor


def detect_frame_pair(flow_uv, gt_flow_uv, omega, dt, segmentation, sky_mask,
                      depth, gt_foe, sample_yx,
                      config: DetectionStep = DetectionStep()) -> FrameOutputs:
    """One frame pair: the batch step on a batch of one. Arguments are the
    reference's per-frame shapes; ``sample_yx`` is (2N, 2) (y, x)."""
    out = detect_frame_batch(
        flow_uv[None], gt_flow_uv[None], omega[None], dt.reshape(1),
        segmentation[None], sky_mask[None], depth[None], gt_foe[None],
        sample_yx=sample_yx[None], config=config)
    return FrameOutputs(*(x[0] for x in out))


def detect_frame_batch(flow_uv: torch.Tensor,       # (n, h, w, 2) measured flow
                       gt_flow_uv: torch.Tensor,    # (n, h, w, 2) GT flow (zeros if none)
                       omega: torch.Tensor,         # (n, 3) angular difference / dt
                       dt: torch.Tensor,            # (n,) frame interval (s)
                       segmentation: torch.Tensor,  # (n, h, w) uint8 target mask
                       sky_mask: torch.Tensor,      # (n, h, w) bool sky segmentation
                       depth: torch.Tensor,         # (n, h, w) depth (sky GT)
                       gt_foe: torch.Tensor,        # (n, 2) GT FoE (x, y); NaN if none
                       sample_yx: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       config: DetectionStep = DetectionStep()) -> FrameOutputs:
    with stage("detect"):
        n, h, w, _ = flow_uv.shape
        flow_uv = flow_uv.to(torch.float32)

        # 1. IMU derotation
        with stage("detect.derotate"):
            flow_derot = derotate(flow_uv, omega, dt)
            flow_mag = torch.sqrt(flow_derot[..., 0] * flow_derot[..., 0]
                                  + flow_derot[..., 1] * flow_derot[..., 1])

        # 2. dense FoE vote
        with stage("detect.foe_vote"):
            if sample_yx is None:
                sample_yx = sample_points(n, config.foe_samples, h, w, generator,
                                          flow_uv.device)
            foe = get_foe_dense(flow_derot, sample_yx.to(flow_uv.device),
                                num_samples=config.foe_samples)

        # 3. phi map + masks
        with stage("detect.masks"):
            phi = get_phi(flow_derot, foe)
            total_mask, estimate_fixed = detection_masks(phi, flow_mag, sky_mask)

        # 4. pixel and sky rates (GT sky = depth > 0.8 * max), the drone's
        # size, mean derotated GT flow and centre angle: one CUDA reduction
        # on the card, the plain version elsewhere
        with stage("detect.rates"):
            rates = detection_rates(segmentation, total_mask, estimate_fixed, sky_mask,
                                    depth, gt_flow_uv, omega, dt, gt_foe)

    return FrameOutputs(foe=foe, **rates._asdict(), phi=phi, total_mask=total_mask,
                        estimate_fixed=estimate_fixed, flow_derotated=flow_derot)


def _to_scalars(out: FrameOutputs) -> FrameScalars:
    return FrameScalars(
        foe=out.foe, tpr=out.tpr, fpr=out.fpr, tpr_fixed=out.tpr_fixed,
        fpr_fixed=out.fpr_fixed, sky_tpr=out.sky_tpr, sky_fpr=out.sky_fpr,
        drone_size_pixels=out.drone_size_pixels,
        drone_flow_pixels=out.drone_flow_pixels, center_phi=out.center_phi)


def detect_frame_batch_scalars(flow_uv, gt_flow_uv, omega, dt, segmentation,
                               sky_mask, depth, gt_foe,
                               sample_yx: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None,
                               config: DetectionStep = DetectionStep()
                               ) -> FrameScalars:
    """``detect_frame_batch`` reduced to the per-frame scalars."""
    return _to_scalars(detect_frame_batch(
        flow_uv, gt_flow_uv, omega, dt, segmentation, sky_mask, depth, gt_foe,
        sample_yx=sample_yx, generator=generator, config=config))


def pack_frame_scalars(s: FrameScalars) -> torch.Tensor:
    """Concatenate the per-frame scalars into one (B, 12) float32 tensor so
    the host pulls the whole batch in a single transfer. Columns: foe x, y,
    tpr, fpr, tpr_fixed, fpr_fixed, sky_tpr, sky_fpr, drone_size_pixels,
    drone_flow_pixels x, y, center_phi."""
    cols = (s.foe, s.tpr[:, None], s.fpr[:, None], s.tpr_fixed[:, None],
            s.fpr_fixed[:, None], s.sky_tpr[:, None], s.sky_fpr[:, None],
            s.drone_size_pixels[:, None], s.drone_flow_pixels,
            s.center_phi[:, None])
    return torch.cat([c.to(torch.float32) for c in cols], dim=1)


def unpack_frame_scalars(packed: torch.Tensor) -> FrameScalars:
    """The inverse of ``pack_frame_scalars``: (B, 12) -> ``FrameScalars``
    (``drone_size_pixels`` back to int64)."""
    p = packed.to(torch.float32)
    return FrameScalars(
        foe=p[:, 0:2], tpr=p[:, 2], fpr=p[:, 3], tpr_fixed=p[:, 4],
        fpr_fixed=p[:, 5], sky_tpr=p[:, 6], sky_fpr=p[:, 7],
        drone_size_pixels=p[:, 8].to(torch.int64), drone_flow_pixels=p[:, 9:11],
        center_phi=p[:, 11])
