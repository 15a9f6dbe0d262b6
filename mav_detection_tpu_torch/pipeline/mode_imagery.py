"""Mode-appropriate NN imagery (``mav_detection_tpu.pipeline.mode_imagery``):
what TinyYOLO sees in each detection mode. APPEARANCE_RGB is the raw frame,
FLOW_UV the flow-vis rendering, FLOW_RADIAL its hue-only variant,
FLOW_FOE_YOLO the ego-motion-subtracted residual magnitude.

- :func:`mode_image_host`: the inference transform of one frame (the
  Validator's and ``Processor.convert``'s), numpy out. FLOW_FOE_YOLO fits
  its affine ego-motion on ``device``.
- :func:`mode_image_device`: the training-imagery transform on tensors.

FLOW_FOE_YOLO samples 1000 flow points and fits a RANSAC affine on them. The
host transform draws the points from ``np.random.default_rng(seed)``, as the
reference does, so both packages sample the same points. The RANSAC minimal
sets cannot match across frameworks: they go in as ``ransac_idx`` ((256, 3)
point indices), drawn from a generator seeded with ``seed`` when none are
given.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from mav_detection_tpu_torch.ops.geometry.global_motion import (
    affine_motion_field,
    subtract_global_motion,
)
from mav_detection_tpu_torch.ops.geometry.ransac_fits import fit_affine_ransac
from mav_detection_tpu_torch.ops.image.visualize import (
    flow_radial_device,
    flow_to_color,
    flow_to_color_device,
    get_flow_radial,
    to_rgb,
)
from mav_detection_tpu_torch.utils.device import resolve_device

FOE_SAMPLES = 1000
FOE_BORDER = 20
RANSAC_ITERS = 256


def _residual_magnitude(flow: torch.Tensor, p0: torch.Tensor,
                        ransac_idx, generator) -> torch.Tensor:
    """|global affine motion - flow| of an (h, w, 2) field, the affine fit
    by RANSAC on the flow at points ``p0`` ((n, 2) x, y)."""
    h, w = flow.shape[:2]
    xi, yi = p0[:, 0].long(), p0[:, 1].long()
    p1 = p0 + flow[yi, xi]
    M, _ = fit_affine_ransac(p0, p1, idx=ransac_idx, iters=RANSAC_ITERS,
                             generator=generator)
    _, mag = subtract_global_motion(flow, affine_motion_field(M, h, w))
    return mag


def mode_image_host(frame: Optional[np.ndarray], flow: np.ndarray,
                    mode_name: str, seed: int = 0,
                    ransac_idx: Optional[np.ndarray] = None,
                    device: Union[str, torch.device] = "cuda"
                    ) -> Optional[np.ndarray]:
    """The inference input of one frame in mode ``mode_name`` (a
    ``Mode.name``). FLOW_FOE_YOLO runs its fit on ``device``."""
    if frame is None or mode_name == "APPEARANCE_RGB":
        return frame
    if mode_name == "FLOW_UV":
        return flow_to_color(flow)
    if mode_name == "FLOW_RADIAL":
        return get_flow_radial(flow_to_color(flow))

    dev = resolve_device(device)
    h, w = flow.shape[:2]
    rng = np.random.default_rng(seed)
    sy = rng.integers(FOE_BORDER, h - FOE_BORDER, FOE_SAMPLES)
    sx = rng.integers(FOE_BORDER, w - FOE_BORDER, FOE_SAMPLES)
    p0 = torch.as_tensor(np.stack([sx, sy], 1).astype(np.float32), device=dev)
    generator = None
    if ransac_idx is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    flow_t = torch.as_tensor(np.asarray(flow, np.float32), device=dev)
    mag = _residual_magnitude(flow_t, p0, ransac_idx, generator).cpu().numpy()
    return to_rgb(mag * 255.0 / max(float(mag.max()), 1e-6))


def mode_image_device(gray_img: torch.Tensor, flow: torch.Tensor, mode_name: str,
                      sample_yx: Optional[torch.Tensor] = None,
                      ransac_idx: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Training imagery of one scene on the tensors' device: ``gray_img``
    (h, w), ``flow`` (h, w, 2) -> (h, w, 3) float32 in [0, 255].
    FLOW_FOE_YOLO samples at ``sample_yx`` ((1000, 2) y, x in [20, size -
    20)) and fits on the minimal sets ``ransac_idx``; what is not given is
    drawn from ``generator``."""
    if mode_name == "APPEARANCE_RGB":
        return gray_img.to(torch.float32)[..., None].expand(-1, -1, 3).clone()
    if mode_name == "FLOW_UV":
        return flow_to_color_device(flow)
    if mode_name == "FLOW_RADIAL":
        return flow_radial_device(flow)
    if mode_name != "FLOW_FOE_YOLO":
        raise ValueError(f"no NN imagery for mode {mode_name}")

    h, w = flow.shape[:2]
    dev = flow.device
    if sample_yx is None:
        sample_yx = torch.stack([
            torch.randint(FOE_BORDER, h - FOE_BORDER, (FOE_SAMPLES,),
                          generator=generator, device=dev),
            torch.randint(FOE_BORDER, w - FOE_BORDER, (FOE_SAMPLES,),
                          generator=generator, device=dev)], dim=1)
    sample_yx = torch.as_tensor(sample_yx, device=dev).long()
    p0 = sample_yx.flip(1).to(torch.float32)
    mag = _residual_magnitude(flow.to(torch.float32), p0, ransac_idx, generator)
    img = mag * (255.0 / torch.clamp(mag.max(), min=1e-6))
    return img[..., None].expand(-1, -1, 3).clone()
