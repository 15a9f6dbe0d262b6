"""The port's single-step entry point: ``entry()`` returns the fused flow +
detection step and example arguments for it (the counterpart of the
reference's ``__graft_entry__.entry``).

The step takes a grayscale frame pair plus IMU and aux inputs and runs the
Farneback solver and the whole detection math (derotation, FoE vote, phi,
threshold masks, pixel metrics) on the arguments' device. The reference's
PRNG key becomes the (2N, 2) (y, x) sample indices of the FoE vote, the last
argument. Flow parameters are the product's, ``tuned_flow_params(240, 320)``
with its (2, 3, 8) iteration schedule, so on the card the step launches the
fused iteration kernel.
"""
from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import torch

from mav_detection_tpu_torch.ops.flow.farneback import (
    _farneback_cf,
    tuned_flow_params,
)
from mav_detection_tpu_torch.pipeline.detector import (
    DetectionStep,
    detect_frame_pair,
)
from mav_detection_tpu_torch.utils.device import resolve_device

ENTRY_SHAPE = (240, 320)
ENTRY_FOE_SAMPLES = 512


def entry(device: Union[str, torch.device] = "cuda"
          ) -> Tuple[Callable, Tuple[torch.Tensor, ...]]:
    """(fn, example_args) for the fused flow + detect step at 240x320 with
    512 FoE samples; ``fn(*example_args)`` returns ``foe, tpr_fixed,
    fpr_fixed, total_mask``. The example arguments are seeded numpy draws
    (the reference's, with the sample indices drawn last) on ``device``.
    Raises without a card unless ``device="cpu"``."""
    dev = resolve_device(device)
    h, w = ENTRY_SHAPE
    params = tuned_flow_params(h, w)
    config = DetectionStep(foe_samples=ENTRY_FOE_SAMPLES)

    def flow_detect_step(prev_gray, curr_gray, omega, dt, segmentation,
                         sky_mask, depth, gt_foe, sample_yx):
        flow = _farneback_cf(prev_gray[None], curr_gray[None], params)[0]
        out = detect_frame_pair(flow, torch.zeros_like(flow), omega, dt,
                                segmentation, sky_mask, depth, gt_foe,
                                sample_yx, config=config)
        return out.foe, out.tpr_fixed, out.fpr_fixed, out.total_mask

    rng = np.random.default_rng(0)
    n = 2 * ENTRY_FOE_SAMPLES
    host_args = (
        rng.random((h, w)).astype(np.float32) * 255,
        rng.random((h, w)).astype(np.float32) * 255,
        np.zeros(3, np.float32),
        np.asarray(0.05, np.float32),
        (rng.random((h, w)) > 0.99).astype(np.uint8) * 255,
        np.zeros((h, w), bool),
        np.ones((h, w), np.float32),
        np.asarray([w / 2.0, h / 2.0], np.float32),
        np.stack([rng.integers(0, h, n), rng.integers(0, w, n)], axis=-1),
    )
    return flow_detect_step, tuple(torch.from_numpy(a).to(dev)
                                   for a in host_args)
