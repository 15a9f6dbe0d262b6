"""Image/flow metrics (``mav_detection_tpu.ops.image.metrics``), batched
over a leading frame axis: the flow magnitude and angle, and pixel rates.

Pixel rates with upstream's integer-product thresholding:
``tpr = sum(gt*est > 127) / sum(gt > 127)``,
``fpr = sum((255-gt)*est > 127) / sum((255-gt) > 127)``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def get_magnitude(img: torch.Tensor) -> torch.Tensor:
    """L2 magnitude over the trailing axis, e.g. (h, w, 2) -> (h, w)."""
    return torch.linalg.vector_norm(img, dim=-1)


def get_rho(img: torch.Tensor) -> torch.Tensor:
    """Flow angle arctan2(v, u) in radians, (h, w, 2) -> (h, w)."""
    return torch.atan2(img[..., 1], img[..., 0])


def _tpr_fpr(gt_img: torch.Tensor, img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame (tpr, fpr) of (n, h, w) images -> two (n,) float32.

    Promote to int32 first: upstream multiplies uint8 arrays in numpy (which
    promotes), so 255*255 must not wrap. Counts convert to float32 before the
    division (an empty class gives NaN, as upstream)."""
    gt = gt_img.to(torch.int32)
    est = img.to(torch.int32)
    dims = tuple(range(1, gt.ndim))
    positives = (gt > 127).sum(dims).to(torch.float32)
    negatives = ((255 - gt) > 127).sum(dims).to(torch.float32)
    true_positives = ((gt * est) > 127).sum(dims).to(torch.float32)
    false_positives = (((255 - gt) * est) > 127).sum(dims).to(torch.float32)
    return true_positives / positives, false_positives / negatives


def calculate_tpr_fpr(gt_img: torch.Tensor, img: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tpr, fpr) of one (h, w) image pair, as two 0-d float32 tensors
    (``mav_detection_tpu.ops.image.metrics.calculate_tpr_fpr``)."""
    tpr, fpr = _tpr_fpr(gt_img[None], img[None])
    return tpr[0], fpr[0]


def tpr_fpr_counts(gt_img: torch.Tensor, img: torch.Tensor,
                   frame_weight: torch.Tensor) -> torch.Tensor:
    """Per-batch [tp, fp, pos, neg] counts (float32, shape (4,)) with a
    per-frame weight (0 masks a frame out, e.g. padding)."""
    gt = gt_img.to(torch.int32)
    est = img.to(torch.int32)
    w = frame_weight.to(torch.float32)[:, None, None]
    tp = (((gt * est) > 127) * w).sum()
    fp = ((((255 - gt) * est) > 127) * w).sum()
    pos = ((gt > 127) * w).sum()
    neg = (((255 - gt) > 127) * w).sum()
    return torch.stack([tp, fp, pos, neg])


def masked_mean_flow(flow_uv: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean flow vector over masked pixels, (n, h, w, 2) x (n, h, w) ->
    (n, 2); NaN for an empty mask."""
    m = mask.to(flow_uv.dtype)[..., None]
    total = (flow_uv * m).sum(dim=(1, 2))
    count = m.sum(dim=(1, 2))
    return total / count
