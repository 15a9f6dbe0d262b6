"""Threshold-based bounding boxes (``mav_detection_tpu.ops.image.boxes``):
the host versions (numpy, copies of the reference's) and the device box,
batched over a leading frame axis."""
from __future__ import annotations

import numpy as np
import torch

from mav_detection_tpu_torch.core.rectangle import Rectangle


def get_simple_bounding_box(img: np.ndarray) -> Rectangle:
    """Fit a box around pixels with intensity > 0.1 * max (host/numpy)."""
    img = np.asarray(img)
    threshold = 0.1 * np.max(img) if img.size else 0.0
    mask = img > threshold
    if mask.ndim > 2:
        mask = mask.any(axis=tuple(range(2, mask.ndim)))
    rows = np.flatnonzero(mask.any(axis=1))
    cols = np.flatnonzero(mask.any(axis=0))
    if rows.size == 0 or cols.size == 0:
        return Rectangle.from_points((-1, -1), (-1, -1))
    return Rectangle.from_points(
        (int(cols[0]), int(rows[0])), (int(cols[-1]), int(rows[-1]))
    )


def box_array_to_rectangle(box: np.ndarray) -> Rectangle:
    """Convert a device [sx, sy, ex, ey] array back into a Rectangle."""
    sx, sy, ex, ey = [int(v) for v in np.asarray(box)]
    return Rectangle.from_points((sx, sy), (ex, ey))


def get_simple_bounding_box_device(img: torch.Tensor) -> torch.Tensor:
    """(n, h, w[, c]) -> (n, 4) int64 [start_x, start_y, end_x, end_y] of the
    pixels brighter than 0.1 * the frame's max; -1s for an empty mask."""
    n = img.shape[0]
    flat = img.reshape(n, -1)
    threshold = 0.1 * flat.max(dim=1).values.to(torch.float32)
    mask = img > threshold.view((n,) + (1,) * (img.ndim - 1))
    if mask.ndim > 3:
        mask = mask.any(dim=tuple(range(3, mask.ndim)))
    _, h, w = mask.shape
    row_any = mask.any(dim=2)
    col_any = mask.any(dim=1)
    dev = img.device
    row_idx = torch.arange(h, device=dev)
    col_idx = torch.arange(w, device=dev)
    # made on the device (a scalar copied up from the host would synchronise)
    big = torch.full((), max(h, w), dtype=torch.int64, device=dev)
    neg = torch.full((), -1, dtype=torch.int64, device=dev)
    start_y = torch.where(row_any, row_idx, big).min(dim=1).values
    end_y = torch.where(row_any, row_idx, neg).max(dim=1).values
    start_x = torch.where(col_any, col_idx, big).min(dim=1).values
    end_x = torch.where(col_any, col_idx, neg).max(dim=1).values
    box = torch.stack([start_x, start_y, end_x, end_y], dim=1)
    empty = ~mask.reshape(n, -1).any(dim=1)
    return torch.where(empty[:, None], torch.full_like(box, -1), box)
