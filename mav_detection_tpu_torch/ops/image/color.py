"""Color-space conversions (``mav_detection_tpu.ops.image.color``): the host
gray shared by staging, and the tensor versions."""
from __future__ import annotations

import numpy as np
import torch


def bgr_to_gray_host(img, dtype=np.float32) -> np.ndarray:
    """Host-side (NumPy) BT.601 BGR -> gray (cv2.COLOR_BGR2GRAY weights),
    rounded for integer ``dtype``."""
    x = np.asarray(img, np.float32)
    g = 0.114 * x[..., 0] + 0.587 * x[..., 1] + 0.299 * x[..., 2]
    if np.issubdtype(np.dtype(dtype), np.integer):
        return np.round(g).astype(dtype)
    return g.astype(dtype)


def _gray(img: torch.Tensor, w0: float, w1: float, w2: float) -> torch.Tensor:
    x = img.to(torch.float32)
    gray = w0 * x[..., 0] + w1 * x[..., 1] + w2 * x[..., 2]
    if not img.dtype.is_floating_point:
        return torch.round(gray).to(img.dtype)
    return gray


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """BGR (..., 3) -> grayscale with ITU-R BT.601 weights (0.114 B + 0.587 G
    + 0.299 R, cv2.COLOR_BGR2GRAY), rounded when the input is an integer
    type."""
    return _gray(img, 0.114, 0.587, 0.299)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """RGB (..., 3) -> grayscale, BT.601."""
    return _gray(img, 0.299, 0.587, 0.114)
