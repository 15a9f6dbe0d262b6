"""Image resizing on the tensor's device
(``mav_detection_tpu.ops.image.resize``, built there on ``jax.image.resize``).

``"linear"`` is the triangle kernel on half-pixel sample points WITH
antialiasing on downscale (the kernel widens by the scale factor), as two
matmuls against ``_resize_matrix_np``; ``F.interpolate(mode="bilinear")``
does not antialias and gives a different pyramid. ``"nearest"`` reads source
index ``floor((i + 0.5) * src / dst)``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mav_detection_tpu_torch.ops.flow.farneback import _device_const, resize_linear_cf


def _nearest_index(src: int, dst: int, device: torch.device) -> torch.Tensor:
    idx = np.floor((np.arange(dst) + 0.5) * (src / dst)).astype(np.int64)
    return torch.from_numpy(np.minimum(idx, src - 1)).to(device)


def resize(img: torch.Tensor, shape: Tuple[int, int],
           method: str = "linear") -> torch.Tensor:
    """Resize the leading two (spatial) dims of ``(h, w[, c])`` to ``shape``
    (h, w), keeping channels."""
    h, w = img.shape[:2]
    lh, lw = shape
    if method == "nearest":
        rows = _nearest_index(h, lh, img.device)
        cols = _nearest_index(w, lw, img.device)
        return img[rows][:, cols]
    if method != "linear":
        raise ValueError(f"unsupported resize method {method!r}")
    x = img.to(torch.float32)
    Rv = _device_const("resize", (h, lh), img.device)      # (lh, h)
    Rh = _device_const("resize", (w, lw), img.device)      # (lw, w)
    if x.ndim == 2:
        return torch.matmul(torch.matmul(Rv, x), Rh.T)
    # channels last: contract h, then w, leaving (lh, lw, c)
    y = torch.einsum("ah,hwc->awc", Rv, x)
    return torch.einsum("bw,awc->abc", Rh, y)


def resize_frames(frames: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """``resize(..., "linear")`` of every frame of (n, h, w[, c]) at once, in
    fp32 (``jax.image.resize`` to (n, lh, lw[, c]))."""
    x = frames.to(torch.float32)
    if x.ndim == 3:
        return resize_linear_cf(x, shape)
    return resize_linear_cf(x.permute(0, 3, 1, 2), shape).permute(0, 2, 3, 1)


def resize_percent(img: torch.Tensor, scale_percent: float,
                   method: str = "linear") -> torch.Tensor:
    """Percent-based resize."""
    h = int(img.shape[0] * scale_percent / 100)
    w = int(img.shape[1] * scale_percent / 100)
    return resize(img, (h, w), method=method)


def resize_width(img: torch.Tensor, width: int) -> torch.Tensor:
    """Aspect-preserving resize to a target width (imutils.resize semantics)."""
    h = int(round(img.shape[0] * width / img.shape[1]))
    return resize(img, (h, width))
