"""Host gray conversion (``mav_detection_tpu.ops.image.color.
bgr_to_gray_host``)."""
from __future__ import annotations

import numpy as np


def bgr_to_gray_host(img, dtype=np.float32) -> np.ndarray:
    """Host-side (NumPy) BT.601 BGR -> gray (cv2.COLOR_BGR2GRAY weights),
    rounded for integer ``dtype``."""
    x = np.asarray(img, np.float32)
    g = 0.114 * x[..., 0] + 0.587 * x[..., 1] + 0.299 * x[..., 2]
    if np.issubdtype(np.dtype(dtype), np.integer):
        return np.round(g).astype(dtype)
    return g.astype(dtype)
