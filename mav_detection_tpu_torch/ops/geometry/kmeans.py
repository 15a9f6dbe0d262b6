"""K-means clustering as batched Lloyd iterations
(``mav_detection_tpu.ops.geometry.kmeans``).

Replaces ``cv2.kmeans`` in the flow-magnitude clustering path: K=8, 10
attempts with random centers, 10 Lloyd iterations per attempt, best
compactness wins, with every attempt run at once on a leading axis.

The initial centers are a random draw, which cannot match across frameworks:
``init_idx`` ((attempts, k) point indices, distinct within an attempt) feeds
them in; without it they come from ``generator``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _sq_dists(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(N, D) x (A, k, D) -> (A, N, k) squared distances, accumulated over D
    so that no (A, N, k, D) block is ever materialised."""
    d2 = None
    for j in range(points.shape[1]):
        diff = points[None, :, None, j] - centers[:, None, :, j]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return d2


def kmeans(points: torch.Tensor, init_idx: Optional[torch.Tensor] = None,
           k: int = 8, iters: int = 10, attempts: int = 10,
           generator: Optional[torch.Generator] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cluster (N, D) points; returns (compactness, labels (N,), centers
    (k, D)) of the attempt with the least compactness."""
    n = points.shape[0]
    if init_idx is None:
        init_idx = torch.stack([
            torch.randperm(n, generator=generator, device=points.device)[:k]
            for _ in range(attempts)])
    init_idx = torch.as_tensor(init_idx, device=points.device).long()
    if init_idx.ndim != 2 or init_idx.shape[1] != k:
        raise ValueError(f"init_idx must be (attempts, {k}), got "
                         f"{tuple(init_idx.shape)}")
    centers = points[init_idx]                               # (A, k, D)
    ks = torch.arange(k, device=points.device)

    for _ in range(iters):
        labels = torch.argmin(_sq_dists(points, centers), dim=2)   # (A, N)
        onehot = (labels[..., None] == ks).to(points.dtype)      # (A, N, k)
        counts = onehot.sum(dim=1)                           # (A, k)
        sums = torch.matmul(onehot.transpose(1, 2), points)  # (A, k, D)
        new_centers = sums / torch.clamp(counts[..., None], min=1.0)
        # empty clusters keep their previous center
        centers = torch.where(counts[..., None] > 0, new_centers, centers)

    d2 = _sq_dists(points, centers)
    mins, labels = torch.min(d2, dim=2)      # first minimum, as argmin
    comps = mins.sum(dim=1)
    best = torch.argmin(comps)
    return comps[best], labels[best], centers[best]


def cluster_image(img: torch.Tensor, init_idx: Optional[torch.Tensor] = None,
                  k: int = 8, generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Upstream's ``Detector.clustering``: cluster pixel intensities, rescale
    centers to [0, 255] by the max center, return the quantized uint8 image
    and the brightest-cluster mask (centers >= 225 after rescale)."""
    h, w = img.shape[0], img.shape[1]
    flat = img.reshape(-1, 1).to(torch.float32)
    _, labels, centers = kmeans(flat, init_idx, k=k, generator=generator)
    max_c = torch.clamp(centers.max(), min=1e-6)
    centers_u8 = torch.round(centers * 255.0 / max_c)
    quantized = centers_u8[labels, 0].reshape(h, w)
    return quantized.to(torch.uint8), quantized >= 225
