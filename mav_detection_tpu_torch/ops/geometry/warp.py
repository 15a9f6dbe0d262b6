"""Bilinear image warps (remap / affine / perspective)
(``mav_detection_tpu.ops.geometry.warp``).

cv2 semantics: the given matrix is the FORWARD transform; each destination
pixel samples the source at M^-1 (dst), out-of-range samples read 0
(BORDER_CONSTANT).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (h, w[, c]) at float coords (map_x, map_y).

    BORDER_CONSTANT(0) semantics per *tap* like cv2: a sample straddling the
    border mixes in zeros for the out-of-range neighbors instead of zeroing
    the whole output pixel. Written as plain gathers with clamped indices
    (``F.grid_sample`` is close but not held to this per-tap rule).
    """
    h, w = img.shape[0], img.shape[1]
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    x0i = x0.long()
    y0i = y0.long()
    trail = (None,) * (img.ndim - 2)

    def tap(yy, xx, wgt):
        ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        g = img[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        return (wgt * ok.to(wgt.dtype))[(...,) + trail] * g

    out = (tap(y0i, x0i, (1 - fx) * (1 - fy))
           + tap(y0i, x0i + 1, fx * (1 - fy))
           + tap(y0i + 1, x0i, (1 - fx) * fy)
           + tap(y0i + 1, x0i + 1, fx * fy))
    return out.to(img.dtype)


def sample_bilinear_replicate(fmap: torch.Tensor, cx: torch.Tensor,
                              cy: torch.Tensor) -> torch.Tensor:
    """Clamped bilinear sampling of (h, w[, c]) at float coords with
    REPLICATE borders (a distinct border contract from ``remap_bilinear``'s
    BORDER_CONSTANT)."""
    h, w = fmap.shape[:2]
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    fx = cx - x0
    fy = cy - y0
    x0i = x0.clamp(0, w - 1).long()
    y0i = y0.clamp(0, h - 1).long()
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    if fmap.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    return ((1 - fx) * (1 - fy) * fmap[y0i, x0i]
            + fx * (1 - fy) * fmap[y0i, x1i]
            + (1 - fx) * fy * fmap[y1i, x0i]
            + fx * fy * fmap[y1i, x1i])


def _dst_grid(out_hw: Tuple[int, int], device: torch.device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xs, ys) float32 pixel coordinates, each (h, w)."""
    h, w = out_hw
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    return xs, ys


def warp_affine(img: torch.Tensor, M: torch.Tensor,
                out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """cv2.warpAffine parity: M is 2x3 forward; sample src at M^-1(dst)."""
    if out_hw is None:
        out_hw = (img.shape[0], img.shape[1])
    M3 = torch.cat([M, M.new_tensor([[0.0, 0.0, 1.0]])], dim=0)
    Minv = torch.linalg.inv(M3)
    xs, ys = _dst_grid(out_hw, img.device)
    sx = Minv[0, 0] * xs + Minv[0, 1] * ys + Minv[0, 2]
    sy = Minv[1, 0] * xs + Minv[1, 1] * ys + Minv[1, 2]
    return remap_bilinear(img, sx, sy)


def warp_perspective(img: torch.Tensor, H: torch.Tensor,
                     out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """cv2.warpPerspective parity: H is 3x3 forward; inverse-map and divide."""
    if out_hw is None:
        out_hw = (img.shape[0], img.shape[1])
    Hinv = torch.linalg.inv(H)
    xs, ys = _dst_grid(out_hw, img.device)
    sx = Hinv[0, 0] * xs + Hinv[0, 1] * ys + Hinv[0, 2]
    sy = Hinv[1, 0] * xs + Hinv[1, 1] * ys + Hinv[1, 2]
    sz = Hinv[2, 0] * xs + Hinv[2, 1] * ys + Hinv[2, 2]
    sz = torch.where(sz.abs() > 1e-12, sz, torch.full_like(sz, 1e-12))
    return remap_bilinear(img, sx / sz, sy / sz)
