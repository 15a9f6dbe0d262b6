"""Sparse optical flow: Shi-Tomasi corners + pyramidal Lucas-Kanade
(``mav_detection_tpu.ops.flow.lucas_kanade``): maxCorners 2000, quality 0.2,
minDistance 7, block 7; LK window 21x21, 30 iterations, eps 0.01.

Design notes:
* Corner response (min eigenvalue of the structure tensor) uses the banded
  matmul correlators of the Farneback module.
* Feature selection is fixed-shape: top-K by response after max-pool NMS,
  invalid slots carry a validity mask instead of a ragged array.
* The greedy min-distance sweep is sequential in the reference (one
  dependent step per candidate, inside one compiled program). Here it is
  solved exactly by rounds over all candidates at once (``_greedy_min_distance``),
  with one look from the host per ``SWEEP_ROUNDS`` rounds and no step per
  candidate.
* Tracking batches the iterative solver over the feature axis; each
  feature's 21x21 window gathers are one big gather per iteration. A lane
  that has converged freezes while the others go on; every lane's state is
  masked on the device, so no iteration waits for the host.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from mav_detection_tpu_torch.ops.flow.farneback import _sep_correlate

# rounds of the corner sweep enqueued between two looks at "all decided"
SWEEP_ROUNDS = 8


class Corners(NamedTuple):
    points: torch.Tensor    # (K, 2) float32 (x, y)
    valid: torch.Tensor     # (K,) bool
    response: torch.Tensor  # (K,) float32


class TrackResult(NamedTuple):
    points: torch.Tensor    # (K, 2) tracked positions
    status: torch.Tensor    # (K,) bool: tracked successfully
    error: torch.Tensor     # (K,) mean abs residual in the window


_SOBEL_D = (-1.0, 0.0, 1.0)
_SOBEL_S = (1.0, 2.0, 1.0)


def _gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sobel x/y gradients (aperture 3; scale handled by the caller)."""
    gx = _sep_correlate(img, _SOBEL_S, _SOBEL_D, "edge")
    gy = _sep_correlate(img, _SOBEL_D, _SOBEL_S, "edge")
    return gx, gy


def _greedy_min_distance(cand_x: torch.Tensor, cand_y: torch.Tensor,
                         cand_ok: torch.Tensor, h: int, w: int,
                         min_distance: int) -> torch.Tensor:
    """The greedy min-distance sweep over candidates in priority order
    (index 0 first): candidate i is accepted iff it is ok and no EARLIER
    accepted candidate lies closer than ``min_distance``. Returns the
    accepted mask (n,), without a count cap.

    The sequential sweep's answer is unique, and a candidate's fate depends
    only on its earlier neighbours: it is rejected once one of them is
    accepted, and accepted once all of them are rejected. Candidates sit on
    distinct pixels, so the neighbours come from one gather of a rank image
    over the disc of offsets, and each round settles every candidate whose
    earlier neighbours are settled (at least the first unsettled one)."""
    n = cand_x.shape[0]
    dev = cand_x.device
    r = int(np.ceil(min_distance))
    offs = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)
            if (dy or dx) and dy * dy + dx * dx < min_distance * min_distance]
    accepted = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    if not offs:
        accepted[:n] = cand_ok
        return accepted[:n]
    off = torch.tensor(offs, device=dev)                         # (m, 2)
    rank = torch.full((h * w + 1,), n, dtype=torch.long, device=dev)
    order = torch.arange(n, device=dev)
    # only ok candidates can be accepted, so only they can reject anyone
    rank[torch.where(cand_ok, cand_y * w + cand_x,
                     torch.full_like(cand_x, h * w))] = order
    rank[h * w] = n
    ny = cand_y[:, None] + off[None, :, 0]
    nx = cand_x[:, None] + off[None, :, 1]
    inside = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
    nbr = rank[torch.where(inside, ny * w + nx, torch.full_like(ny, h * w))]
    # later neighbours never matter: point them at the sentinel slot n
    nbr = torch.where(nbr < order[:, None], nbr, torch.full_like(nbr, n))

    decided = torch.ones(n + 1, dtype=torch.bool, device=dev)
    decided[:n] = ~cand_ok
    while True:
        for _ in range(SWEEP_ROUNDS):
            any_acc = accepted[nbr].any(dim=1)
            all_dec = decided[nbr].all(dim=1)
            open_ = ~decided[:n]
            accepted[:n] |= open_ & all_dec & ~any_acc
            decided[:n] |= any_acc | all_dec
        if bool(decided.all()):
            return accepted[:n]


def shi_tomasi_corners(img: torch.Tensor, max_corners: int = 2000,
                       quality_level: float = 0.2, min_distance: int = 7,
                       block_size: int = 7) -> Corners:
    """Good-features-to-track: min-eigenvalue response, quality gate, NMS,
    fixed-K top-k selection."""
    x = img.to(torch.float32)
    gx, gy = _gradients(x)
    box = (1.0,) * block_size
    # structure tensor components summed over the block window
    sxx = _sep_correlate(gx * gx, box, box, "edge")
    syy = _sep_correlate(gy * gy, box, box, "edge")
    sxy = _sep_correlate(gx * gy, box, box, "edge")
    # min eigenvalue of [[sxx, sxy], [sxy, syy]]
    tr = (sxx + syy) * 0.5
    det_part = torch.sqrt(((sxx - syy) * 0.5) ** 2 + sxy ** 2)
    response = tr - det_part

    h, w = x.shape
    dev = x.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # suppress borders (gradient support)
    b = max(block_size // 2, 1) + 1
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    interior = (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)
    response = torch.where(interior, response, zero)

    # quality gate relative to the global max
    gate = quality_level * response.max()
    response = torch.where(response >= gate, response, zero)

    # cv2 scheme: 3x3 local-max NMS, then a greedy min-distance sweep over
    # candidates in descending response order.
    pooled = torch.nn.functional.max_pool2d(response[None, None], 3, 1, 1)[0, 0]
    is_peak = (response == pooled) & (response > 0.0)
    masked = torch.where(is_peak, response, zero)

    n_cand = min(4 * max_corners, h * w)
    # a stable descending sort breaks ties by the lower pixel index first,
    # the order the reference's top_k gives
    vals, idx = torch.sort(masked.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:n_cand], idx[:n_cand]
    cand_x = idx % w
    cand_y = torch.div(idx, w, rounding_mode="floor")
    cand = torch.stack([cand_x, cand_y], dim=1).to(torch.float32)
    cand_ok = vals > 0.0

    accepted = _greedy_min_distance(cand_x, cand_y, cand_ok, h, w, min_distance)
    # the sweep stops accepting at max_corners; later candidates never
    # change an earlier one's fate, so the cap applies afterwards
    taken_before = torch.cumsum(accepted.long(), dim=0) - accepted.long()
    accepted = accepted & (taken_before < max_corners)

    # compact accepted candidates into the first max_corners slots
    order = torch.sort((~accepted).to(torch.uint8), stable=True).indices
    top = order[:max_corners]       # accepted first, by response
    valid = accepted[top]
    resp = torch.where(valid, vals[top], zero)
    return Corners(points=cand[top], valid=valid, response=resp)


def _pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv2.pyrDown: 5-tap Gaussian [1,4,6,4,1]/16 then 2x decimation."""
    k = (1 / 16.0, 4 / 16.0, 6 / 16.0, 4 / 16.0, 1 / 16.0)
    return _sep_correlate(img, k, k, "reflect")[::2, ::2]


def _bilinear_patch(img: torch.Tensor, center: torch.Tensor, half: int
                    ) -> torch.Tensor:
    """Sample a (2*half+1)^2 window around each float ``center`` (x, y):
    (K, 2) -> (K, size, size), indices clamped to the image."""
    h, w = img.shape
    ox = torch.arange(-half, half + 1, dtype=torch.float32, device=img.device)
    size = 2 * half + 1
    gx = (center[:, 0, None, None] + ox[None, None, :]).expand(-1, size, size)
    gy = (center[:, 1, None, None] + ox[None, :, None]).expand(-1, size, size)
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = gx - x0
    fy = gy - y0
    x0i = x0.clamp(0, w - 1).long()
    y0i = y0.clamp(0, h - 1).long()
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    return ((1 - fx) * (1 - fy) * img[y0i, x0i]
            + fx * (1 - fy) * img[y0i, x1i]
            + (1 - fx) * fy * img[y1i, x0i]
            + fx * fy * img[y1i, x1i])


def lucas_kanade_track(img0: torch.Tensor, img1: torch.Tensor,
                       points: torch.Tensor, win: int = 21, iters: int = 30,
                       eps: float = 0.01, levels: int = 3) -> TrackResult:
    """Track ``points`` ((K, 2) float (x, y)) from img0 to img1.

    Pyramidal coarse-to-fine iterative LK with bilinear window sampling and
    the standard 2x2 normal-equation solve per feature per iteration. Per
    level every feature iterates until its own step falls below ``eps`` (or
    ``iters``): a finished lane keeps its displacement while the others go
    on."""
    i0 = img0.to(torch.float32)
    i1 = img1.to(torch.float32)
    points = points.to(torch.float32)
    half = win // 2

    pyr0 = [i0]
    pyr1 = [i1]
    for _ in range(levels - 1):
        pyr0.append(_pyr_down(pyr0[-1]))
        pyr1.append(_pyr_down(pyr1[-1]))

    k = points.shape[0]
    dev = points.device
    d = torch.zeros((k, 2), dtype=torch.float32, device=dev)
    status = torch.ones((k,), dtype=torch.bool, device=dev)
    err = torch.zeros((k,), dtype=torch.float32, device=dev)

    for lvl in reversed(range(levels)):
        p = points / (2.0 ** lvl)
        a0, a1 = pyr0[lvl], pyr1[lvl]
        gx_img, gy_img = _gradients(a0)
        patch0 = _bilinear_patch(a0, p, half)
        gx = _bilinear_patch(gx_img * 0.25, p, half)   # Sobel -> central
        gy = _bilinear_patch(gy_img * 0.25, p, half)   # difference scale
        g00 = (gx * gx).sum(dim=(1, 2))
        g01 = (gx * gy).sum(dim=(1, 2))
        g11 = (gy * gy).sum(dim=(1, 2))
        det = g00 * g11 - g01 * g01
        ok = det > 1e-6
        inv_det = torch.where(ok, 1.0 / torch.clamp(det, min=1e-12),
                              torch.zeros_like(det))

        # each lane runs while its last step was >= eps; the iteration cap is
        # the loop bound
        active = torch.ones((k,), dtype=torch.bool, device=dev)
        for _ in range(iters):
            diff = _bilinear_patch(a1, p + d, half) - patch0
            b0 = (diff * gx).sum(dim=(1, 2))
            b1 = (diff * gy).sum(dim=(1, 2))
            step = torch.stack([-(g11 * b0 - g01 * b1) * inv_det,
                                -(g00 * b1 - g01 * b0) * inv_det], dim=1)
            d = torch.where(active[:, None], d + step, d)
            active = active & (torch.linalg.norm(step, dim=1) >= eps)
        err = (_bilinear_patch(a1, p + d, half) - patch0).abs().mean(dim=(1, 2))
        status = status & ok
        if lvl > 0:
            d = d * 2.0

    new_points = points + d
    h, w = i0.shape
    inside = ((new_points[:, 0] >= 0) & (new_points[:, 0] <= w - 1)
              & (new_points[:, 1] >= 0) & (new_points[:, 1] <= h - 1))
    return TrackResult(points=new_points, status=status & inside, error=err)


class FeaturePool(NamedTuple):
    """Fixed-capacity feature pool replacing upstream's grow/shrink list:
    slots below the replenish floor trigger a re-detection that fills invalid
    slots, shapes never change."""
    points: torch.Tensor  # (K, 2)
    valid: torch.Tensor   # (K,)


def replenish_features(pool: FeaturePool, img: torch.Tensor,
                       max_corners: int = 2000) -> FeaturePool:
    """Fill invalid slots with fresh Shi-Tomasi corners."""
    fresh = shi_tomasi_corners(img, max_corners=max_corners)
    take_fresh = ~pool.valid & fresh.valid
    points = torch.where(take_fresh[:, None], fresh.points, pool.points)
    return FeaturePool(points=points, valid=pool.valid | take_fresh)


def lk_dense_flow(img0: torch.Tensor, img1: torch.Tensor,
                  max_corners: int = 2000, smooth: int = 33) -> torch.Tensor:
    """Dense flow from sparse LK tracks (the --flow-source LUCAS_KANADE path).

    Tracked displacements scatter-add into a grid with validity weights and
    densify by normalized convolution (Knutsson & Westin) with a Gaussian
    applicability: nearby tracks dominate, so interpolation is locally
    accurate instead of a flat window average. Where track density vanishes
    (textureless regions attract no Shi-Tomasi corners) the field blends
    into a validity-weighted global affine fit of all tracks. Upstream never
    densifies LK; this exists so the LK source plugs into the same pipeline
    surface.
    """
    h, w = img0.shape[:2]
    corners = shi_tomasi_corners(img0, max_corners=max_corners,
                                 quality_level=0.05)
    tracked = lucas_kanade_track(img0, img1, corners.points)
    disp = tracked.points - corners.points
    ok = (corners.valid & tracked.status).to(torch.float32)

    xi = corners.points[:, 0].clamp(0, w - 1).long()
    yi = corners.points[:, 1].clamp(0, h - 1).long()
    dev = disp.device
    grid_flow = torch.zeros((h, w, 2), dtype=torch.float32, device=dev)
    grid_flow.index_put_((yi, xi), disp * ok[:, None], accumulate=True)
    grid_wgt = torch.zeros((h, w), dtype=torch.float32, device=dev)
    grid_wgt.index_put_((yi, xi), ok, accumulate=True)

    # normalized convolution: Gaussian applicability (sigma = smooth/4), run
    # as two banded matmuls like every other separable pass
    sigma = smooth / 4.0
    half = smooth // 2
    g = np.exp(-0.5 * (np.arange(-half, half + 1) / sigma) ** 2)
    gk = tuple(float(v) for v in g)
    num = _sep_correlate(grid_flow, gk, gk, "edge")
    den = _sep_correlate(grid_wgt, gk, gk, "edge")
    local = num / torch.clamp(den, min=1e-6)[..., None]

    # validity-weighted affine fit over all tracks: disp ~ [x', y', 1] @ coef
    # with coordinates centered and scaled to ~[-1, 1]: unnormalized normal
    # equations at 1920x1024 have condition ~1e7, past fp32's useful range
    scale = float(max(h, w))
    pts = corners.points
    xn = (pts[:, 0] - w / 2.0) / scale
    yn = (pts[:, 1] - h / 2.0) / scale
    X = torch.stack([xn, yn, torch.ones_like(xn)], dim=1)
    Xw = X * ok[:, None]
    M = X.T @ Xw + 1e-4 * torch.eye(3, dtype=torch.float32, device=dev)
    coef = torch.linalg.solve(M, Xw.T @ disp)  # (3, 2)
    gxn = ((torch.arange(w, dtype=torch.float32, device=dev) - w / 2.0)
           / scale)[None, :, None]
    gyn = ((torch.arange(h, dtype=torch.float32, device=dev) - h / 2.0)
           / scale)[:, None, None]
    plane = gxn * coef[0] + gyn * coef[1] + coef[2]

    # blend by track density: conf -> 1 where tracks are dense, -> 0 where
    # the Gaussian window saw (almost) none
    conf = (den / (den + 0.05))[..., None]
    return conf * local + (1.0 - conf) * plane
