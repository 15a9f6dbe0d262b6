"""Plain float32 detection math: the yardstick of the Detection step.

A frozen copy of the per-frame detection as the configuration states it:
IMU derotation with the quadratic rotational-flow model, the dense FoE vote
(sampled flow-line pairs intersected, a 30 px consensus vote, gate 2.5 px
on the second line), the angle map phi, the dynamic 0.25 +- (0.5 + 8/|OF|)
and fixed 15-degree masks, the pixel rates, the sky rates against the depth
rule, the target's area, mean GT flow and the centre angle seen from the GT
FoE. Plain PyTorch, batched over a leading frame axis, on the device the
inputs lie on. It imports nothing of the program.

``candidates`` returns the FoE candidates and their scores, so that a
judge can score any FoE against them; ``scalars`` returns the per-frame
scalars for a given FoE (the vote's own by default). Everything is computed
in the flow's dtype: float32, or bfloat16 for the control.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

MAGNITUDE_THRESHOLD = 2.5
RANSAC_THRESHOLD = 30.0


def derotate(flow: torch.Tensor, omega: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """(n, h, w, 2) flow minus the rotational field of rates ``omega`` (n, 3)
    over intervals ``dt`` (n,)."""
    n, h, w, _ = flow.shape
    dev, dt_ = flow.device, flow.dtype
    x = torch.arange(w, device=dev, dtype=dt_)[None, None, :]
    y = torch.arange(h, device=dev, dtype=dt_)[None, :, None]
    xn = -(x / w - 0.5) * 2.0
    yn = -(y / h - 0.5) * 2.0
    o0, o1, o2 = (omega[:, i, None, None].to(dt_) for i in range(3))
    dt = dt.to(dt_)[:, None, None]
    u = o0 * xn * yn - o1 * (xn * xn) - o1 + o2 * yn
    v = -o2 * xn + o0 + o0 * (yn * yn) - o1 * xn * yn
    field = torch.stack([u * (w * dt / 2.0), v * (h * dt / 2.0)], dim=-1)
    return flow - field


def _intersect(p1, d1, p2, d2) -> Tuple[torch.Tensor, torch.Tensor]:
    a1, b1 = p1, p1 + d1
    a2, b2 = p2, p2 + d2
    xdiff = torch.stack([a1[..., 0] - b1[..., 0], a2[..., 0] - b2[..., 0]], -1)
    ydiff = torch.stack([a1[..., 1] - b1[..., 1], a2[..., 1] - b2[..., 1]], -1)

    def det(a, b):
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]

    div = det(xdiff, ydiff)
    d = torch.stack([det(a1, b1), det(a2, b2)], -1)
    ok = div != 0
    safe = torch.where(ok, div, torch.ones_like(div))
    pts = torch.stack([det(d, xdiff) / safe, det(d, ydiff) / safe], -1)
    return torch.where(ok[..., None], pts, torch.zeros_like(pts)), ok


def candidates(flow_derot: torch.Tensor, sample_yx: torch.Tensor,
               num_samples: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(points (n, N, 2), valid (n, N), scores (n, N)): each sampled pair of
    flow lines intersected; a candidate's score counts the other valid
    candidates within RANSAC_THRESHOLD px (-1 where it is invalid)."""
    n = flow_derot.shape[0]
    ys = sample_yx[..., 0].long()
    xs = sample_yx[..., 1].long()
    bi = torch.arange(n, device=flow_derot.device)[:, None]
    f = flow_derot[bi, ys, xs]
    coords = torch.stack([xs, ys], -1).to(flow_derot.dtype)
    p1, f1 = coords[:, :num_samples], f[:, :num_samples]
    p2, f2 = coords[:, num_samples:], f[:, num_samples:]
    mag2 = torch.sqrt(f2[..., 0] * f2[..., 0] + f2[..., 1] * f2[..., 1])
    pts, ok = _intersect(p1, f1, p2, f2)
    valid = (mag2 >= MAGNITUDE_THRESHOLD) & ok & (pts[..., 0] != 0.0)
    pts = torch.where(valid[..., None], pts, torch.zeros_like(pts))
    scores = score_points(pts, pts, valid) - 1
    scores = torch.where(valid, scores, torch.full_like(scores, -1))
    return pts, valid, scores


def score_points(points: torch.Tensor, cands: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """(n, P) count of valid candidates (n, N, 2) within RANSAC_THRESHOLD
    px of each point (n, P, 2)."""
    diff = points[:, :, None, :] - cands[:, None, :, :]
    dist = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    return (valid[:, None, :] & (dist < RANSAC_THRESHOLD)).sum(dim=2)


def vote(pts: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """(n, 2): the first candidate of the highest positive score, else 0."""
    best = torch.argmax(scores, dim=1)
    best_score = scores.gather(1, best[:, None])[:, 0]
    pick = pts.gather(1, best[:, None, None].expand(-1, 1, 2))[:, 0]
    return torch.where((best_score > 0)[:, None], pick, torch.zeros_like(pick))


def phi_map(flow_derot: torch.Tensor, foe: torch.Tensor) -> torch.Tensor:
    _, h, w, _ = flow_derot.shape
    dev = flow_derot.device
    x = torch.arange(w, device=dev, dtype=flow_derot.dtype)[None, None, :]
    y = torch.arange(h, device=dev, dtype=flow_derot.dtype)[None, :, None]
    foe = foe.to(flow_derot.dtype)
    rx = x - foe[:, 0, None, None]
    ry = y - foe[:, 1, None, None]
    mag = torch.sqrt(flow_derot[..., 0] * flow_derot[..., 0]
                     + flow_derot[..., 1] * flow_derot[..., 1])
    dist = torch.sqrt(rx * rx + ry * ry)
    arg = (flow_derot[..., 0] * rx + flow_derot[..., 1] * ry) / torch.clamp(mag * dist, min=1e-6)
    return torch.nan_to_num(torch.arccos(torch.clamp(arg, -1.0, 1.0))) * (180.0 / math.pi)


def rates(gt: torch.Tensor, est: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame (tpr, fpr) with integer-product thresholding at 127."""
    gt = gt.to(torch.int32)
    est = est.to(torch.int32)
    dims = tuple(range(1, gt.ndim))
    pos = (gt > 127).sum(dims).to(torch.float32)
    neg = ((255 - gt) > 127).sum(dims).to(torch.float32)
    tp = ((gt * est) > 127).sum(dims).to(torch.float32)
    fp = (((255 - gt) * est) > 127).sum(dims).to(torch.float32)
    return tp / pos, fp / neg


def bounding_box(seg: torch.Tensor) -> torch.Tensor:
    """(n, 4) [x0, y0, x1, y1] of pixels above 0.1 of the frame's max; -1s
    for none."""
    n, h, w = seg.shape
    thr = 0.1 * seg.reshape(n, -1).max(dim=1).values.to(torch.float32)
    mask = seg > thr[:, None, None]
    out = torch.full((n, 4), -1, dtype=torch.int64)
    for i in range(n):
        rows = torch.nonzero(mask[i].any(dim=1)).flatten()
        cols = torch.nonzero(mask[i].any(dim=0)).flatten()
        if rows.numel() and cols.numel():
            out[i] = torch.stack([cols[0], rows[0], cols[-1], rows[-1]]).cpu()
    return out.to(seg.device)


def scalars(flow: torch.Tensor, gt_flow: torch.Tensor, omega: torch.Tensor,
            dt: torch.Tensor, seg: torch.Tensor, sky: torch.Tensor,
            depth: torch.Tensor, gt_foe: torch.Tensor, sample_yx: torch.Tensor,
            num_samples: int, foe: Optional[torch.Tensor] = None,
            dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Per-frame scalars of a batch of pairs (float32), computed in
    ``dtype``; with ``foe`` (n, 2) given, the masks and rates are those of
    that FoE, else of the vote's."""
    n = flow.shape[0]
    fd = derotate(flow.to(dtype), omega, dt)
    gd = derotate(gt_flow.to(dtype), omega, dt)
    mag = torch.sqrt(fd[..., 0] * fd[..., 0] + fd[..., 1] * fd[..., 1])
    depth = depth.to(dtype)
    dmax = depth.reshape(n, -1).max(dim=1).values[:, None, None]
    sky_gt = depth > 0.8 * dmax
    sky_tpr, sky_fpr = rates(sky_gt.to(torch.uint8) * 255, sky.to(torch.uint8) * 255)
    if foe is None:
        pts, _, sc = candidates(fd, sample_yx, num_samples)
        foe = vote(pts, sc)
    phi = phi_map(fd, foe)
    band = 0.5 + 8.0 / mag
    dyn = (phi > 0.25 + band) | (phi < 0.25 - band)
    total = (mag > 0.5) & (~sky) & dyn
    fixed = (phi * (mag > 1.0) * (~sky)) > 15.0
    tpr, fpr = rates(seg, 255 * total.to(torch.int32))
    tpr_f, fpr_f = rates(seg, 255 * fixed.to(torch.int32))
    pos = seg > 127
    m = pos.to(dtype)[..., None]
    drone_flow = (gd * m).sum(dim=(1, 2)) / m.sum(dim=(1, 2))
    box = bounding_box(seg).to(dtype)
    cx = (box[:, 0] + box[:, 2]) / 2.0
    cy = (box[:, 1] + box[:, 3]) / 2.0
    g = gt_foe.to(dtype)
    center_phi = torch.atan2(cy - g[:, 1], cx - g[:, 0]) * (180.0 / math.pi)
    out = {"foe": foe, "tpr": tpr, "fpr": fpr, "tpr_fixed": tpr_f,
           "fpr_fixed": fpr_f, "sky_tpr": sky_tpr, "sky_fpr": sky_fpr,
           "drone_size_pixels": pos.reshape(n, -1).sum(dim=1),
           "drone_flow_pixels": drone_flow, "center_phi": center_phi}
    return {k: v.to(torch.float32) for k, v in out.items()}
