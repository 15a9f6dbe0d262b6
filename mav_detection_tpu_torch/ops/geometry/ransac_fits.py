"""Batched RANSAC ego-motion model fitting
(``mav_detection_tpu.ops.geometry.ransac_fits``): affine / homography /
fundamental / essential estimation from ~1000 sampled flow correspondences.

Hypothesis generation is one batched small solve over K minimal samples (a
leading K axis on ``torch.linalg.solve`` / ``svd`` in place of ``vmap``),
consensus scoring is one (K, N) residual matrix reduction, and the winner is
refit by weighted least squares over its inliers; no data-dependent shapes
and no host synchronisation.

Random draws cannot match across frameworks, so every RANSAC fit takes its
minimal sets as ``idx`` ((K, set_size) point indices); without them it draws
from ``generator``.

cv2 parameter parity targets:
* ``estimateAffine2D``: RANSAC, reprojection threshold 3.0 px (defaults).
* ``findHomography(coords_old, coords_new)``: method 0 = plain least squares
  over ALL points (upstream's call has no RANSAC flag).
* ``findFundamentalMat(..., FM_RANSAC, 0.999, 1.0)``: threshold 0.999 px.
* ``findEssentialMat(..., focal, (0,0), FM_RANSAC, 0.999, 1.0)``.

The sign of a null vector from an SVD is arbitrary and LAPACK and cuSOLVER
may pick differently: it cancels in ``H / H[2, 2]`` but F and E keep it, so
compare those up to sign or by what they do (Sampson distance).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


# ------------------------------------------------------------------ helpers
def _sample_minimal_sets(n_points: int, k_hyps: int, set_size: int,
                         generator: Optional[torch.Generator],
                         device: torch.device) -> torch.Tensor:
    """(k_hyps, set_size) random index sets (with replacement across sets)."""
    return torch.randint(0, n_points, (k_hyps, set_size), generator=generator,
                         device=device)


def _resolve_idx(idx, n: int, iters: int, set_size: int, generator, device):
    if idx is None:
        return _sample_minimal_sets(n, iters, set_size, generator, device)
    idx = torch.as_tensor(idx, device=device).long()
    if idx.ndim != 2 or idx.shape[1] != set_size:
        raise ValueError(f"idx must be (K, {set_size}), got {tuple(idx.shape)}")
    return idx


def _homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _normalize_points(pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hartley normalization over the point axis of (..., N, 2): translate to
    the centroid, scale the mean distance to sqrt(2). Returns the normalized
    points and the (..., 3, 3) transform."""
    mean = pts.mean(dim=-2, keepdim=True)
    centered = pts - mean
    scale = math.sqrt(2.0) / torch.clamp(
        torch.linalg.norm(centered, dim=-1).mean(dim=-1), min=1e-8)
    T = torch.zeros(pts.shape[:-2] + (3, 3), dtype=pts.dtype, device=pts.device)
    T[..., 0, 0] = scale
    T[..., 1, 1] = scale
    T[..., 0, 2] = -scale * mean[..., 0, 0]
    T[..., 1, 2] = -scale * mean[..., 0, 1]
    T[..., 2, 2] = 1.0
    return centered * scale[..., None, None], T


def _consensus(res: torch.Tensor, threshold: float) -> torch.Tensor:
    """Inlier mask (N,) of the first hypothesis with the most inliers; a
    hypothesis from a degenerate minimal set has non-finite residuals, which
    count as outliers."""
    res = torch.where(torch.isfinite(res), res, torch.full_like(res, math.inf))
    scores = (res < threshold).sum(dim=1)
    best = torch.argmax(scores)       # first maximum, on the device
    return res[best] < threshold


# ------------------------------------------------------------------- affine
def _affine_from_3pts(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Exact 2x3 affines mapping three points p0 -> p1, (K, 3, 2) -> (K, 2, 3).
    Singular (collinear) sets give non-finite entries instead of raising."""
    A = _homogeneous(p0)                                   # (K, 3, 3)
    sol, _ = torch.linalg.solve_ex(A, p1)                  # (K, 3, 2)
    return sol.transpose(-1, -2)


def _affine_residuals(M: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor
                      ) -> torch.Tensor:
    """(K, 2, 3) x (N, 2) -> (K, N) reprojection distances."""
    pred = torch.matmul(p0, M[..., :2].transpose(-1, -2)) + M[..., None, :, 2]
    return torch.linalg.norm(pred - p1, dim=-1)


def _affine_lstsq(p0: torch.Tensor, p1: torch.Tensor, w: torch.Tensor
                  ) -> torch.Tensor:
    """Weighted least-squares affine via normal equations (static shape)."""
    A = _homogeneous(p0)
    Aw = A * w[:, None]
    AtA = A.T @ Aw + 1e-8 * torch.eye(3, dtype=p0.dtype, device=p0.device)
    return torch.linalg.solve(AtA, Aw.T @ p1).T


def fit_affine_ransac(p0: torch.Tensor, p1: torch.Tensor,
                      idx: Optional[torch.Tensor] = None, iters: int = 256,
                      threshold: float = 3.0,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RANSAC 2x3 affine fit; returns (M, inlier_mask)."""
    idx = _resolve_idx(idx, p0.shape[0], iters, 3, generator, p0.device)
    hyps = _affine_from_3pts(p0[idx], p1[idx])             # (K, 2, 3)
    inliers = _consensus(_affine_residuals(hyps, p0, p1), threshold)
    return _affine_lstsq(p0, p1, inliers.to(p0.dtype)), inliers


# --------------------------------------------------------------- homography
def _homography_dlt(p0: torch.Tensor, p1: torch.Tensor, w: torch.Tensor
                    ) -> torch.Tensor:
    """Weighted DLT over (..., N, 2) points: the smallest right singular
    vector of the (2N, 9) system, (..., 3, 3)."""
    x, y = p0[..., 0], p0[..., 1]
    u, v = p1[..., 0], p1[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], dim=-1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    _, _, vt = torch.linalg.svd(A, full_matrices=False)
    return vt[..., -1, :].reshape(p0.shape[:-2] + (3, 3))


def _homography_residuals(H: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor
                          ) -> torch.Tensor:
    """(..., 3, 3) x (N, 2) -> (..., N) reprojection distances."""
    proj = torch.matmul(_homogeneous(p0), H.transpose(-1, -2))
    z = proj[..., 2]
    zsafe = torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))
    pred = proj[..., :2] / zsafe[..., None]
    return torch.linalg.norm(pred - p1, dim=-1)


def _homography_normalized_dlt(p0: torch.Tensor, p1: torch.Tensor,
                               w: torch.Tensor) -> torch.Tensor:
    p0n, T0 = _normalize_points(p0)
    p1n, T1 = _normalize_points(p1)
    H = torch.linalg.inv(T1) @ _homography_dlt(p0n, p1n, w) @ T0
    h22 = H[2, 2]
    return H / torch.where(h22.abs() > 1e-12, h22, torch.full_like(h22, 1e-12))


def fit_homography_lstsq(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Plain least-squares homography over all points (the semantics of
    ``cv2.findHomography`` with no method flag). Normalized DLT, rescaled so
    H[2,2] = 1."""
    return _homography_normalized_dlt(p0, p1, torch.ones_like(p0[:, 0]))


def fit_homography_ransac(p0: torch.Tensor, p1: torch.Tensor,
                          idx: Optional[torch.Tensor] = None, iters: int = 256,
                          threshold: float = 3.0,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RANSAC homography (4-point DLT hypotheses + DLT refit on inliers)."""
    idx = _resolve_idx(idx, p0.shape[0], iters, 4, generator, p0.device)
    q0, q1 = p0[idx], p1[idx]                              # (K, 4, 2)
    hyps = _homography_dlt(q0, q1, torch.ones_like(q0[..., 0]))
    inliers = _consensus(_homography_residuals(hyps, p0, p1), threshold)
    return _homography_normalized_dlt(p0, p1, inliers.to(p0.dtype)), inliers


# -------------------------------------------- fundamental / essential (8pt)
def _eightpoint(p0: torch.Tensor, p1: torch.Tensor, w: torch.Tensor,
                essential: bool) -> torch.Tensor:
    """Normalized 8-point algorithm over (..., N, 2) points; optionally
    project onto the essential manifold (singular values (s, s, 0) with s =
    mean of the top two)."""
    p0n, T0 = _normalize_points(p0)
    p1n, T1 = _normalize_points(p1)
    x, y = p0n[..., 0], p0n[..., 1]
    u, v = p1n[..., 0], p1n[..., 1]
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y,
                     torch.ones_like(x)], dim=-1) * w[..., None]
    _, _, vt = torch.linalg.svd(A, full_matrices=False)
    F = vt[..., -1, :].reshape(p0.shape[:-2] + (3, 3))
    U, S, Vt = torch.linalg.svd(F)
    if essential:
        s = (S[..., 0] + S[..., 1]) / 2.0
        S = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    else:
        S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    F = U @ torch.diag_embed(S) @ Vt
    F = T1.transpose(-1, -2) @ F @ T0
    norm = torch.linalg.norm(F, dim=(-2, -1), keepdim=True)
    return F / torch.where(norm > 1e-12, norm, torch.ones_like(norm))


def _sampson_dist(F: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor
                  ) -> torch.Tensor:
    """Sampson distance (first-order geometric error) of x1^T F x0 = 0,
    (..., 3, 3) x (N, 2) -> (..., N)."""
    ph0 = _homogeneous(p0)
    ph1 = _homogeneous(p1)
    Fx0 = torch.matmul(ph0, F.transpose(-1, -2))      # (..., N, 3) = F x0
    Ftx1 = torch.matmul(ph1, F)                       # (..., N, 3) = F^T x1
    num = (ph1 * Fx0).sum(dim=-1) ** 2
    den = (Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2
           + Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2)
    return torch.sqrt(num / torch.clamp(den, min=1e-12))


def _fit_epipolar_ransac(p0, p1, idx, iters, threshold, essential, generator):
    idx = _resolve_idx(idx, p0.shape[0], iters, 8, generator, p0.device)
    q0, q1 = p0[idx], p1[idx]                              # (K, 8, 2)
    hyps = _eightpoint(q0, q1, torch.ones_like(q0[..., 0]), essential)
    inliers = _consensus(_sampson_dist(hyps, p0, p1), threshold)
    # Iterated refit: float32 8-point at pixel scale leaves ~0.3 px Sampson
    # noise; two reweighted refits over the consensus set recover the
    # precision a float64 solver would give.
    F = _eightpoint(p0, p1, inliers.to(p0.dtype), essential)
    for _ in range(2):
        inliers = _sampson_dist(F, p0, p1) < threshold
        F = _eightpoint(p0, p1, inliers.to(p0.dtype), essential)
    return F, inliers


def fit_fundamental_ransac(p0: torch.Tensor, p1: torch.Tensor,
                           idx: Optional[torch.Tensor] = None,
                           iters: int = 256, threshold: float = 0.999,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _fit_epipolar_ransac(p0, p1, idx, iters, threshold, False, generator)


def fit_essential_ransac(p0: torch.Tensor, p1: torch.Tensor,
                         idx: Optional[torch.Tensor] = None,
                         focal: float = 1.0, iters: int = 256,
                         threshold: float = 1.0,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Essential matrix from pixel coords with focal normalization
    (principal point (0, 0), as upstream)."""
    return _fit_epipolar_ransac(p0 / focal, p1 / focal, idx, iters,
                                threshold / focal, True, generator)


# -------------------------------------------------------------- decompose
def decompose_essential(E: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """E -> (R1, R2, t) with det(R) = +1 (cv2.decomposeEssentialMat parity)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = E.new_tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    return U @ W @ Vt, U @ W.T @ Vt, U[:, 2:3]


def rotation_matrix_to_euler(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> XYZ euler angles in degrees (upstream's
    convention)."""
    sy = torch.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2)
    singular = sy < 1e-6
    x = torch.where(singular, torch.atan2(-R[1, 2], R[1, 1]),
                    torch.atan2(R[2, 1], R[2, 2]))
    y = torch.atan2(-R[2, 0], sy)
    z = torch.where(singular, torch.zeros_like(sy), torch.atan2(R[1, 0], R[0, 0]))
    return torch.rad2deg(torch.stack([x, y, z]))
