"""Spatial (row-sharded) Farneback flow over a process group
(``mav_detection_tpu.parallel.spatial``).

One hi-res frame pair is split over the ranks by image rows, so the latency
of the iterate/refit loop falls with the rank count instead of only the
batch throughput rising. Every halo is exact:

* Each rank owns ``h / P`` rows of a pyramid level. It expands its band
  plus a margin ``e = fh_r + poly_n`` from the level image, which every rank
  smooths and resizes itself (the frame is replicated), and crops the
  ``poly_n`` rows the slab's edges pollute. Slab rows beyond the image are
  edge replicas, which is what the unsharded expansion's "edge" borders see.
* R1 rows beyond the image are replaced by the edge row: the unsharded warp
  clamps its reads there.
* Each refit needs the current flow ``fh_r = max_shift + winsize//2 + 2``
  rows beyond the band: one ``exchange_rows`` with both neighbours.
* The box blur and the 2x2 solve run on the normal-equation slab with the
  out-of-image rows set to the clamped edge row, so the slab's edge
  replication equals the unsharded solver's global edge; the inside-image
  gate of the warp tests global rows (``update_matrices(row0=...)``).

A level whose band would be smaller than ``fh_r`` runs replicated: the same
work on every rank, no communication. After each level the bands are
gathered, so every rank holds the whole flow.

The warp is the separable one (the halo is sized by ``max_shift``; the
gather warp would clamp its reads at band edges, not image edges): the
port's ``"fused"`` maps to ``"separable"`` here, as the reference's
``"pallas"`` does, so this path launches no fused kernel.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch
import torch.nn.functional as F

from mav_detection_tpu_torch.ops.flow.farneback import (
    FarnebackParams,
    _level_iter_count,
    _pyramid_scales,
    _refit_schedule,
    border_scale_map,
    gaussian_blur,
    jacobi_level,
    poly_exp,
    resize_linear,
    solve_flow,
    update_matrices,
)
from mav_detection_tpu_torch.parallel.halo import exchange_rows
from mav_detection_tpu_torch.parallel.mesh import Mesh, all_gather_cat, make_mesh

# the product hi-res configuration: separable warp, cv2-semantics 3 layers
SPATIAL_PARAMS = FarnebackParams(warp="separable", levels=2, pyr_scale=0.5,
                                 iterations=6, max_shift=8)


def _edge_rows(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows ``lo`` .. ``hi - 1`` of ``x`` (dim -2), clamped into the image
    (edge replication beyond it)."""
    idx = torch.arange(lo, hi, device=x.device).clamp_(0, x.shape[-2] - 1)
    return x.index_select(-2, idx)


def _clamp_outside(x: torch.Tensor, first_global: int, h: int, first_in: int,
                   last_in: int) -> torch.Tensor:
    """``x`` (dim -2 a slab whose row 0 is global row ``first_global``) with
    the rows above the image set to slab row ``first_in`` and those below it
    to slab row ``last_in``."""
    g = torch.arange(x.shape[-2], device=x.device) + first_global
    x = torch.where((g < 0)[:, None], x[..., first_in:first_in + 1, :], x)
    return torch.where((g > h - 1)[:, None], x[..., last_in:last_in + 1, :], x)


def _level_replicated(i0, i1, flow, border, params: FarnebackParams,
                      iterations: int) -> torch.Tensor:
    """One pyramid level of the plain Jacobi loop, the same on every rank."""
    R0 = poly_exp(i0, params.poly_n, params.poly_sigma)
    R1 = poly_exp(i1, params.poly_n, params.poly_sigma)
    return jacobi_level(R0, R1, flow, border, params, warp="separable",
                        iterations=iterations)


def _level_sharded(i0, i1, flow, border, params: FarnebackParams, mesh: Mesh,
                   iterations: int) -> torch.Tensor:
    """One pyramid level with the iterate/refit loop sharded over rows:
    (b, h, w) level images and (b, 2, h, w) flow, replicated, -> the
    level's flow, gathered onto every rank."""
    h = i0.shape[-2]
    hl = h // mesh.size
    S, n = params.max_shift, params.poly_n
    fh_m = params.winsize // 2            # box-blur halo
    fh_r = S + fh_m + 2                   # flow / M slab halo (warp reach)
    e = fh_r + n                          # image slab margin of the expansion
    r0 = mesh.rank * hl
    first, last = mesh.rank == 0, mesh.rank == mesh.size - 1

    R0 = poly_exp(_edge_rows(i0, r0 - e, r0 + hl + e), n,
                  params.poly_sigma)[..., n:n + hl + 2 * fh_r, :]
    R1 = poly_exp(_edge_rows(i1, r0 - e, r0 + hl + e), n,
                  params.poly_sigma)[..., n:n + hl + 2 * fh_r, :]
    R1 = _clamp_outside(R1, r0 - fh_r, h, fh_r, hl + fh_r - 1)
    bord = _edge_rows(border, r0 - fh_r, r0 + hl + fh_r)

    def refit(fl: torch.Tensor) -> torch.Tensor:
        fe = exchange_rows(fl, fh_r, fh_r, mesh)
        # beyond the global edges: zero flow (those rows' M is replaced)
        fe = F.pad(fe, (0, 0, fh_r if first else 0, fh_r if last else 0))
        M = update_matrices(R0, R1, fe, bord, "separable", S,
                            row0=r0 - fh_r, global_h=h)
        sl = M[..., fh_r - fh_m:fh_r + hl + fh_m, :]
        return _clamp_outside(sl, r0 - fh_m, h, fh_m, hl + fh_m - 1)

    refit_after = _refit_schedule(params, iterations)
    fl = flow[..., r0:r0 + hl, :]
    M = refit(fl)
    for it in range(iterations):
        fl = solve_flow(M, params.winsize)[..., fh_m:fh_m + hl, :]
        if it in refit_after:
            M = refit(fl)
    rows_first = all_gather_cat(fl.movedim(-2, 0).contiguous(), mesh)
    return rows_first.movedim(0, -2)


def _flow_spatial(prev: torch.Tensor, curr: torch.Tensor,
                  params: FarnebackParams, mesh: Mesh) -> torch.Tensor:
    """(b, h, w) x2 -> (b, 2, h, w) flow on every rank."""
    b, h, w = prev.shape
    fh_r = params.max_shift + params.winsize // 2 + 2
    scales = _pyramid_scales(h, w, params)
    flow: Optional[torch.Tensor] = None
    for k_level in reversed(range(len(scales))):
        scale = scales[k_level]
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth_sz = max(int(round(sigma * 5)) | 1, 3)
        lh, lw = int(round(h * scale)), int(round(w * scale))
        i0 = resize_linear(gaussian_blur(prev, smooth_sz, sigma), (lh, lw))
        i1 = resize_linear(gaussian_blur(curr, smooth_sz, sigma), (lh, lw))
        if flow is None:
            flow = torch.zeros((b, 2, lh, lw), dtype=torch.float32,
                               device=prev.device)
        else:
            flow = resize_linear(flow, (lh, lw)) * (1.0 / params.pyr_scale)
        border = border_scale_map(lh, lw, prev.device)
        n_it = _level_iter_count(params, k_level)
        if lh % mesh.size == 0 and lh // mesh.size >= fh_r:
            flow = _level_sharded(i0, i1, flow, border, params, mesh, n_it)
        else:
            # band smaller than the halo: replicate this (cheap) level
            flow = _level_replicated(i0, i1, flow, border, params, n_it)
    return flow


def farneback_flow_spatial(prev, curr, params: FarnebackParams = SPATIAL_PARAMS,
                           mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Dense flow for ONE frame pair, row-sharded over ``mesh`` (the
    initialised default group's when None): gray (h, w) x2 -> (h, w, 2),
    on every rank, on the mesh's device. Exact up to float reassociation
    against the unsharded separable solver. The separable warp is forced
    (``"fused"`` and ``"gather"`` map to it); pick ``max_shift`` at least
    the largest displacement expected."""
    if mesh is None:
        mesh = make_mesh()
    if params.warp not in ("separable", "auto"):
        params = replace(params, warp="separable")
    if prev.shape[0] % mesh.size:
        raise ValueError(
            f"image height {prev.shape[0]} must divide by the mesh axis "
            f"size {mesh.size} (pad the frame or resize)")
    prev = torch.as_tensor(prev).to(mesh.device, torch.float32)[None]
    curr = torch.as_tensor(curr).to(mesh.device, torch.float32)[None]
    return _flow_spatial(prev, curr, params, mesh)[0].permute(1, 2, 0)


def flow_spatial_rank(mesh: Mesh, prev, curr,
                      params: FarnebackParams = SPATIAL_PARAMS) -> torch.Tensor:
    """``farneback_flow_spatial`` as a launch's rank function."""
    return farneback_flow_spatial(prev, curr, params, mesh)



def raft_flow_spatial(image1, image2, model=None, mesh: Optional[Mesh] = None,
                      iters: int = 0, config=None) -> torch.Tensor:
    """RAFT inference for ONE frame pair, row-sharded over ``mesh`` (the
    initialised default group's when None): (h, w[, 3]) frames -> (h, w, 2)
    flow on every rank. Each rank runs the net on its band of rows inside
    ``layers.row_sharded``: the convolutions pull their halos from the
    neighbours (XLA's SAME padding at the global edges, the stride-2
    alignment kept), GroupNorm's per-row statistics stay local, the
    coordinate grid and the local volumes take global rows, every rank
    gathers the 1/8-resolution target features, and the convex upsample
    reads one neighbour row each way. Exact up to float reassociation
    against the unsharded net. ``model`` defaults to the shipped
    checkpoint."""
    from mav_detection_tpu_torch.models import pretrained
    from mav_detection_tpu_torch.models.layers import row_sharded
    from mav_detection_tpu_torch.models.raft import (
        INFERENCE_CONFIG,
        PRODUCT_ITERS,
        _images_nchw,
    )
    from mav_detection_tpu_torch.parallel.halo import band, gather_rows

    config = config or INFERENCE_CONFIG
    if mesh is None:
        mesh = make_mesh()
    if model is None:
        model = pretrained.load_raft(mesh.device)
        if model is None:
            raise ValueError("no RAFT checkpoint found — pass params")
    h, w = int(image1.shape[0]), int(image1.shape[1])
    if h % mesh.size:
        raise ValueError(
            f"image height {h} must divide by the mesh axis "
            f"size {mesh.size} (pad the frame or resize)")
    if h % (8 * mesh.size) or h // mesh.size < 24:
        raise ValueError(
            f"image height {h}: each of the {mesh.size} row bands must be a "
            "multiple of 8 rows and at least 24 (three rows at 1/8 resolution "
            "for the 7x7 motion-encoder window)")
    x1 = _images_nchw(torch.as_tensor(image1)[None], mesh.device)
    x2 = _images_nchw(torch.as_tensor(image2)[None], mesh.device)
    with torch.no_grad(), row_sharded(mesh):
        flow = model(band(x1, mesh), band(x2, mesh), iters or PRODUCT_ITERS, config)
        flow = gather_rows(flow, mesh)
    return flow[0, :, :h, :w].permute(1, 2, 0).contiguous()


def raft_spatial_rank(mesh: Mesh, image1, image2, model, iters: int = 0,
                      config=None) -> torch.Tensor:
    """``raft_flow_spatial`` as a launch's rank function (``model`` on the
    CPU goes to the rank's device)."""
    return raft_flow_spatial(image1, image2, model.to(mesh.device), mesh, iters, config)
