"""Farneback dense optical flow (channel-first batched path).

Port of ``mav_detection_tpu/ops/flow/farneback.py``: per pyramid level, the
fused smooth+resize+polynomial-expansion (``poly_exp_pyr_pair_cf``: on the
card one launch of the band kernel of ``farneback_expand`` for both frames,
on the CPU the reference's two fp32 matmuls per frame set) and then the
solver iterations. ``FarnebackParams.warp`` picks
the solver: ``"fused"`` (the reference's ``"pallas"``) runs
``farneback_iterate`` (the CUDA kernel on the card, its plain PyTorch
version on the CPU); ``"gather"``, ``"separable"`` and ``"auto"`` run
``jacobi_level`` over ``update_matrices`` and ``solve_flow``, tensor code on
either device, with the ``fast`` refit schedule. Flow fields match
``cv2.calcOpticalFlowFarneback`` conventions (Farneback 2003, OpenCV's
numerics) exactly as the reference's do.

The numpy matrix builders are copies of the reference's, so both packages
build bit-identical matrices; the band kernel multiplies the same float32
weights. Matmuls run in full fp32 (the reference's ``precision="highest"``);
``resolve_device`` turns TF32 off on the card.

Every array of the solvers is channel-first, (b, c, H, W), where the
reference's are (h, w, b, c). One level loop serves every batch size and
every warp (the reference's batch-1 loop with its unfused preprocessing is
not ported). The TPU-only knobs (``band_rows``, ``pallas_halo``,
``interpret``, ``precision``) have no counterpart here.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from mav_detection_tpu_torch.ops.flow import farneback_expand as fe
from mav_detection_tpu_torch.ops.flow.farneback_iter import (
    CHUNK_ROWS,
    H100_SMS,
    STRIP_ROWS,
    StripGeometry,
    _sm_count,
    _warp_coords,
    farneback_iterate,
    fused_schedule,
    normal_equations,
    tiled_smem_bytes,
    warp_separable,
)
from mav_detection_tpu_torch.utils.device import resolve_device
from mav_detection_tpu_torch.utils.tracing import stage


@dataclass(frozen=True)
class FarnebackParams:
    """Algorithmic knobs of ``mav_detection_tpu``'s ``FarnebackParams``
    (same names, defaults and meaning)."""
    pyr_scale: float = 0.4
    levels: int = 1
    winsize: int = 12
    iterations: int = 10
    poly_n: int = 8
    poly_sigma: float = 1.2
    # fast=True refits the normal-equation matrices after iterations
    # {0, 1, 2, 4, 7} only, instead of after every one (jacobi_level; the
    # fused iteration always refits)
    fast: bool = False
    # the refit warp:
    #   "gather"    - true bilinear, 4 gathered taps (any displacement)
    #   "separable" - two-stage warp, shifts clipped to +-max_shift
    #   "auto"      - separable while max|flow| <= max_shift - 1, else gather,
    #                 decided per refit on the device
    #   "fused"     - the fused iteration kernel (the reference's "pallas"):
    #                 separable warp, refit every iteration
    warp: str = "gather"
    # the separable warp's integer displacement is clipped to +-max_shift
    max_shift: int = 16
    # per-level iteration schedule, finest level first (levels beyond the
    # tuple reuse its last entry); overrides ``iterations`` when set
    level_iters: Optional[Tuple[int, ...]] = None


def tuned_flow_params(h: int, w: int) -> FarnebackParams:
    """The reference's product configuration keyed by frame size
    (``mav_detection_tpu.ops.flow.tuned_flow_params``): up to 752x480 the
    refit window is +-8 px; larger frames (1920x1024) move ~12 px at the
    finest level and take +-16. Both use three layers (levels=2,
    pyr_scale=0.5) and the (2, 3, 8) finest-first iteration schedule."""
    sched = (2, 3, 8)
    if h * w <= 480 * 752:
        return FarnebackParams(levels=2, pyr_scale=0.5, warp="fused",
                               iterations=6, max_shift=8, level_iters=sched)
    return FarnebackParams(levels=2, pyr_scale=0.5, warp="fused",
                           iterations=6, max_shift=16, level_iters=sched)



def effective_fused_config(params: FarnebackParams, h: int, w: int,
                           batch: int) -> dict:
    """The launches ``farneback_iterate_fused`` actually makes for a run of
    ``batch`` (h, w) frame pairs under ``params``: the counterpart of the
    reference's ``effective_pallas_config``, so that a benchmarked
    configuration is always identifiable. Per pyramid layer (``"layers"``,
    finest first), from ``fused_schedule`` on the current card's SMs
    (``"sm_count"``; without a card, an H100 SXM's 132): the layer's shape and
    iterations, and its blocks: row-streaming ``"strips"`` (their count,
    width in columns, the rows of a run, runs per column with 0 for the
    columns laid end to end, rows per step) or ``"tiles"`` (the tile's rows
    and columns, rows per chunk of its y and x stages), with the block
    count and shared-memory bytes. The finest layer's fields also stand at
    the top level. A non-fused warp gives ``{"warp": ...}`` alone.

    The reference's TPU knobs (``halo``, ``halo_requested``,
    ``band_rows_effective``, ``tile_cols_effective``, ``n_bands``,
    ``n_col_tiles``) have no counterpart here."""
    if params.warp != "fused":
        return {"warp": params.warp}
    sm_count = (_sm_count(torch.cuda.current_device())
                if torch.cuda.is_available() else H100_SMS)
    m = params.winsize // 2
    layers = []
    for k_level, scale in enumerate(_pyramid_scales(h, w, params)):
        lh, lw = int(round(h * scale)), int(round(w * scale))
        g = fused_schedule(batch, lh, lw, params.winsize, params.max_shift, sm_count)
        layer = {"shape": [batch, lh, lw],
                 "iterations": _level_iter_count(params, k_level)}
        if isinstance(g, StripGeometry):
            layer.update(design="strips", strips=g.strips, strip_cols=g.strip,
                         run_rows=g.rows, runs_per_col=g.runs_per_col,
                         rows_per_step=STRIP_ROWS, blocks=g.blocks,
                         smem_bytes=g.smem_bytes)
        else:
            th, tw = g
            layer.update(design="tiles", tile=[th, tw], rows_per_step=CHUNK_ROWS,
                         blocks=batch * -(-lh // th) * -(-lw // tw),
                         smem_bytes=tiled_smem_bytes(g, m, params.max_shift))
        layers.append(layer)
    return {"warp": "fused", "sm_count": sm_count, **layers[0], "layers": layers}

# ----------------------------------------------------------------- helpers
def _poly_exp_moments(n: int, sigma: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float, float, float, float]:
    """Gaussian applicability weights and the inverse-moment constants.

    Solves the weighted least-squares normal equations for the 2-D basis
    {1, x, y, x^2, y^2, xy}; by symmetry only four inverse entries survive.
    """
    k = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(k ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    xg = k * g
    xxg = k ** 2 * g

    m2 = float((g * k ** 2).sum())
    m4 = float((g * k ** 4).sum())

    # G over (1, x^2, y^2) block and the diagonal x / y / xy entries.
    G3 = np.array(
        [
            [1.0, m2, m2],
            [m2, m4, m2 * m2],
            [m2, m2 * m2, m4],
        ]
    )
    invG3 = np.linalg.inv(G3)
    ig11 = 1.0 / m2
    ig03 = float(invG3[0, 1])
    ig33 = float(invG3[1, 1])
    ig55 = 1.0 / (m2 * m2)
    return g.astype(np.float32), xg.astype(np.float32), xxg.astype(np.float32), ig11, ig03, ig33, ig55


_BAND_CACHE: dict = {}


def _band_matrix_np(size: int, kernel: Tuple[float, ...], mode: str) -> np.ndarray:
    """Host-side (size, size) matrix B with B @ x == correlate1d(x, kernel)."""
    key = (size, kernel, mode)
    cached = _BAND_CACHE.get(key)
    if cached is not None:
        return cached
    n = len(kernel) // 2
    B = np.zeros((size, size), np.float32)
    for i in range(size):
        for t, kv in enumerate(kernel):
            j = i + t - n
            if mode == "edge":
                j = min(max(j, 0), size - 1)
            elif mode == "reflect":  # reflect-101: -1 -> 1, size -> size-2
                if j < 0:
                    j = -j
                if j > size - 1:
                    j = 2 * (size - 1) - j
            B[i, j] += kv
    _BAND_CACHE[key] = B
    return B


def _gaussian_kernel(ksize: int, sigma: float) -> Tuple[float, ...]:
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    k = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    g = np.exp(-(k ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return tuple(float(v) for v in g)


@functools.lru_cache(maxsize=None)
def _resize_matrix_np(src: int, dst: int) -> np.ndarray:
    """(dst, src) dense matrix M with M @ x == jax.image.resize(x, dst,
    "linear") along one axis: triangle kernel on half-pixel sample points
    with antialiasing on downscale, edge weights renormalized."""
    if src == dst:
        return np.eye(src, dtype=np.float64)
    inv_scale = src / dst
    kernel_scale = max(inv_scale, 1.0)  # antialias widens on downscale
    sample_f = (np.arange(dst, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[np.newaxis, :]
               - np.arange(src, dtype=np.float64)[:, np.newaxis]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - x)  # triangle
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0.0)
    valid = (sample_f >= -0.5) & (sample_f <= src - 0.5)
    return np.where(valid[np.newaxis, :], weights, 0.0).T


@functools.lru_cache(maxsize=None)
def _poly_pyr_mats_np(h: int, w: int, lh: int, lw: int,
                      smooth: Tuple[float, ...], n: int,
                      sigma: float) -> Tuple[np.ndarray, np.ndarray]:
    """Fused per-layer preproc matrices: Gaussian smooth -> linear resize ->
    polynomial-expansion moment correlations, composed in f64.

    Returns (V, Hm): V (3*lh, h) applies blur+resize+all three vertical
    moment kernels in one matmul; Hm (w, 3*lw) = [Wg | Wxg | Wxxg] applies
    blur+resize+one horizontal moment kernel per lw-column block."""
    g_np, xg_np, xxg_np, *_ = _poly_exp_moments(n, sigma)
    g = tuple(float(v) for v in g_np)
    xg = tuple(float(v) for v in xg_np)
    xxg = tuple(float(v) for v in xxg_np)

    pre_v = _resize_matrix_np(h, lh) @ _band_matrix_np(h, smooth, "reflect")
    V = np.concatenate(
        [_band_matrix_np(lh, g, "edge"), _band_matrix_np(lh, xg, "edge"),
         _band_matrix_np(lh, xxg, "edge")], axis=0) @ pre_v

    pre_h = _band_matrix_np(w, smooth, "reflect").T @ _resize_matrix_np(w, lw).T
    Hm = np.concatenate(
        [pre_h @ _band_matrix_np(lw, k, "edge").T for k in (g, xg, xxg)],
        axis=1)
    return V.astype(np.float32), Hm.astype(np.float32)


_BORDER_SCALES = (0.14, 0.14, 0.4472, 0.4472, 0.4472)


def _border_scale_map_np(h: int, w: int) -> np.ndarray:
    """Downweighting of constraints near image borders (5-px ramp)."""
    ramp = np.array(_BORDER_SCALES, np.float32)
    b = len(ramp)

    def axis_scale(nn: int) -> np.ndarray:
        a = np.ones(nn, np.float32)
        a[:b] *= ramp
        a[nn - b:] *= ramp[::-1][-min(b, nn):]
        return a

    return axis_scale(h)[:, None] * axis_scale(w)[None, :]


def _pyramid_scales(h: int, w: int, params: FarnebackParams) -> List[float]:
    # cv2 semantics: ``levels`` is the number of EXTRA coarse layers on top
    # of the original image (N+1 layers in all), capped so coarse layers keep
    # enough pixels for the poly window.
    scales = [1.0]
    for k_level in range(1, params.levels + 1):
        scale = params.pyr_scale ** k_level
        if min(h, w) * scale < 2 * params.poly_n + 1:
            break
        scales.append(scale)
    return scales


def _level_iter_count(params: FarnebackParams, k_level: int) -> int:
    """Iteration count for pyramid level ``k_level`` (0 = finest)."""
    if not params.level_iters:
        return params.iterations
    li = params.level_iters
    return li[min(k_level, len(li) - 1)]


@functools.lru_cache(maxsize=None)
def _expand_bands_np(h: int, w: int, lh: int, lw: int, smooth: Tuple[float, ...],
                     n: int, sigma: float) -> "fe.Bands":
    """The bands of ``_poly_pyr_mats_np``'s matrices, as the band kernel
    reads them."""
    return fe.bands_from_dense(*_poly_pyr_mats_np(h, w, lh, lw, smooth, n, sigma))


@functools.lru_cache(maxsize=256)
def _expand_plan(args: tuple, frames: int) -> Tuple["fe.Launch", ...]:
    """The band kernel's launches on the card for one layer (``args`` as
    ``_poly_pyr_mats_np`` takes them) over ``frames`` frames."""
    h, w, lh, lw = args[:4]
    return fe.plan(_expand_bands_np(*args), frames, h, w, lh, lw)


def _expand_taps(h: int, w: int, lh: int, lw: int, smooth: Tuple[float, ...],
                 n: int) -> Tuple[int, int, int, int]:
    """The taps of the factors ``_poly_pyr_mats_np`` composes, as
    ``farneback_expand.expand_ops`` counts them: the smooth's, the vertical
    and the horizontal resize's (their widest row; 0 where the size does
    not change) and the moments'."""
    def resize(src: int, dst: int) -> int:
        return 0 if src == dst else int((_resize_matrix_np(src, dst) != 0).sum(1).max())
    return len(smooth), resize(h, lh), resize(w, lw), 2 * n + 1


# --------------------------------------------------------- device helpers
@functools.lru_cache(maxsize=256)
def _device_const(kind: str, args: tuple, device: torch.device):
    """Per-device copies of the host matrices and bands (built once)."""
    if kind == "band":
        return torch.from_numpy(_band_matrix_np(*args)).to(device)
    if kind == "pyr":
        V, Hm = _poly_pyr_mats_np(*args)
        return (torch.from_numpy(V).to(device), torch.from_numpy(Hm).to(device))
    if kind == "expand":
        return fe.to_device(_expand_bands_np(*args), device)
    if kind == "resize":
        return torch.from_numpy(
            _resize_matrix_np(*args).astype(np.float32)).to(device)
    if kind == "border":
        return torch.from_numpy(_border_scale_map_np(*args)).to(device)
    raise ValueError(kind)


def border_scale_map(h: int, w: int, device: torch.device) -> torch.Tensor:
    return _device_const("border", (h, w), torch.device(device))


def _sep_correlate(img: torch.Tensor, kern_v: Tuple[float, ...],
                   kern_h: Tuple[float, ...], mode: str) -> torch.Tensor:
    """Separable 2-D correlation as two banded fp32 matmuls. ``img`` may be
    (h, w) or (h, w, c): ``kern_v`` runs down the rows, ``kern_h`` along
    them, borders by ``mode`` ("edge" or "reflect")."""
    h, w = img.shape[0], img.shape[1]
    Bv = _device_const("band", (h, tuple(kern_v), mode), img.device)
    Bh = _device_const("band", (w, tuple(kern_h), mode), img.device)
    if img.ndim == 2:
        return torch.matmul(torch.matmul(Bv, img), Bh.T)
    y = torch.einsum("ah,hwc->awc", Bv, img)
    return torch.einsum("bw,awc->abc", Bh, y)


def poly_exp_pyr_cf(img: torch.Tensor, smooth: Tuple[float, ...], lh: int,
                    lw: int, n: int, sigma: float) -> torch.Tensor:
    """Fused smooth+resize+poly_exp for one pyramid layer, channel-first:
    (b, h, w) full-resolution frames -> (b, 5, lh, lw) coefficients.

    Channel layout: 0: b_y, 1: b_x, 2: a_yy, 3: a_xx, 4: a_xy. The smooth,
    the resize and the moment correlations are linear per axis and compose
    into one (3*lh, h) left and one (w, 3*lw) right matrix. A CPU tensor
    takes the two matmuls (``poly_exp_pyr_ref``); a CUDA tensor launches the
    band kernel (``farneback_expand``), which multiplies only the bands of
    the same two matrices, or raises."""
    if img.device.type == "cuda":
        # the kernel expands both frames of each pair; every program path
        # has a pair and calls poly_exp_pyr_pair_cf
        return poly_exp_pyr_pair_cf(img, img, smooth, lh, lw, n, sigma)[0]
    if img.device.type != "cpu":
        raise ValueError(f"poly_exp_pyr_cf: unsupported device {img.device}")
    return poly_exp_pyr_ref(img, smooth, lh, lw, n, sigma)


def poly_exp_pyr_ref(img: torch.Tensor, smooth: Tuple[float, ...], lh: int,
                     lw: int, n: int, sigma: float) -> torch.Tensor:
    """The plain version of ``poly_exp_pyr_cf``: the reference's two fp32
    matmuls against the composed matrices, on the tensor's device (the card
    runs it only as a yardstick: ``chip_smoke.py``, the card tests)."""
    _, _, _, ig11, ig03, ig33, ig55 = _poly_exp_moments(n, sigma)
    _, h, w = img.shape
    V, Hm = _device_const("pyr", (h, w, lh, lw, smooth, n, sigma), img.device)

    t = torch.matmul(V, img)                 # (b, 3*lh, w)
    t0, t1, t2 = t[:, :lh], t[:, lh:2 * lh], t[:, 2 * lh:]
    y0 = torch.matmul(t0, Hm)                # (b, lh, 3*lw)
    y1 = torch.matmul(t1, Hm[:, :2 * lw])
    b5 = torch.matmul(t2, Hm[:, :lw])
    b1, b2, b4 = y0[..., :lw], y0[..., lw:2 * lw], y0[..., 2 * lw:]
    b3, b6 = y1[..., :lw], y1[..., lw:]

    return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                        b1 * ig03 + b4 * ig33, b6 * ig55], dim=1)


def poly_exp_pyr_pair_cf(prev: torch.Tensor, curr: torch.Tensor,
                         smooth: Tuple[float, ...], lh: int, lw: int, n: int,
                         sigma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``poly_exp_pyr_cf`` of both frames of each pair, (b, h, w) x2 ->
    (R0, R1): on the card one band-kernel launch per layer for both (two
    where the layer takes the two-pass route)."""
    if prev.device.type == "cuda":
        return _expand_cuda(prev, curr, smooth, lh, lw, n, sigma)
    return (poly_exp_pyr_cf(prev, smooth, lh, lw, n, sigma),
            poly_exp_pyr_cf(curr, smooth, lh, lw, n, sigma))


def _expand_cuda(prev: torch.Tensor, curr: torch.Tensor, smooth: Tuple[float, ...],
                 lh: int, lw: int, n: int, sigma: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    _, _, _, ig11, ig03, ig33, ig55 = _poly_exp_moments(n, sigma)
    prev, curr = prev.contiguous(), curr.contiguous()
    b, h, w = prev.shape
    args = (h, w, lh, lw, tuple(smooth), n, sigma)
    R0 = torch.empty((b, 5, lh, lw), dtype=torch.float32, device=prev.device)
    R1 = torch.empty_like(R0)
    fe.expand_cuda(prev, curr, R0, R1, _device_const("expand", args, prev.device),
                   _expand_plan(args, 2 * b), (ig11, ig03, ig33, ig55))
    return R0, R1


def _band(size: int, kernel: Tuple[float, ...], mode: str,
          device: torch.device) -> torch.Tensor:
    return _device_const("band", (size, kernel, mode), device)


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian of the trailing two dims, ``(..., h, w)``, with
    OpenCV's sigma-from-ksize rule and reflect-101 borders (the reference's
    unfused ``_gaussian_blur``)."""
    g = _gaussian_kernel(ksize, sigma)
    h, w = img.shape[-2:]
    return torch.matmul(torch.matmul(_band(h, g, "reflect", img.device), img),
                        _band(w, g, "reflect", img.device).T)


def poly_exp(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """Per-pixel quadratic fit of (b, h, w) frames -> (b, 5, h, w), with
    ``poly_exp_pyr_cf``'s channel layout (the reference's unfused
    ``_poly_exp``): the moment correlations alone, borders "edge", so that a
    row slab of a larger image expands as that image does away from the
    slab's edges."""
    g_np, xg_np, xxg_np, ig11, ig03, ig33, ig55 = _poly_exp_moments(n, sigma)
    g, xg, xxg = (tuple(float(v) for v in k) for k in (g_np, xg_np, xxg_np))
    h, w = img.shape[-2:]
    dev = img.device
    # vertical moments first, then the horizontal ones (the reference's order)
    t0, t1, t2 = (torch.matmul(_band(h, k, "edge", dev), img) for k in (g, xg, xxg))
    b1, b2, b4 = (torch.matmul(t0, _band(w, k, "edge", dev).T) for k in (g, xg, xxg))
    b3, b6 = (torch.matmul(t1, _band(w, k, "edge", dev).T) for k in (g, xg))
    b5 = torch.matmul(t2, _band(w, g, "edge", dev).T)
    return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                        b1 * ig03 + b4 * ig33, b6 * ig55], dim=1)


def resize_linear(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "linear")`` of the trailing two dims (the
    reference's ``_resize_linear`` on channel-first arrays); to its own size,
    the identity, without the two matmuls."""
    if tuple(img.shape[-2:]) == tuple(shape):
        return img
    return resize_linear_cf(img, shape)


def resize_linear_cf(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Linear resize of the trailing two (spatial) dims, ``(..., h, w)``:
    ``jax.image.resize(..., "linear")`` as two matmuls against
    ``_resize_matrix_np``."""
    h, w = img.shape[-2:]
    lh, lw = shape
    Rv = _device_const("resize", (h, lh), img.device)
    Rh = _device_const("resize", (w, lw), img.device)
    return torch.matmul(torch.matmul(Rv, img), Rh.T)


# ------------------------------------------------------- tensor-code solvers
WARPS = ("gather", "separable", "auto", "fused")


def _warp_gather(R1: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                 x1: torch.Tensor, y1: torch.Tensor) -> torch.Tensor:
    """True bilinear warp of R1 (b, 5, H, W), four gathered taps; the
    indices are clamped after the float clip, as the reference's are."""
    b, c, H, W = R1.shape
    x1i = torch.clamp(x1, 0, W - 1).to(torch.int64)
    y1i = torch.clamp(y1, 0, H - 1).to(torch.int64)
    x2i = torch.clamp(x1i + 1, max=W - 1)
    y2i = torch.clamp(y1i + 1, max=H - 1)
    flat = R1.reshape(b, c, H * W)

    def tap(yi, xi):
        idx = (yi * W + xi).reshape(b, 1, H * W).expand(b, c, H * W)
        return torch.gather(flat, 2, idx).reshape(b, c, H, W)

    a00 = ((1 - fx) * (1 - fy))[:, None]
    a01 = (fx * (1 - fy))[:, None]
    a10 = ((1 - fx) * fy)[:, None]
    a11 = (fx * fy)[:, None]
    return (a00 * tap(y1i, x1i) + a01 * tap(y1i, x2i)
            + a10 * tap(y2i, x1i) + a11 * tap(y2i, x2i))


def update_matrices(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                    border: torch.Tensor, warp: str = "gather",
                    max_shift: int = 16, row0=None,
                    global_h: int = 0) -> torch.Tensor:
    """Per-pixel normal-equation entries M = [G11, G12, G22, h1, h2],
    (b, 5, H, W), from R0/R1 (b, 5, H, W), flow (b, 2, H, W) and border
    (H, W): the reference's ``_update_matrices``.

    ``warp="auto"`` computes both warps and selects on the device by the
    0-dim predicate max|flow| <= max_shift - 1, so that the choice costs no
    look from the host. ``row0``/``global_h``: the arrays are a haloed row
    slab of a larger image, ``row0`` its first global row (an int or a 0-dim
    tensor) and ``global_h`` the image's height; the inside-image gate then
    tests global rows."""
    if warp not in ("gather", "separable", "auto"):
        raise ValueError(f"warp={warp!r} is not valid here, has to be "
                         "'gather', 'separable' or 'auto'")
    fx, fy, sx, sy, x1, y1 = _warp_coords(flow, max_shift, row0, global_h)
    if warp == "separable":
        r = warp_separable(R1, fx, fy, sx, sy)
    elif warp == "gather":
        r = _warp_gather(R1, fx, fy, x1, y1)
    else:
        covered = flow.abs().max() <= float(max_shift - 1)
        r = torch.where(covered, warp_separable(R1, fx, fy, sx, sy),
                        _warp_gather(R1, fx, fy, x1, y1))
    return normal_equations(R0, r, flow, border)


def _box_blur(img: torch.Tensor, winsize: int) -> torch.Tensor:
    """Replicate-edge window sum over the trailing two dims as two band
    matmuls, un-normalised. The window always has 2*(winsize//2)+1 taps: an
    even ``winsize`` sums one extra row and column while the caller still
    divides by winsize**2 (as the reference and its oracle do)."""
    h, w = img.shape[-2:]
    ones = (1.0,) * (2 * (winsize // 2) + 1)
    Bv = _device_const("band", (h, ones, "edge"), img.device)
    Bh = _device_const("band", (w, ones, "edge"), img.device)
    return torch.matmul(torch.matmul(Bv, img), Bh.T)


def solve_flow(M: torch.Tensor, winsize: int) -> torch.Tensor:
    """Window mean of M (b, 5, H, W) and the 2x2 solve: (b, 2, H, W) flow.
    The 1e-3 regulariser acts on the normalised sums, so it damps the
    solution by an amount that does not depend on the window."""
    g = _box_blur(M, winsize) * (1.0 / (winsize * winsize))
    g11, g12, g22, h1, h2 = g.unbind(1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet,
                        (g22 * h1 - g12 * h2) * idet], dim=1)


def _refit_schedule(params: FarnebackParams,
                    iterations: Optional[int] = None) -> set:
    """Iterations after which the normal-equation matrices are refit."""
    n = params.iterations if iterations is None else iterations
    if params.fast:
        return {0, 1, 2, 4, 7} & set(range(n - 1))
    return set(range(n - 1))


def jacobi_level(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                 border: torch.Tensor, params: FarnebackParams,
                 warp: Optional[str] = None,
                 iterations: Optional[int] = None) -> torch.Tensor:
    """One pyramid level's iterate/refit loop in tensor code: solve
    everywhere, then refit everywhere (Jacobi), refits by
    ``_refit_schedule``. With ``fast`` off this is the fused iteration's
    sequence (refit, solve, refit, solve, ...)."""
    warp = warp or params.warp
    n = params.iterations if iterations is None else iterations
    refit_after = _refit_schedule(params, n)
    M = update_matrices(R0, R1, flow, border, warp, params.max_shift)
    for it in range(n):
        flow = solve_flow(M, params.winsize)
        if it in refit_after:
            M = update_matrices(R0, R1, flow, border, warp, params.max_shift)
    return flow


# --------------------------------------------------------------- top level
def _farneback_cf(prev: torch.Tensor, curr: torch.Tensor,
                  params: FarnebackParams) -> torch.Tensor:
    """Channel-first batched solver: (b, h, w) x2 -> (b, h, w, 2)."""
    if params.warp not in WARPS:
        raise ValueError(
            f"warp={params.warp!r} is not valid, has to be one of "
            f"{', '.join(repr(v) for v in WARPS)}")
    with stage("flow"):
        prev = prev.to(torch.float32)
        curr = curr.to(torch.float32)
        b, h, w = prev.shape

        flow = None
        scales = _pyramid_scales(h, w, params)
        for k_level in reversed(range(len(scales))):
            scale = scales[k_level]
            sigma = (1.0 / scale - 1.0) * 0.5
            smooth_sz = max(int(round(sigma * 5)) | 1, 3)
            lh, lw = int(round(h * scale)), int(round(w * scale))

            if flow is None:
                flow = torch.zeros((b, 2, lh, lw), dtype=torch.float32,
                                   device=prev.device)
            else:
                flow = resize_linear_cf(flow, (lh, lw)) * (1.0 / params.pyr_scale)

            smooth = _gaussian_kernel(smooth_sz, sigma)
            with stage("flow.expand"):
                R0, R1 = poly_exp_pyr_pair_cf(prev, curr, smooth, lh, lw,
                                              params.poly_n, params.poly_sigma)
            border = border_scale_map(lh, lw, prev.device)

            iterations = _level_iter_count(params, k_level)
            with stage("flow.iterate"):
                if params.warp == "fused":
                    flow = farneback_iterate(R0, R1, flow.contiguous(), border,
                                             iterations=iterations,
                                             winsize=params.winsize,
                                             max_shift=params.max_shift)
                else:
                    flow = jacobi_level(R0, R1, flow, border, params,
                                        iterations=iterations)

        return flow.permute(0, 2, 3, 1)


ArrayLike = Union[torch.Tensor, np.ndarray]


def farneback_flow_batch(prev: ArrayLike, curr: ArrayLike,
                         params: Optional[FarnebackParams] = None,
                         device: Union[str, torch.device] = "cuda"
                         ) -> torch.Tensor:
    """Dense flow for frame pairs: (n, h, w) x2 (uint8 or float gray) ->
    (n, h, w, 2) float32 on ``device``. ``params`` defaults to
    ``tuned_flow_params`` for the frame size. Raises without a card unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    prev = torch.as_tensor(prev, device=dev)
    curr = torch.as_tensor(curr, device=dev)
    if prev.ndim != 3 or prev.shape != curr.shape:
        raise ValueError(f"expected two (n, h, w) batches, got "
                         f"{tuple(prev.shape)} and {tuple(curr.shape)}")
    if params is None:
        params = tuned_flow_params(prev.shape[1], prev.shape[2])
    return _farneback_cf(prev, curr, params)


def farneback_flow(prev: ArrayLike, curr: ArrayLike,
                   params: Optional[FarnebackParams] = None,
                   device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """Dense flow from ``prev`` to ``curr`` (gray (h, w)) -> (h, w, 2).
    Batch 1 of the channel-first path (the reference's batch-1 path differs
    from it only by fp rounding in its unfused preprocessing). ``params``
    defaults to ``tuned_flow_params`` for the frame size."""
    dev = resolve_device(device)
    prev = torch.as_tensor(prev, device=dev)[None]
    curr = torch.as_tensor(curr, device=dev)[None]
    return farneback_flow_batch(prev, curr, params, dev)[0]
