"""Plain float32 Farneback dense flow: the yardstick of the Flow layer.

A frozen copy of the algorithm as the configuration states it (Farneback
2003 with OpenCV's numerics, the product's pyramid of fused smooth + resize +
polynomial-expansion matrices, then the solver iterations: separable warp,
normal equations, (2m+1)^2 box mean with replicate edges, 2x2 solve). Plain
PyTorch on whatever device the frames lie on, in float32 with TF32 off; it
imports nothing of the program. ``precision="tf32"`` is the control: the
same computation with its matrix products in TF32 (on a card the tensor
cores' TF32; on the CPU the operands rounded to TF32's 10-bit mantissa, as
the tensor cores round them).

``flow(prev, curr, config, weights)``: (b, h, w) gray frames, uint8 or
float, or (b, h, w, 3) BGR uint8 ones, turned gray first (``gray``) ->
(b, h, w, 2) float32 flow, from the configuration's ``flow`` keys (levels,
pyr_scale, winsize, poly_n, poly_sigma, max_shift, level_iters). It has no
weights (``weights`` gives None); its control is ``CONTROL_PRECISION``,
TF32.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BORDER_RAMP = (0.14, 0.14, 0.4472, 0.4472, 0.4472)
CONTROL_PRECISION = "tf32"


def weights(config: Mapping, seed: int, device) -> None:
    """Farneback has no weights."""
    return None


def gray(frames: torch.Tensor) -> torch.Tensor:
    """BT.601 BGR -> gray as the cameras' frames are converted (float32,
    rounded half to even), of a (b, h, w, 3) batch; a (b, h, w) batch is
    gray already and comes back as it is."""
    if frames.dim() != 4:
        return frames
    x = frames.to(torch.float32)
    g = 0.114 * x[..., 0] + 0.587 * x[..., 1] + 0.299 * x[..., 2]
    return torch.round(g).to(torch.uint8)


# ------------------------------------------------------------ host matrices
def poly_moments(n: int, sigma: float):
    """Gaussian applicability weights g, x g, x^2 g (float32) and the four
    inverse-moment constants of the quadratic basis."""
    k = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(k ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    m2 = float((g * k ** 2).sum())
    m4 = float((g * k ** 4).sum())
    inv = np.linalg.inv(np.array([[1.0, m2, m2], [m2, m4, m2 * m2],
                                  [m2, m2 * m2, m4]]))
    return ((g.astype(np.float32), (k * g).astype(np.float32),
             (k ** 2 * g).astype(np.float32)),
            (1.0 / m2, float(inv[0, 1]), float(inv[1, 1]), 1.0 / (m2 * m2)))


def band_matrix(size: int, kernel: Tuple[float, ...], mode: str) -> np.ndarray:
    """(size, size) float32 B with B @ x == correlate1d(x, kernel), borders
    "edge" (replicate) or "reflect" (reflect-101)."""
    n = len(kernel) // 2
    B = np.zeros((size, size), np.float32)
    for i in range(size):
        for t, kv in enumerate(kernel):
            j = i + t - n
            if mode == "edge":
                j = min(max(j, 0), size - 1)
            else:
                if j < 0:
                    j = -j
                if j > size - 1:
                    j = 2 * (size - 1) - j
            B[i, j] += kv
    return B


def gaussian_kernel(ksize: int, sigma: float) -> Tuple[float, ...]:
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    k = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    g = np.exp(-(k ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return tuple(float(v) for v in g)


def resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) float64 M with M @ x == a linear resize along one axis:
    triangle kernel on half-pixel sample points, widened on downscale,
    edge weights renormalised."""
    if src == dst:
        return np.eye(src, dtype=np.float64)
    inv_scale = src / dst
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(dst, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[np.newaxis, :]
               - np.arange(src, dtype=np.float64)[:, np.newaxis]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0.0)
    valid = (sample_f >= -0.5) & (sample_f <= src - 0.5)
    return np.where(valid[np.newaxis, :], weights, 0.0).T


@functools.lru_cache(maxsize=None)
def layer_matrices(h: int, w: int, lh: int, lw: int, smooth: Tuple[float, ...],
                   n: int, sigma: float) -> Tuple[np.ndarray, np.ndarray]:
    """One pyramid layer's (3 lh, h) left and (w, 3 lw) right matrices:
    smooth, resize and the three moment correlations composed in float64."""
    (g, xg, xxg), _ = poly_moments(n, sigma)
    g, xg, xxg = (tuple(float(v) for v in k) for k in (g, xg, xxg))
    pre_v = resize_matrix(h, lh) @ band_matrix(h, smooth, "reflect")
    V = np.concatenate([band_matrix(lh, k, "edge") for k in (g, xg, xxg)],
                       axis=0) @ pre_v
    pre_h = band_matrix(w, smooth, "reflect").T @ resize_matrix(w, lw).T
    Hm = np.concatenate([pre_h @ band_matrix(lw, k, "edge").T
                         for k in (g, xg, xxg)], axis=1)
    return V.astype(np.float32), Hm.astype(np.float32)


def border_map(h: int, w: int) -> np.ndarray:
    ramp = np.array(BORDER_RAMP, np.float32)
    b = len(ramp)

    def axis(nn: int) -> np.ndarray:
        a = np.ones(nn, np.float32)
        a[:b] *= ramp
        a[nn - b:] *= ramp[::-1][-min(b, nn):]
        return a

    return axis(h)[:, None] * axis(w)[None, :]


# ------------------------------------------------------------ precision
def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, nearest, ties away)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def precision_mode(precision: str, device: torch.device):
    """TF32 off ("fp32") or on ("tf32") for the block, restored after."""
    if precision not in ("fp32", "tf32"):
        raise ValueError(f"precision {precision!r}: fp32 or tf32")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32" and device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32" and a.device.type != "cuda":
        return torch.matmul(_tf32_round(a), _tf32_round(b))
    return torch.matmul(a, b)


# ------------------------------------------------------------ the solver
def poly_expand(img: torch.Tensor, smooth, lh: int, lw: int, n: int,
                sigma: float, precision: str) -> torch.Tensor:
    """(b, h, w) frames -> (b, 5, lh, lw) coefficients [b_y, b_x, a_yy,
    a_xx, a_xy] of the layer."""
    _, (ig11, ig03, ig33, ig55) = poly_moments(n, sigma)
    _, h, w = img.shape
    V, Hm = layer_matrices(h, w, lh, lw, tuple(smooth), n, sigma)
    V = torch.from_numpy(V).to(img.device)
    Hm = torch.from_numpy(Hm).to(img.device)
    t = _mm(V, img, precision)
    t0, t1, t2 = t[:, :lh], t[:, lh:2 * lh], t[:, 2 * lh:]
    y0 = _mm(t0, Hm, precision)
    y1 = _mm(t1, Hm[:, :2 * lw], precision)
    b5 = _mm(t2, Hm[:, :lw], precision)
    b1, b2, b4 = y0[..., :lw], y0[..., lw:2 * lw], y0[..., 2 * lw:]
    b3, b6 = y1[..., :lw], y1[..., lw:]
    return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                        b1 * ig03 + b4 * ig33, b6 * ig55], dim=1)


def resize_flow(flow: torch.Tensor, shape, precision: str) -> torch.Tensor:
    h, w = flow.shape[-2:]
    lh, lw = shape
    Rv = torch.from_numpy(resize_matrix(h, lh).astype(np.float32)).to(flow.device)
    Rh = torch.from_numpy(resize_matrix(w, lw).astype(np.float32)).to(flow.device)
    return _mm(_mm(Rv, flow, precision), Rh.T, precision)


def warp_coords(flow: torch.Tensor, S: int):
    _, _, H, W = flow.shape
    dev = flow.device
    xs = torch.arange(W, device=dev, dtype=torch.float32)[None, None, :]
    ys = torch.arange(H, device=dev, dtype=torch.float32)[None, :, None]
    fx_t = xs + flow[:, 0]
    fy_t = ys + flow[:, 1]
    x1 = torch.floor(fx_t)
    y1 = torch.floor(fy_t)
    inside = (x1 >= 0) & (x1 < W - 1) & (y1 >= 0) & (y1 < H - 1)
    zero = torch.zeros((), device=dev, dtype=torch.float32)
    fx = torch.where(inside, fx_t - x1, zero)
    fy = torch.where(inside, fy_t - y1, zero)
    sx = torch.clamp(x1 - xs, -S, S).to(torch.int64)
    sy = torch.clamp(y1 - ys, -S, S).to(torch.int64)
    return fx, fy, sx, sy


def warp_separable(R1, fx, fy, sx, sy) -> torch.Tensor:
    """Rows mixed by (fy, sy) per column, then columns by (fx, sx) per
    pixel, indices clamped to the plane."""
    b, c, H, W = R1.shape
    dev = R1.device
    rows = torch.arange(H, device=dev)[None, :, None]
    cols = torch.arange(W, device=dev)[None, None, :]

    def rows_of(shift):
        idx = torch.clamp(rows + shift, 0, H - 1)
        return torch.gather(R1, 2, idx[:, None].expand(b, c, H, W))

    fy5 = fy[:, None]
    A = (1.0 - fy5) * rows_of(sy) + fy5 * rows_of(sy + 1)

    def cols_of(shift):
        idx = torch.clamp(cols + shift, 0, W - 1)
        return torch.gather(A, 3, idx[:, None].expand(b, c, H, W))

    fx5 = fx[:, None]
    return (1.0 - fx5) * cols_of(sx) + fx5 * cols_of(sx + 1)


def normal_equations(R0, r, flow, border) -> torch.Tensor:
    dx = flow[:, 0]
    dy = flow[:, 1]
    r4 = (R0[:, 2] + r[:, 2]) * 0.5
    r5 = (R0[:, 3] + r[:, 3]) * 0.5
    r6 = (R0[:, 4] + r[:, 4]) * 0.25
    r2 = (R0[:, 0] - r[:, 0]) * 0.5
    r3 = (R0[:, 1] - r[:, 1]) * 0.5
    r2 = (r2 + r4 * dy + r6 * dx) * border
    r3 = (r3 + r6 * dy + r5 * dx) * border
    r4 = r4 * border
    r5 = r5 * border
    r6 = r6 * border
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], dim=1)


def box_solve(M: torch.Tensor, winsize: int) -> torch.Tensor:
    _, _, H, W = M.shape
    m = winsize // 2
    taps = 2 * m + 1
    Mp = F.pad(M, (m, m, m, m), mode="replicate")
    v = torch.zeros(M.shape[:2] + (H, W + 2 * m), dtype=M.dtype, device=M.device)
    for d in range(taps):
        v = v + Mp[:, :, d:d + H, :]
    hsum = torch.zeros_like(M)
    for d in range(taps):
        hsum = hsum + v[:, :, :, d:d + W]
    g = hsum * (1.0 / (winsize * winsize))
    g11, g12, g22, h1, h2 = g.unbind(1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet,
                        (g22 * h1 - g12 * h2) * idet], dim=1)


def iterate(R0, R1, flow, border, iterations: int, winsize: int,
            max_shift: int) -> torch.Tensor:
    for _ in range(iterations):
        fx, fy, sx, sy = warp_coords(flow, max_shift)
        M = normal_equations(R0, warp_separable(R1, fx, fy, sx, sy), flow, border)
        flow = box_solve(M, winsize)
    return flow


def pyramid(h: int, w: int, params: Mapping) -> list:
    """Scales of the layers, finest first: ``levels`` extra layers while the
    coarse layer keeps 2 poly_n + 1 pixels."""
    scales = [1.0]
    for k in range(1, int(params["levels"]) + 1):
        s = float(params["pyr_scale"]) ** k
        if min(h, w) * s < 2 * int(params["poly_n"]) + 1:
            break
        scales.append(s)
    return scales


def level_iterations(params: Mapping, k: int) -> int:
    li = params.get("level_iters")
    if not li:
        return int(params["iterations"])
    return int(li[min(k, len(li) - 1)])


def flow(prev: torch.Tensor, curr: torch.Tensor, config: Mapping, weights=None,
         precision: str = "fp32") -> torch.Tensor:
    """(b, h, w) or (b, h, w, 3) x2 -> (b, h, w, 2) float32 flow from
    ``prev`` to ``curr``."""
    params = config["flow"]
    dev = prev.device
    with precision_mode(precision, dev), torch.no_grad():
        prev = gray(prev).to(torch.float32)
        curr = gray(curr).to(torch.float32)
        b, h, w = prev.shape
        n, sigma_p = int(params["poly_n"]), float(params["poly_sigma"])
        winsize, S = int(params["winsize"]), int(params["max_shift"])
        f = None
        scales = pyramid(h, w, params)
        for k in reversed(range(len(scales))):
            s = scales[k]
            sigma = (1.0 / s - 1.0) * 0.5
            smooth = gaussian_kernel(max(int(round(sigma * 5)) | 1, 3), sigma)
            lh, lw = int(round(h * s)), int(round(w * s))
            if f is None:
                f = torch.zeros((b, 2, lh, lw), dtype=torch.float32, device=dev)
            else:
                f = resize_flow(f, (lh, lw), precision) * (1.0 / float(params["pyr_scale"]))
            R0 = poly_expand(prev, smooth, lh, lw, n, sigma_p, precision)
            R1 = poly_expand(curr, smooth, lh, lw, n, sigma_p, precision)
            border = torch.from_numpy(border_map(lh, lw)).to(dev)
            f = iterate(R0, R1, f, border, level_iterations(params, k), winsize, S)
        return f.permute(0, 2, 3, 1).contiguous()
