"""Visualization helpers (``mav_detection_tpu.ops.image.visualize``).

The host functions are numpy copies of the reference's, bit-equal to them:
flow coloring follows the standard Middlebury/Baker color wheel (the scheme
the ``flow_vis`` package implements), the jet colormap is OpenCV's
COLORMAP_JET ramp. ``flow_to_color_device`` and ``flow_radial_device`` are the
same colorwheel math on torch tensors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _make_colorwheel() -> np.ndarray:
    """Middlebury optical-flow color wheel, shape (55, 3) RGB."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    colorwheel = np.zeros((ncols, 3))
    col = 0
    colorwheel[0:RY, 0] = 255
    colorwheel[0:RY, 1] = np.floor(255 * np.arange(0, RY) / RY)
    col += RY
    colorwheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(0, YG) / YG)
    colorwheel[col:col + YG, 1] = 255
    col += YG
    colorwheel[col:col + GC, 1] = 255
    colorwheel[col:col + GC, 2] = np.floor(255 * np.arange(0, GC) / GC)
    col += GC
    colorwheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    colorwheel[col:col + CB, 2] = 255
    col += CB
    colorwheel[col:col + BM, 2] = 255
    colorwheel[col:col + BM, 0] = np.floor(255 * np.arange(0, BM) / BM)
    col += BM
    colorwheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    colorwheel[col:col + MR, 0] = 255
    return colorwheel


_COLORWHEEL = _make_colorwheel()


def flow_to_color(flow_uv: np.ndarray, convert_to_bgr: bool = True,
                  rad_max: Optional[float] = None) -> np.ndarray:
    """Visualize an (h, w, 2) flow field as an (h, w, 3) uint8 image.

    Default BGR output matches the reference's
    ``flow_vis.flow_to_color(frame, convert_to_bgr=True)``.
    """
    flow_uv = np.asarray(flow_uv, dtype=np.float64)
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2, f"bad flow shape {flow_uv.shape}"
    if not np.isfinite(flow_uv).all():
        # a NaN/inf pixel must not crash the debug-image writer (NaN floors
        # to INT_MIN and indexes out of the colorwheel): render it as zero
        # motion instead
        flow_uv = np.nan_to_num(flow_uv, nan=0.0, posinf=0.0, neginf=0.0)
    u, v = flow_uv[..., 0], flow_uv[..., 1]
    rad = np.sqrt(u ** 2 + v ** 2)
    if rad_max is None:
        rad_max = float(np.max(rad)) if rad.size else 0.0
    epsilon = 1e-5
    u = u / (rad_max + epsilon)
    v = v / (rad_max + epsilon)
    rad = np.sqrt(u ** 2 + v ** 2)

    ncols = _COLORWHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(flow_uv.shape[:2] + (3,), np.uint8)
    for i in range(3):
        col0 = _COLORWHEEL[k0, i] / 255.0
        col1 = _COLORWHEEL[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        ch = 2 - i if convert_to_bgr else i
        img[..., ch] = np.floor(255 * col)
    return img


# OpenCV COLORMAP_JET anchor behavior: piecewise-linear RGB ramp.
def _jet_lut() -> np.ndarray:
    x = np.linspace(0.0, 1.0, 256)

    def interp(v: np.ndarray) -> np.ndarray:
        return np.clip(1.5 - np.abs(4.0 * v - 3.0), 0, 1)

    r = interp(x)            # peaks at 0.75
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0, 1)
    lut = np.stack([b, g, r], axis=-1)  # BGR like OpenCV
    return (lut * 255).astype(np.uint8)


_JET = _jet_lut()


def to_int(img: np.ndarray, dtype: type = np.uint8, normalize: bool = False,
           max_value: Optional[float] = None) -> np.ndarray:
    """Float image -> integer image; semantics of reference ``to_int``."""
    img_normalized = np.asarray(img)
    if normalize:
        if max_value is None:
            max_value = float(np.max(img_normalized)) if img_normalized.size else 1.0
        elif max_value <= 0.0:
            max_value = 1.0
        if max_value == 0.0:
            max_value = 1.0
        img_normalized = np.abs(img_normalized) * 255 / max_value
    return np.around(img_normalized).astype(dtype)


def to_rgb(img: np.ndarray, max_value: Optional[float] = None) -> np.ndarray:
    """Grayscale (float ok) -> 3-channel uint8."""
    gray = to_int(img, np.uint8, True, max_value=max_value)
    return np.repeat(gray[..., None], 3, axis=-1)


def apply_colormap(img: np.ndarray, max_value: Optional[float] = None) -> np.ndarray:
    """Jet colormap with the reference's max-value pinning trick."""
    img = np.asarray(img)
    if img.dtype in (np.float32, np.float64):
        img = to_int(img, np.uint8, normalize=True, max_value=max_value)
    if img.ndim == 3:
        gray = img[..., 0]
    else:
        gray = img
    return _JET[gray]


def get_flow_radial(flow_vis_bgr: np.ndarray) -> np.ndarray:
    """Hue-only (radial direction) view of a flow visualization: saturation
    and value forced to max (reference ``im_helpers.get_flow_radial``,
    ``im_helpers.py:87-100``)."""
    bgr = flow_vis_bgr.astype(np.float32) / 255.0
    r, g, b = bgr[..., 2], bgr[..., 1], bgr[..., 0]
    maxc = np.max(bgr[..., :3], axis=-1)
    minc = np.min(bgr[..., :3], axis=-1)
    delta = np.where(maxc - minc > 1e-6, maxc - minc, 1.0)
    h = np.zeros_like(maxc)
    h = np.where(maxc == r, ((g - b) / delta) % 6, h)
    h = np.where(maxc == g, (b - r) / delta + 2, h)
    h = np.where(maxc == b, (r - g) / delta + 4, h)
    h = h / 6.0
    # hsv -> bgr with s = v = 1
    i = (h * 6).astype(int) % 6
    f = h * 6 - np.floor(h * 6)
    p = np.zeros_like(h)
    q = 1 - f
    t = f
    lut = [(1, t, p), (q, 1, p), (p, 1, t), (p, q, 1), (t, p, 1), (1, p, q)]
    out = np.zeros(flow_vis_bgr.shape[:2] + (3,), np.float32)
    for k, (rr, gg, bb) in enumerate(lut):
        m = i == k
        out[m, 2] = np.broadcast_to(rr, h.shape)[m]
        out[m, 1] = np.broadcast_to(gg, h.shape)[m]
        out[m, 0] = np.broadcast_to(bb, h.shape)[m]
    return (out * 255).astype(np.uint8)


def get_fft_magnitude(frame: np.ndarray) -> np.ndarray:
    """Log-magnitude FFT spectrum of the first channel (reference
    ``im_helpers.get_fft``, ``im_helpers.py:203-209``)."""
    chan = frame[..., 0] if frame.ndim == 3 else frame
    f = np.fft.fftshift(np.fft.fft2(chan))
    mag = 20 * np.log(np.abs(f) + 1e-12)
    out = np.zeros(chan.shape + (3,), np.float32)
    out[..., 0] = mag
    return out


def colorbar_image(height: int = 200, width: int = 30) -> np.ndarray:
    img = np.zeros((height, width), dtype=np.uint8)
    img[:] = np.arange(height, dtype=np.uint8)[:, None]
    return _JET[img]


def colorwheel_image(diameter: int = 250) -> np.ndarray:
    """Flow color wheel legend (reference ``get_colorwheel``,
    ``im_helpers.py:225-242``) — vectorized."""
    radius = diameter / 2
    ys, xs = np.mgrid[0:diameter, 0:diameter]
    u = xs - radius
    v = ys - radius
    outside = np.sqrt(u ** 2 + v ** 2) > radius
    flow = np.stack([u, v], axis=-1).astype(np.float64)
    flow[outside] = 0
    return flow_to_color(flow)


# ----------------------------------------------------------- device (torch)
_WHEEL_ON: dict = {}


def _wheel_on(dev: torch.device) -> torch.Tensor:
    """The colorwheel / 255 on ``dev``, copied once per device (a copy from
    the host in every call would make each training step wait for it)."""
    key = str(dev)
    if key not in _WHEEL_ON:
        _WHEEL_ON[key] = torch.as_tensor(_COLORWHEEL, dtype=torch.float32,
                                         device=dev) / 255.0
    return _WHEEL_ON[key]


def _wheel_color(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Interpolated colorwheel color (..., 3) RGB in [0, 1] of the direction
    of (u, v)."""
    wheel = _wheel_on(u.device)                               # (ncols, 3) RGB
    ncols = wheel.shape[0]
    a = torch.atan2(-v, -u) / np.pi
    fk = (a + 1.0) / 2.0 * (ncols - 1)
    k0 = torch.floor(fk).long()
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]
    return (1.0 - f) * wheel[k0] + f * wheel[k1]


def flow_to_color_device(flow_uv: torch.Tensor, rad_max=None) -> torch.Tensor:
    """``flow_to_color`` on the tensor's device: (h, w, 2) flow -> (h, w, 3)
    float32 BGR in [0, 255]. Same Middlebury colorwheel math as the host
    version in float32 (within one grey level of it: values that land on a
    level boundary may floor either way)."""
    u = torch.nan_to_num(flow_uv[..., 0].to(torch.float32), 0.0, 0.0, 0.0)
    v = torch.nan_to_num(flow_uv[..., 1].to(torch.float32), 0.0, 0.0, 0.0)
    rad = torch.sqrt(u * u + v * v)
    rmax = (rad.max() if rad_max is None
            else torch.as_tensor(rad_max, dtype=torch.float32, device=u.device))
    eps = 1e-5
    u = u / (rmax + eps)
    v = v / (rmax + eps)
    rad = torch.sqrt(u * u + v * v)
    col = _wheel_color(u, v)
    inside = (rad <= 1.0)[..., None]
    col = torch.where(inside, 1.0 - rad[..., None] * (1.0 - col), col * 0.75)
    return torch.floor(255.0 * col).flip(-1)                   # BGR


def flow_radial_device(flow_uv: torch.Tensor) -> torch.Tensor:
    """Hue-only flow-direction view, the device analogue of
    ``get_flow_radial(flow_to_color(flow))`` (S=V=1), computed directly from
    the colorwheel color (whose adjacent entries always share a 255 and a 0
    channel, so the interpolated color IS the pure-hue color)."""
    col = _wheel_color(flow_uv[..., 0].to(torch.float32),
                       flow_uv[..., 1].to(torch.float32))
    col = col / torch.clamp(col.max(dim=-1, keepdim=True).values, min=1e-6)
    return torch.floor(255.0 * col).flip(-1)                   # BGR
