"""Synthetic training scenes on the device (``mav_detection_tpu.data.synthgen``).

The scene family of the host fixture (``data/synthetic.py``): a
blurred-noise ground texture under a brighter, smoother sky band above a
sampled horizon, radial expansion about a sampled FoE plus the IMU rotation
field (``ops/geometry/derotation``) and an optional uniform camera pan, and
a textured intruder disc on its own linear path. Frame 2 is frame 1
backward-warped through the fixed-point inverse of ``x + flow(x)``; the
drone's pixels carry its own velocity; the sky ground truth is the static
band. One call renders a whole batch as batched tensor code on the caller's
device (no loop over scenes, nothing read back to the host).

Random draws cannot match across frameworks, so the draws are an explicit
argument: ``SceneDraws`` holds every value the reference draws from
``split(key, 20)`` (the texture noise planes and mix scalars, horizon, FoE,
expansion, omega, pan, radius, position, velocity, sprite style,
augmentation and the two noise planes), each already mapped to its range as
the reference's ``uniform(minval, maxval)`` maps it. ``draw_scenes`` fills
one from a ``torch.Generator`` when the caller gives none.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from mav_detection_tpu_torch.ops.flow.farneback import _device_const, _gaussian_kernel
from mav_detection_tpu_torch.ops.geometry.derotation import derotation_field
from mav_detection_tpu_torch.utils.device import resolve_device

Device = Union[str, torch.device]
DT = 0.05                     # frame interval of every scene (s)
MARGIN = 0.12                 # the drone starts this far inside the crop
TWO_PI = 6.2832               # the reference's constant


class SynthScene(NamedTuple):
    """A batch of generated frame pairs (leading batch axis)."""
    img1: torch.Tensor    # (b, h, w) float32 grayscale in [0, 255]
    img2: torch.Tensor    # (b, h, w)
    flow: torch.Tensor    # (b, h, w, 2) GT flow img1 -> img2
    sky: torch.Tensor     # (b, h, w) bool sky-band ground truth
    seg: torch.Tensor     # (b, h, w) bool drone mask in img1
    box: torch.Tensor     # (b, 4) cx, cy, bw, bh of the drone in img1 (px)
    foe: torch.Tensor     # (b, 2) focus of expansion (x, y)
    omega: torch.Tensor   # (b, 3) angular difference over the interval (rad)
    dt: torch.Tensor      # (b,) frame interval (s)


class SceneDraws(NamedTuple):
    """Every random value of a batch of scenes, at the render size (the
    output size plus ``2 * render_pad(pan_max)`` per axis). Names follow the
    reference's ``generate_scene``; ``*_sp`` are the sinusoid family's six
    uniforms, ``*_u`` the brightness-range pair, ``*_a`` the blur mix."""
    ground_noise: torch.Tensor   # (b, H, W) uniform [0, 1)       ks[0]
    ground_a: torch.Tensor       # (b,)                           ks[13] -> kn
    ground_sp: torch.Tensor      # (b, 6)                         ks[13] -> ksin
    ground_u: torch.Tensor       # (b, 2)                         ks[13] -> km
    sky_noise: torch.Tensor      # (b, H, W)                      ks[1]
    sky_a: torch.Tensor          # (b,)                           ks[14]
    sky_sp: torch.Tensor         # (b, 6)
    sky_u: torch.Tensor          # (b, 2)
    horizon: torch.Tensor        # (b,) in [0.2, 0.45)            ks[2]
    foe: torch.Tensor            # (b, 2) in [0.2, 0.8)           ks[3], ks[4]
    expansion: torch.Tensor      # (b,) in [0.002, 0.022)         ks[5]
    omega: torch.Tensor          # (b, 3) in [-0.005, 0.005)      ks[6]
    pan: torch.Tensor            # (b, 2) in [-pan_max, pan_max)  ks[16]
    radius: torch.Tensor         # (b,) in [3, 14)                ks[7]
    pos: torch.Tensor            # (b, 2) in [MARGIN, 1 - MARGIN) ks[8], ks[9]
    vel: torch.Tensor            # (b, 2) in [-5, 5)              ks[10]
    style: torch.Tensor          # (b, 5) uniform [0, 1)          ks[15]
    aug: torch.Tensor            # (b, 4) uniform [0, 1)          ks[11]
    normals: torch.Tensor        # (b, 2, H, W) standard normal   ks[12]


def render_pad(pan_max: float) -> int:
    """Border rendered around the crop with a pan: the pan plus the
    expansion / rotation field's reach at training scale."""
    return int(-(-pan_max // 1)) + 8 if pan_max > 0.0 else 0


def draw_scenes(batch: int, h: int, w: int, pan_max: float = 0.0,
                generator: Optional[torch.Generator] = None,
                device: Device = "cpu") -> SceneDraws:
    """``SceneDraws`` for ``batch`` scenes from ``generator`` (on
    ``device``), with the reference's ranges."""
    pad = render_pad(pan_max)
    H, W = h + 2 * pad, w + 2 * pad
    dev = torch.device(device)

    def u(*shape, lo=0.0, hi=1.0):
        r = torch.rand((batch,) + shape, generator=generator, device=dev)
        return r * (hi - lo) + lo

    return SceneDraws(
        ground_noise=u(H, W), ground_a=u(), ground_sp=u(6), ground_u=u(2),
        sky_noise=u(H, W), sky_a=u(), sky_sp=u(6), sky_u=u(2),
        horizon=u(lo=0.2, hi=0.45), foe=u(2, lo=0.2, hi=0.8),
        expansion=u(lo=0.002, hi=0.022), omega=u(3, lo=-0.005, hi=0.005),
        pan=u(2, lo=-pan_max, hi=pan_max), radius=u(lo=3.0, hi=14.0),
        pos=u(2, lo=MARGIN, hi=1 - MARGIN), vel=u(2, lo=-5.0, hi=5.0),
        style=u(5), aug=u(4),
        normals=torch.randn((batch, 2, H, W), generator=generator, device=dev))


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur of (b, H, W), reflect-101 borders, as two banded fp32
    matmuls (the reference's ``_sep_correlate``)."""
    k = _gaussian_kernel(int(sigma * 4) | 1, sigma)
    h, w = img.shape[-2:]
    Bv = _device_const("band", (h, k, "reflect"), img.device)
    Bh = _device_const("band", (w, k, "reflect"), img.device)
    return torch.matmul(torch.matmul(Bv, img), Bh.T)


def _normalize(img: torch.Tensor, lo, hi) -> torch.Tensor:
    """Per-scene min-max map of (b, H, W) onto [lo, hi] ((b,) or scalars)."""
    mn = img.amin(dim=(1, 2), keepdim=True)
    rng = torch.clamp(img.amax(dim=(1, 2), keepdim=True) - mn, min=1e-6)
    if isinstance(lo, torch.Tensor):
        lo, hi = lo[:, None, None], hi[:, None, None]
    return (img - mn) / rng * (hi - lo) + lo


def _sample(fmap: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """Replicate-border bilinear sampling of (b, H, W[, c]) at (b, H, W)
    coordinates (``sample_bilinear_replicate`` per scene)."""
    b, h, w = fmap.shape[:3]
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    fx = cx - x0
    fy = cy - y0
    x0i = x0.clamp(0, w - 1).long()
    y0i = y0.clamp(0, h - 1).long()
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    flat = fmap.reshape(b, h * w, -1)
    c = flat.shape[-1]

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(fmap.shape)

    if fmap.ndim == 4:
        fx, fy = fx[..., None], fy[..., None]
    return ((1 - fx) * (1 - fy) * tap(y0i, x0i) + fx * (1 - fy) * tap(y0i, x1i)
            + (1 - fx) * fy * tap(y1i, x0i) + fx * fy * tap(y1i, x1i))


def _mixed_texture(xs, ys, noise, a, sp, u, sig_a, sig_b, lo_rng, hi_rng,
                   sin_blend):
    """The reference's ``mixed_texture``: a mix of two blurs of ``noise``,
    blended with a sinusoidal grid, mapped onto a drawn brightness range."""
    a = a[:, None, None]
    tex = a * _blur(noise, sig_a) + (1 - a) * _blur(noise, sig_b)
    kxy = 0.02 + 0.25 * sp[:, :2]
    k0, k1 = kxy[:, 0, None, None], kxy[:, 1, None, None]
    sin_tex = (torch.sin(k0 * xs + sp[:, 2, None, None] * TWO_PI)
               * torch.cos(k1 * ys + sp[:, 3, None, None] * TWO_PI)
               + 0.5 * torch.sin(2.7 * k1 * xs + 1.9 * k0 * ys))
    bl = (sin_blend * sp[:, 4])[:, None, None]
    tex = (1 - bl) * _normalize(tex, 0.0, 1.0) + bl * _normalize(sin_tex, 0.0, 1.0)
    lo = lo_rng[0] + u[:, 0] * (lo_rng[1] - lo_rng[0])
    hi = hi_rng[0] + u[:, 1] * (hi_rng[1] - hi_rng[0])
    return _normalize(tex, lo, hi)


def _sprite(xs, ys, pos, radius, style):
    """Textured disc: (b, H, W) mask and grayscale pattern."""
    dx = xs - pos[:, 0, None, None]
    dy = ys - pos[:, 1, None, None]
    r = radius[:, None, None]
    mask = dx ** 2 + dy ** 2 <= r ** 2
    s = [v[:, None, None] for v in style]
    return mask, s[0] + s[1] * (torch.sin(s[2] * dx + s[3]) * torch.cos(s[2] * dy + s[4]))


def generate_batch(batch: int, h: int, w: int, pan_max: float = 0.0,
                   sin_blend: float = 0.6, draws: Optional[SceneDraws] = None,
                   generator: Optional[torch.Generator] = None,
                   device: Device = "cuda") -> SynthScene:
    """(batch,) scenes of (h, w) on ``device``, rendered from ``draws``
    (drawn from ``generator`` when not given). ``pan_max`` > 0 adds a
    uniform camera pan of up to that many px per axis, rendered inflated by
    ``render_pad(pan_max)`` and cropped back; ``sin_blend`` caps the
    sinusoidal texture family's weight."""
    dev = resolve_device(device)
    if draws is None:
        draws = draw_scenes(batch, h, w, pan_max, generator, dev)
    d = SceneDraws(*(t.to(dev, torch.float32) for t in draws))
    pad = render_pad(pan_max)
    hc, wc = h, w
    H, W = h + 2 * pad, w + 2 * pad
    if tuple(d.ground_noise.shape) != (batch, H, W):
        raise ValueError(f"draws of shape {tuple(d.ground_noise.shape)}, expected "
                         f"{(batch, H, W)} (pan_max={pan_max} renders "
                         f"{2 * pad} px larger)")
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :].expand(1, H, W)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None].expand(1, H, W)

    ground = _mixed_texture(xs, ys, d.ground_noise, d.ground_a, d.ground_sp,
                            d.ground_u, 1.0, 2.5, (10.0, 40.0), (170.0, 245.0),
                            sin_blend)
    sky_tex = _mixed_texture(xs, ys, d.sky_noise, d.sky_a, d.sky_sp, d.sky_u,
                             3.0, 6.0, (130.0, 170.0), (225.0, 250.0), sin_blend)
    horizon = d.horizon * H
    sky_rows = ys < horizon[:, None, None]
    bg1 = torch.where(sky_rows, sky_tex, ground)

    foe = torch.stack([d.foe[:, 0] * W, d.foe[:, 1] * H], 1)
    dt = torch.full((batch,), DT, dtype=torch.float32, device=dev)
    radial = d.expansion[:, None, None, None] * torch.stack(
        [xs - foe[:, 0, None, None], ys - foe[:, 1, None, None]], -1)
    rot = derotation_field(d.omega / dt[:, None], dt, W, H)
    bg_flow = radial + rot + d.pan[:, None, None, :]

    # img2(y) = img1(f^-1(y)), f(x) = x + flow(x): fixed-point inversion
    inv = bg_flow
    for _ in range(3):
        inv = _sample(bg_flow, xs - inv[..., 0], ys - inv[..., 1])
    bg2 = _sample(bg1, xs - inv[..., 0], ys - inv[..., 1])

    pos1 = torch.stack([pad + d.pos[:, 0] * wc, pad + d.pos[:, 1] * hc], 1)
    vel = d.vel + d.pan
    su = d.style
    style = (30.0 + 40.0 * su[:, 0], 10.0 + 20.0 * su[:, 1], 0.5 + 0.8 * su[:, 2],
             su[:, 3] * TWO_PI, su[:, 4] * TWO_PI)
    mask1, sprite1 = _sprite(xs, ys, pos1, d.radius, style)
    mask2, sprite2 = _sprite(xs, ys, pos1 + vel, d.radius, style)
    img1 = torch.where(mask1, sprite1, bg1)
    img2 = torch.where(mask2, sprite2, bg2)
    flow = torch.where(mask1[..., None], vel[:, None, None, :], bg_flow)

    aug = d.aug
    gain = (0.75 + 0.5 * aug[:, 0])[:, None, None]
    bias = ((aug[:, 1] - 0.5) * 40.0)[:, None, None]
    noise_amp = (aug[:, 2] * 2.5 * (aug[:, 3] > 0.4))[:, None, None]
    img1 = torch.clamp(img1 * gain + bias + noise_amp * d.normals[:, 0], 0, 255)
    img2 = torch.clamp(img2 * gain + bias + noise_amp * d.normals[:, 1], 0, 255)

    sky = sky_rows.expand(batch, H, W)
    if pad:
        def crop(a):
            return a[:, pad:pad + hc, pad:pad + wc]

        img1, img2, flow, sky, mask1 = (crop(img1), crop(img2), crop(flow),
                                        crop(sky), crop(mask1))
        pos1 = pos1 - pad
        foe = foe - pad
    box = torch.cat([pos1, torch.stack([2 * d.radius, 2 * d.radius], 1)], 1)
    return SynthScene(img1=img1.contiguous(), img2=img2.contiguous(),
                      flow=flow.contiguous(), sky=sky.contiguous(),
                      seg=mask1.contiguous(), box=box, foe=foe, omega=d.omega,
                      dt=dt)


def generate_scene(h: int, w: int, sin_blend: float = 0.6, pan_max: float = 0.0,
                   draws: Optional[SceneDraws] = None,
                   generator: Optional[torch.Generator] = None,
                   device: Device = "cuda") -> SynthScene:
    """One scene (no batch axis): ``generate_batch`` of one. ``draws`` has a
    leading axis of 1."""
    s = generate_batch(1, h, w, pan_max, sin_blend, draws, generator, device)
    return SynthScene(*(t[0] for t in s))
