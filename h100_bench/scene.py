"""The benchmark's traffic: a forward-flight scene rendered on the device.

The scene family of the program's synthetic dataset (a textured ground
under radial expansion about the focus of expansion, the IMU rotation field,
a textured intruder disc on its own path, a brighter, smoother sky band and a
depth map), rendered in closed form per frame so that a ring of hundreds of
frames neither drifts nor zooms without bound: the camera flies over a
ground plane at a constant speed, so new ground enters at the horizon, and
every consecutive pair is a forward-flight pair. Everything is drawn from
one seed with a ``torch.Generator`` on the device, in a few large calls.

``render(scene, n, seed, device)`` gives a chain of ``n`` frames:
``gray`` (n, h, w) uint8, ``bgr`` (n, h, w, 3) uint8 (the gray tinted per
region, as a colour camera's frames), ``seg`` (n, h, w) uint8 (255 on the
intruder), ``sky`` (n, h, w) bool (the sky estimate a segmenter would give),
``depth`` (h, w) float32, ``omega`` (n, 3) rad/s (element i: the rotation
from frame i to i + 1 over ``dt``), ``foe`` (2,) (x, y) and ``dt``.
The ``scene`` mapping is a configuration's ``scene`` group with its
``height`` and ``width``.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

TEXTURE = 1024          # texels a side of the periodic ground and sky textures


def _blurred_noise(gen: torch.Generator, size: int, sigmas, weights,
                   device: torch.device) -> torch.Tensor:
    """(size, size) periodic texture in [0, 1]: white noise blurred
    circularly at each sigma (texels), weighted and summed."""
    noise = torch.rand((len(sigmas), size, size), generator=gen, device=device)
    k = torch.fft.fftfreq(size, device=device)
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    spec = torch.fft.fft2(noise)
    out = torch.zeros((size, size), device=device)
    for i, (s, wt) in enumerate(zip(sigmas, weights)):
        gauss = torch.exp(-2.0 * math.pi ** 2 * s ** 2 * k2)
        layer = torch.fft.ifft2(spec[i] * gauss).real
        layer = (layer - layer.mean()) / layer.std().clamp(min=1e-6)
        out = out + wt * layer
    out = (out - out.min()) / (out.max() - out.min()).clamp(min=1e-6)
    return out


def _sample_periodic(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a periodic texture at texel coordinates (u, v)."""
    size = tex.shape[0]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    iu = u0.to(torch.int64) % size
    iv = v0.to(torch.int64) % size
    iu1 = (iu + 1) % size
    iv1 = (iv + 1) % size
    flat = tex.reshape(-1)

    def tap(a, b):
        return flat[a * size + b]

    return ((1 - fv) * ((1 - fu) * tap(iv, iu) + fu * tap(iv, iu1))
            + fv * ((1 - fu) * tap(iv1, iu) + fu * tap(iv1, iu1)))


def render(scene: Mapping, n: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """A chain of ``n`` consecutive frames of the scene drawn from ``seed``."""
    dev = torch.device(device)
    h, w = int(scene["height"]), int(scene["width"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2 ** 63))
    ground_tex = _blurred_noise(gen, TEXTURE, (1.5, 6.0, 24.0), (1.0, 0.7, 0.5), dev)
    sky_tex = _blurred_noise(gen, TEXTURE, (4.0, 16.0), (1.0, 0.5), dev)
    draws = torch.rand(16, generator=gen, device=dev).cpu().tolist()

    horizon = float(scene["horizon"]) * h      # the FoE's row
    xc = 0.5 * w + (draws[0] - 0.5) * 0.2 * w  # the FoE's column
    f = 0.5 * w                                 # focal length, px
    z_max = 60.0                                # farthest ground drawn
    # the forward speed that moves the farther bottom corner by max_flow_px
    # a frame: there |flow| = v (y - y_h) sqrt((x - x_c)^2 + (y - y_h)^2) / f
    dy_b = h - horizon
    dx_b = max(xc, w - xc)
    speed = float(scene["max_flow_px"]) * f / (dy_b * math.hypot(dx_b, dy_b))
    texels = f / (1.5 * (f / dy_b) ** 2)       # ~1.5 px a texel on the bottom row
    t0 = draws[1] * 1000.0                     # where along the flight the chain starts
    lateral = draws[2] * TEXTURE

    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    xn = -(xs / w - 0.5) * 2.0
    yn = -(ys / h - 0.5) * 2.0

    # IMU: slow oscillating body rates (rad a frame), integrated to angles
    amp = float(scene["omega_amp"])
    t = torch.arange(n + 1, device=dev, dtype=torch.float32) + t0
    phase = torch.tensor(draws[3:6], device=dev) * 2 * math.pi
    rate = amp * torch.stack([torch.sin(0.5 * t / 3 + phase[0]),
                              torch.cos(0.4 * t / 3 + phase[1]),
                              torch.sin(0.3 * t / 3 + phase[2])], dim=1)
    angle = torch.cumsum(rate, dim=0) - rate[0]

    dt = float(scene["dt"])
    radius = float(scene["drone_radius"])
    start = torch.tensor([draws[6] * w, draws[7] * h], device=dev)
    vel = (torch.tensor([draws[8], draws[9]], device=dev) - 0.5) * 2 * float(scene["drone_speed_px"])

    gray = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
    seg = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
    sky_est = torch.empty((n, h, w), dtype=torch.bool, device=dev)
    ground_rows = ys > horizon
    edge = (ys >= horizon - 2) & (ys < horizon)
    edge_noise = torch.rand((n, 1, w), generator=gen, device=dev) > 0.5
    for i in range(n):
        a = angle[i]
        # the frame seen through the accumulated rotation: sample where the
        # rotational field moved each pixel from
        rx = (a[0] * xn * yn - a[1] * xn * xn - a[1] + a[2] * yn) * (w / 2.0)
        ry = (-a[2] * xn + a[0] + a[0] * yn * yn - a[1] * xn * yn) * (h / 2.0)
        x = xs - rx
        y = ys - ry
        z = (f / (y - horizon).clamp(min=f / z_max)).clamp(max=z_max)
        ground = _sample_periodic(ground_tex, (x - xc) * z / f * texels + lateral,
                                  (z + speed * (t[i] - t0)) * texels)
        fade = (20.0 / z).clamp(max=1.0)
        ground = 0.55 + (ground - 0.55) * fade
        sky = _sample_periodic(sky_tex, x, y)
        img = torch.where(y > horizon, 20.0 + 220.0 * ground, 150.0 + 95.0 * sky)
        # the intruder: a textured disc bouncing inside the frame
        p = start + vel * (t[i] - t0)
        span = torch.tensor([w - 2 * radius, h - 2 * radius], device=dev)
        p = radius + span - (torch.remainder(p, 2 * span) - span).abs()
        ddx = xs - p[0]
        ddy = ys - p[1]
        disc = ddx * ddx + ddy * ddy <= radius * radius
        img = torch.where(disc, 45.0 + 20.0 * torch.sin(0.9 * ddx) * torch.cos(0.9 * ddy), img)
        gray[i] = img.clamp(0, 255).round().to(torch.uint8)
        seg[i] = disc.to(torch.uint8) * 255
        sky_est[i] = (~ground_rows & ~edge | edge & edge_noise[i]) & ~disc

    tint = torch.tensor([0.92, 1.0, 1.06], device=dev)   # B, G, R
    sky_tint = torch.tensor([1.04, 1.0, 0.93], device=dev)
    is_sky = (~ground_rows)[None, :, :, None]
    g = gray.to(torch.float32)[..., None]
    bgr = torch.where(is_sky, g * sky_tint, g * tint).clamp(0, 255).round().to(torch.uint8)

    depth = torch.where(ground_rows, (f / (ys - horizon).clamp(min=1e-3)).clamp(max=z_max) * 0.8,
                        torch.full_like(ys, 100.0)).expand(h, w).contiguous()
    return {"gray": gray, "bgr": bgr, "seg": seg, "sky": sky_est,
            "depth": depth, "omega": rate[1:] / dt, "foe": torch.tensor([xc, horizon], device=dev),
            "dt": dt}
