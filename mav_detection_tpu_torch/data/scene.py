"""Non-uniform-motion frame pair with analytic GT flow, rendered with scipy.

The scene family of the reference's ``bench.make_scene``: a blurred-noise
ground, a brighter smoother sky band, radial expansion about an off-centre
FoE plus the IMU rotation field, and a moving intruder disc. That version
renders with OpenCV; this one uses ``scipy.ndimage.gaussian_filter``
(reflect-101 borders, 4-sigma truncation) and ``map_coordinates(order=1,
mode="nearest")`` in place of ``cv2.GaussianBlur`` and ``cv2.remap``, so it
runs where OpenCV is absent. The pixels differ slightly from the OpenCV
render; the GT flow field is the same formula.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.ndimage import gaussian_filter, map_coordinates

FOE = (310.0, 190.0)
EXPANSION = 0.016          # ~8 px at the far corner of 752x480
OMEGA = (0.003, -0.002, 0.004)
DT = 0.05

# the reference resolution's scene (bench.hires_fields): 1920x1024
HIRES_SCENE = dict(expansion=0.006, drone_pos=(430.0, 260.0),
                   drone_vel=(6.0, 4.0), drone_radius=22.0)


def hires_scene_kwargs(h: int, w: int) -> dict:
    return dict(HIRES_SCENE, foe=(w * 0.41, h * 0.4))


def _rotation_field(w: int, h: int) -> np.ndarray:
    xs = np.tile(np.arange(w, dtype=np.float64), (h, 1))
    ys = np.tile(np.arange(h, dtype=np.float64)[:, None], (1, w))
    xn = -(xs / w - 0.5) * 2.0
    yn = -(ys / h - 0.5) * 2.0
    o = np.asarray(OMEGA) / DT
    u = o[0] * xn * yn - o[1] * xn ** 2 - o[1] + o[2] * yn
    v = -o[2] * xn + o[0] + o[0] * yn ** 2 - o[1] * xn * yn
    return np.stack([u * (w * DT / 2.0), v * (h * DT / 2.0)], axis=-1)


def _remap(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    return map_coordinates(img, [map_y, map_x], order=1,
                           mode="nearest").astype(np.float32)


def make_scene(seed: int, h: int = 480, w: int = 752, foe=FOE,
               expansion: float = EXPANSION, drone_pos=(170.0, 120.0),
               drone_vel=(4.0, 2.5), drone_radius: float = 10.0
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(prev8, curr8, gt_flow): uint8 (h, w) frames and (h, w, 2) flow."""
    rng = np.random.default_rng(seed)
    ground = gaussian_filter(rng.random((h, w)).astype(np.float32), 1.5,
                             mode="mirror", truncate=4.0)
    ground = (ground - ground.min()) / max(np.ptp(ground), 1e-6) * 220 + 20
    sky = gaussian_filter(rng.random((h, w)).astype(np.float32), 4.0,
                          mode="mirror", truncate=4.0)
    sky = (sky - sky.min()) / max(np.ptp(sky), 1e-6) * 95 + 150
    ys = np.arange(h)[:, None]
    prev = np.where(ys < int(0.35 * h), sky, ground).astype(np.float32)

    xs_g, ys_g = np.meshgrid(np.arange(w, dtype=np.float32),
                             np.arange(h, dtype=np.float32))
    grid = np.stack([xs_g, ys_g], axis=-1)
    flow = (expansion * (grid - np.asarray(foe, np.float32))
            + _rotation_field(w, h).astype(np.float32))

    # render curr: curr(y) = prev(f^-1(y)), inverted by fixed point
    inv = flow.copy()
    for _ in range(4):
        mx, my = xs_g - inv[..., 0], ys_g - inv[..., 1]
        inv = np.stack([_remap(flow[..., 0], mx, my),
                        _remap(flow[..., 1], mx, my)], axis=-1)
    curr = _remap(prev, xs_g - inv[..., 0], ys_g - inv[..., 1])

    # intruder disc with its own motion
    pos = np.asarray(drone_pos, np.float64)
    vel = np.asarray(drone_vel, np.float64)
    for img, p in ((prev, pos), (curr, pos + vel)):
        dx = xs_g - p[0]
        dy = ys_g - p[1]
        m = dx ** 2 + dy ** 2 <= drone_radius ** 2
        img[m] = (45.0 + 20.0 * np.sin(0.9 * dx[m]) * np.cos(0.9 * dy[m]))
    m1 = (xs_g - pos[0]) ** 2 + (ys_g - pos[1]) ** 2 <= drone_radius ** 2
    flow[m1] = vel

    return (np.clip(prev, 0, 255).astype(np.uint8),
            np.clip(curr, 0, 255).astype(np.uint8), flow)


def epe_interior(flow: np.ndarray, gt: np.ndarray, crop: int = 16) -> float:
    """Mean end-point error on the ``crop``-px interior (bench.py's gate)."""
    err = np.linalg.norm(np.asarray(flow) - gt, axis=-1)
    return float(err[crop:-crop, crop:-crop].mean())


def bench_scene(seed: int, h: int, w: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The bench scene scaled to (h, w) as the reference's cross-domain
    evaluation scales it (``tools/cross_domain_eval.py``): FoE, drone
    position, speed and radius follow the frame size. Returns (prev8, curr8,
    gt_flow, drone_mask)."""
    scale = min(h / 480, w / 752)
    foe = (FOE[0] * w / 752, FOE[1] * h / 480)
    pos = (170.0 * w / 752, 120.0 * h / 480)
    radius = max(10.0 * scale, 4.0)
    prev, curr, gt = make_scene(seed, h=h, w=w, foe=foe, expansion=EXPANSION,
                                drone_pos=pos, drone_vel=(4.0 * scale, 2.5 * scale),
                                drone_radius=radius)
    drone = ((np.arange(w)[None, :] - pos[0]) ** 2
             + (np.arange(h)[:, None] - pos[1]) ** 2 <= radius ** 2)
    return prev, curr, gt, drone
