"""Procedural synthetic dataset: the CI/bench fixture.

Copy of ``mav_detection_tpu.data.synthetic`` (numpy + scipy): for the same
``SyntheticParams`` it produces bit-identical frames, flows, masks, depth and
IMU state. A forward-flight scene entirely in memory:

* background: textured plane under radial expansion about a known FoE plus a
  small IMU rotation field (the exact quadratic model ``derotate`` subtracts);
* intruder: a textured disc on an independent linear path (the target), with
  exact flow override inside its mask;
* depth: far sky band + ground falloff (the depth > 0.8*max sky-GT rule);
* per-frame IMU state (omega, dt), GT FoE, YOLO annotations.

``materialize()`` writes it in the reference directory layout, the
``optical-flow-vis`` colour images included.
"""
from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
from scipy.ndimage import map_coordinates

from mav_detection_tpu_torch.core.rectangle import Rectangle
from mav_detection_tpu_torch.data import dataset as dsmod
from mav_detection_tpu_torch.data.dataset import Dataset, create_if_not_exists


@dataclass
class SyntheticParams:
    height: int = 240
    width: int = 320
    n_frames: int = 24
    expansion: float = 0.012          # radial expansion rate per frame
    foe: Tuple[float, float] = (190.0, 110.0)  # (x, y)
    omega_amp: float = 0.004          # rad/frame rotation amplitude
    dt: float = 0.05                  # seconds between frames
    drone_radius: int = 9
    drone_start: Tuple[float, float] = (60.0, 60.0)
    drone_velocity: Tuple[float, float] = (4.0, 1.5)
    horizon: float = 0.35             # sky fraction of the image
    texture_blur: float = 1.5
    seed: int = 0


def _derotation_field_np(omega: np.ndarray, dt: float, w: int, h: int) -> np.ndarray:
    """Host copy of the quadratic rotational-flow model (ops/geometry/derotation)."""
    xs = np.tile(np.arange(w, dtype=np.float64), (h, 1))
    ys = np.tile(np.arange(h, dtype=np.float64)[:, None], (1, w))
    xn = -(xs / w - 0.5) * 2.0
    yn = -(ys / h - 0.5) * 2.0
    u = omega[0] * xn * yn - omega[1] * xn ** 2 - omega[1] + omega[2] * yn
    v = -omega[2] * xn + omega[0] + omega[0] * yn ** 2 - omega[1] * xn * yn
    u = u * (w * dt / 2.0)
    v = v * (h * dt / 2.0)
    return np.stack([u, v], axis=-1)


class SyntheticDataset(Dataset):
    """In-memory sequence; Dataset-compatible accessor surface."""

    def __init__(self, logger: Optional[logging.Logger] = None,
                 sequence: str = "", params: Optional[SyntheticParams] = None,
                 materialize_to: Optional[str] = None) -> None:
        # NOTE: deliberately does NOT call Dataset.__init__ (no filesystem).
        self.logger = logger or logging.getLogger("mav_detection_tpu_torch.data")
        self.params = params or SyntheticParams()
        self.sequence = sequence or self.get_default_sequence()
        p = self.params

        self.N = p.n_frames
        self.capture_shape = (p.height, p.width, 3)
        self.capture_size = (p.width, p.height)
        self.resolution = np.array([p.width, p.height])
        self.start_frame = 0
        self.ground_truth: List[Rectangle] = []
        self.seq_path = ""
        self.results_path = ""
        self.result_imgs_path = ""

        self._generate()

        # Under the CLI (SYNTHETIC_PATH set or materialize_to passed) the
        # fixture writes itself to disk so results land in the disk layout.
        target = materialize_to or os.environ.get("SYNTHETIC_PATH")
        if target:
            self.materialize(target)
            create_if_not_exists(self.results_path)

    def get_default_sequence(self) -> str:
        return "synthetic/forward-flight"

    # ------------------------------------------------------------ generator
    def _generate(self) -> None:
        p = self.params
        rng = np.random.default_rng(p.seed)
        h, w = p.height, p.width

        # large base texture so expansion never runs out of content
        pad = int(0.6 * max(h, w)) + 8
        bh, bw = h + 2 * pad, w + 2 * pad
        base = rng.random((bh, bw)).astype(np.float32)
        # cheap separable smoothing for trackable texture
        k = int(p.texture_blur * 4) | 1
        kernel = np.exp(-0.5 * ((np.arange(k) - k // 2) / p.texture_blur) ** 2)
        kernel /= kernel.sum()
        base = np.apply_along_axis(lambda m: np.convolve(m, kernel, "same"), 0, base)
        base = np.apply_along_axis(lambda m: np.convolve(m, kernel, "same"), 1, base)
        base = (base - base.min()) / max(float(np.ptp(base)), 1e-6) * 220 + 20

        # sky texture: brighter and smoother than the ground
        sky_sigma = 4.0
        k2 = int(sky_sigma * 4) | 1
        kern2 = np.exp(-0.5 * ((np.arange(k2) - k2 // 2) / sky_sigma) ** 2)
        kern2 /= kern2.sum()
        sky_tex = rng.random((bh, bw)).astype(np.float32)
        sky_tex = np.apply_along_axis(lambda m: np.convolve(m, kern2, "same"), 0, sky_tex)
        sky_tex = np.apply_along_axis(lambda m: np.convolve(m, kern2, "same"), 1, sky_tex)
        sky_tex = (sky_tex - sky_tex.min()) / max(float(np.ptp(sky_tex)), 1e-6) * 95 + 150

        xs = np.tile(np.arange(w, dtype=np.float64), (h, 1))
        ys = np.tile(np.arange(h, dtype=np.float64)[:, None], (1, w))
        grid = np.stack([xs, ys], axis=-1)

        self.omegas = np.zeros((p.n_frames, 3))
        self.flows = np.zeros((p.n_frames - 1, h, w, 2), np.float32)
        self.frames = np.zeros((p.n_frames, h, w, 3), np.uint8)
        self.segs = np.zeros((p.n_frames, h, w), np.uint8)
        self.foes = np.zeros((p.n_frames, 2))
        self.drone_pos = np.zeros((p.n_frames, 2))

        # per-pixel map from frame coords to base-texture coords
        phi = grid + pad

        # static depth: sky band far, ground nearer with gradient
        horizon_y = int(p.horizon * h)
        depth = np.empty((h, w), np.float32)
        depth[:horizon_y] = 100.0
        depth[horizon_y:] = np.linspace(40.0, 5.0, h - horizon_y)[:, None]
        self.depth = depth
        self.sky_gt = depth > 0.8 * depth.max()

        # imperfect sky estimate (exercises sky TPR/FPR < 1); per-frame
        # because a real segmenter does NOT label the drone as sky
        sky_base = self.sky_gt.copy()
        sky_base[max(horizon_y - 2, 0):horizon_y] = rng.random((min(2, horizon_y), w)) > 0.5
        self.sky_est = np.zeros((p.n_frames, h, w), bool)

        sky_rows = ys < horizon_y
        for i in range(p.n_frames):
            # render frame i from the textures via the cumulative map;
            # sky band composited in image space (static depth band)
            gray_ground = map_coordinates(base, [phi[..., 1], phi[..., 0]],
                                          order=1, mode="nearest").astype(np.float32)
            gray_sky = map_coordinates(sky_tex, [phi[..., 1], phi[..., 0]],
                                       order=1, mode="nearest").astype(np.float32)
            gray = np.where(sky_rows, gray_sky, gray_ground)
            frame = np.repeat(gray[..., None], 3, axis=-1)

            # intruder disc with its own texture
            pos = np.array(p.drone_start) + np.array(p.drone_velocity) * i
            self.drone_pos[i] = pos
            dy = ys - pos[1]
            dx = xs - pos[0]
            mask = dx ** 2 + dy ** 2 <= p.drone_radius ** 2
            sprite = 45.0 + 20.0 * np.sin(0.9 * dx) * np.cos(0.9 * dy)
            frame[mask] = np.repeat(sprite[mask, None], 3, axis=-1)
            self.frames[i] = np.clip(frame, 0, 255).astype(np.uint8)
            self.segs[i] = (mask * 255).astype(np.uint8)
            self.sky_est[i] = sky_base & ~mask

            if i == p.n_frames - 1:
                self.foes[i] = p.foe
                break

            # forward flow for (i -> i+1): radial expansion + rotation field
            omega = p.omega_amp * np.array([
                np.sin(0.5 * i), np.cos(0.4 * i), np.sin(0.3 * i + 1.0)])
            self.omegas[i + 1] = omega  # angular difference between i and i+1
            radial = p.expansion * (grid - np.array(p.foe))
            rot = _derotation_field_np(omega / p.dt, p.dt, w, h)
            flow = radial + rot
            # intruder override: its image motion is its own velocity
            flow[mask] = np.array(p.drone_velocity)
            self.flows[i] = flow.astype(np.float32)
            self.foes[i] = p.foe

            # advance the cumulative texture map: phi_{i+1}(x) = phi_i(Ginv(x))
            # where G(x) = x + background_flow(x); invert by fixed point.
            bg_flow = radial + rot
            inv = grid.copy()
            for _ in range(6):
                fx = map_coordinates(bg_flow[..., 0], [inv[..., 1], inv[..., 0]],
                                     order=1, mode="nearest")
                fy = map_coordinates(bg_flow[..., 1], [inv[..., 1], inv[..., 0]],
                                     order=1, mode="nearest")
                inv = grid - np.stack([fx, fy], axis=-1)
            nphi = np.stack([
                map_coordinates(phi[..., 0], [inv[..., 1], inv[..., 0]], order=1, mode="nearest"),
                map_coordinates(phi[..., 1], [inv[..., 1], inv[..., 0]], order=1, mode="nearest"),
            ], axis=-1)
            phi = nphi

    # ------------------------------------------------------------ accessors
    def get_frame(self, i: int) -> np.ndarray:
        return self.frames[i]

    def get_flow_uv(self, i: int) -> np.ndarray:
        """Measured flow: for the synthetic fixture this is the GT flow (the
        pipeline can instead compute Farneback from the rendered frames)."""
        return self.flows[i]

    def has_precomputed_flow(self) -> bool:
        return True

    def get_gt_of(self, i: int) -> np.ndarray:
        return self.flows[min(i, self.N - 2)]

    def get_gt_foe(self, i: int) -> Tuple[float, float]:
        return (float(self.foes[i][0]), float(self.foes[i][1]))

    def get_segmentation(self, i: int) -> np.ndarray:
        return np.repeat(self.segs[i][..., None], 3, axis=-1)

    def get_sky_segmentation(self, i: int) -> np.ndarray:
        return self.sky_est[i]

    def get_depth(self, i: int) -> np.ndarray:
        return self.depth

    def get_annotation(self, i: int, ann_path: Optional[str] = None) -> List[Rectangle]:
        p = self.params
        pos = self.drone_pos[i]
        r = p.drone_radius
        rect = Rectangle.from_center((pos[0], pos[1]), (2 * r, 2 * r))
        self.ground_truth = [rect]
        return self.ground_truth

    def get_angular_difference(self, first: int, second: int) -> np.ndarray:
        return self.omegas[second]

    def get_time(self, i: int) -> float:
        return i * self.params.dt

    def get_delta_time(self, i: int) -> float:
        return self.params.dt

    # --------------------------------------------------------- materialize
    def materialize(self, base_path: str) -> str:
        """Write the sequence to disk in the reference directory layout."""
        from mav_detection_tpu_torch.core.flo import write_flow
        from mav_detection_tpu_torch.ops.image.visualize import flow_to_color

        seq = os.path.join(base_path, self.sequence)
        img_p = os.path.join(seq, "images")
        seg_p = os.path.join(seq, "segmentations")
        dep_p = os.path.join(seq, "depths")
        flo_p = os.path.join(seq, "optical-flow")
        vis_p = os.path.join(seq, "optical-flow-vis")
        ann_p = os.path.join(seq, "annotation")
        state_p = os.path.join(seq, "states")
        for d in (img_p, seg_p, dep_p, flo_p, vis_p, ann_p, state_p,
                  os.path.join(seq, "results")):
            create_if_not_exists(d)

        for i in range(self.N):
            dsmod.imwrite(os.path.join(img_p, f"image_{i:05d}.png"), self.frames[i])
            dsmod.imwrite(os.path.join(seg_p, f"image_{i:05d}.png"),
                          self.get_segmentation(i))
            dsmod.write_pfm(os.path.join(dep_p, f"image_{i:05d}.pfm"), self.depth)
            ann = self.get_annotation(i)[0]
            with open(os.path.join(ann_p, f"image_{i:05d}.txt"), "w") as f:
                f.write(ann.to_yolo(self.resolution))
            state = {
                "Drone1": {
                    "imu": {"time_stamp": int(self.get_time(i) * 1e9),
                            "omega": self.omegas[i].tolist()},
                    "ue4": {"FoE": {"X": self.foes[i][0] / self.capture_size[0],
                                    "Y": self.foes[i][1] / self.capture_size[1]}},
                }
            }
            with open(os.path.join(state_p, f"1{i:09d}.json"), "w") as f:
                json.dump(state, f)
            if i < self.N - 1:
                write_flow(os.path.join(flo_p, f"image_{i:05d}.flo"), self.flows[i])
                dsmod.imwrite(os.path.join(vis_p, f"image_{i:05d}.png"),
                              flow_to_color(self.flows[i]))
        self.seq_path = seq
        self.results_path = os.path.join(seq, "results")
        self.result_imgs_path = os.path.join(seq, "result-images")
        return seq
