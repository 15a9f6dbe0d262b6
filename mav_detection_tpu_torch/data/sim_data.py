"""AirSim simulation dataset (``mav_detection_tpu.data.sim_data``).

Per-frame JSON state files (IMU quaternion, UE4 FoE, view-projection matrix),
GT flow synthesised from depth and camera matrices on ``Dataset.device``
(``airsim_flow.py``), YOLO annotations from the segmentation masks, and
colour-mapped depth PNGs.
"""
from __future__ import annotations

import json
import logging
import os
import re
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from mav_detection_tpu_torch.core.flo import read_flow
from mav_detection_tpu_torch.data.dataset import (
    Dataset,
    create_if_not_exists,
    imread,
    imwrite,
    read_pfm,
    sorted_glob,
)
from mav_detection_tpu_torch.ops.image.boxes import get_simple_bounding_box
from mav_detection_tpu_torch.utils.device import resolve_device


def quat_to_euler_xyz(x: float, y: float, z: float, w: float) -> np.ndarray:
    """Quaternion -> XYZ euler (rad), scipy 'xyz' convention."""
    try:
        from scipy.spatial.transform import Rotation

        return Rotation.from_quat([x, y, z, w]).as_euler("xyz", degrees=False)
    except (ImportError, ValueError):
        # closed-form fallback (also for a zero quaternion, which scipy refuses)
        roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
        pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1, 1))
        yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
        return np.array([roll, pitch, yaw])


class SimDataset(Dataset):
    def __init__(self, logger: Optional[logging.Logger] = None,
                 sequence: str = "",
                 device: Union[str, torch.device] = "cuda") -> None:
        base = os.environ["SIMDATA_PATH"]
        self.start_time = 0.0
        super().__init__(base, logger, sequence, device=device)

        # every timestamp-named state file, numerically ordered: real AirSim
        # stamps are ns-epoch (lexical == numeric), mock-collector stamps
        # zero-padded ms from t=0
        def order(p: str):
            stem = os.path.basename(p)[:-len(".json")]
            return (0, int(stem)) if stem.isdigit() else (1, stem)

        self._state_files = sorted(
            (p for p in sorted_glob(f"{self.state_path}/*.json")
             if "timestamp" not in p), key=order)
        if not os.listdir(self.ann_path):
            self.create_annotations()
        if self._state_files and not os.path.exists(
                f"{self.gt_of_path}/image_00000.flo"):
            self.create_ground_truth_optical_flow()
        self.start_time = self.get_time(0) if self._state_files else 0.0

    def get_default_sequence(self) -> str:
        return "citypark-stationary/soccerfield-north-low-2.5-10-default"

    # ------------------------------------------------------------- states
    def get_state_filenames(self) -> List[str]:
        return self._state_files

    def get_state(self, i: int) -> Any:
        with open(self._state_files[i], "r") as f:
            return json.load(f)

    def get_orientation(self, i: int) -> np.ndarray:
        o = self.get_state(i)["Drone1"]["imu"]["orientation"]
        return quat_to_euler_xyz(o["x_val"], o["y_val"], o["z_val"], o["w_val"])

    def get_angular_difference(self, first: int, second: int) -> np.ndarray:
        """Body-frame axis remap of the euler delta: (pitch, yaw, roll) with
        the roll sign flipped."""
        omega = self.get_orientation(second) - self.get_orientation(first)
        omega = omega[[1, 2, 0]]
        omega[2] = -omega[2]
        return omega

    def get_time(self, i: int) -> float:
        ts = self.get_state(i)["Drone1"]["imu"]["time_stamp"]
        return ts / 1e9 - self.start_time

    def get_delta_time(self, i: int) -> float:
        return float(self.get_time(i) - self.get_time(i - 1))

    def get_gt_foe(self, i: int) -> Optional[Tuple[float, float]]:
        foe = self.get_state(i)["Drone1"]["ue4"]["FoE"]
        return (foe["X"] * self.capture_size[0], foe["Y"] * self.capture_size[1])

    # -------------------------------------------------------- derived data
    def create_annotations(self) -> None:
        """Auto-annotate from the segmentation's bounding box."""
        for path in sorted_glob(f"{self.seg_path}/image_*.png"):
            idx = re.findall(r"image_(\d+)[.]png$", os.path.basename(path))[0]
            img = imread(path)
            rect = get_simple_bounding_box(img)
            img_size = np.array([img.shape[1], img.shape[0]])
            with open(f"{self.ann_path}/image_{idx}.txt", "w") as f:
                f.write(rect.to_yolo(img_size))

    def create_depth_visualisation(self) -> None:
        """Colormapped depth PNGs under ``depth-vis/``: depth normalized to
        its per-frame max, scaled by the 5x sky-distance factor so everything
        nearer than 1/5 of the far plane uses the full color range, capped at
        255, jet-mapped. Skips frames whose PNG already exists."""
        from mav_detection_tpu_torch.ops.image.visualize import apply_colormap

        create_if_not_exists(self.depth_vis_path)
        sky_distance_factor = 5.0
        for i, pfm_path in enumerate(
                sorted_glob(f"{self.depth_path}/image_*.pfm")):
            out_path = f"{self.depth_vis_path}/image_{i:05d}.png"
            if os.path.exists(out_path):
                continue
            depth = read_pfm(pfm_path).astype(np.float32)
            peak = float(np.max(depth)) if depth.size else 1.0
            scaled = depth / (peak or 1.0) * 255.0 * sky_distance_factor
            depth_u8 = np.clip(scaled, 0.0, 255.0).astype(np.uint8)
            imwrite(out_path, apply_colormap(depth_u8))

    def create_ground_truth_optical_flow(self) -> None:
        """GT flow of every pair, computed on ``self.device``."""
        from mav_detection_tpu_torch.data.airsim_flow import write_sequence_gt_flow

        create_if_not_exists(self.gt_of_path)
        create_if_not_exists(self.gt_of_vis_path)
        write_sequence_gt_flow(self)

    def get_gt_of(self, i: int) -> Optional[np.ndarray]:
        """GT flow of pair (i, i+1), resized on ``self.device`` where its file
        is not at the capture size (``ops/image/resize.resize``, linear)."""
        flow = read_flow(f"{self.gt_of_path}/image_{i:05d}.flo")
        if flow.shape[:2] != (self.capture_size[1], self.capture_size[0]):
            from mav_detection_tpu_torch.ops.image.resize import resize

            dev = resolve_device(self.device)
            flow = resize(torch.from_numpy(flow).to(dev),
                          (self.capture_size[1], self.capture_size[0])).cpu().numpy()
        return flow
