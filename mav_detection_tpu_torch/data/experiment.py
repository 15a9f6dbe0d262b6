"""TNO field-experiment dataset: video + GPS/IMU CSV logs. A copy of
``mav_detection_tpu.data.experiment``: frame<->log alignment by
nearest timestamp (one argmin matrix) and gyro-rate integration between
matched rows (cumulative sums)."""
from __future__ import annotations

import logging
import os
from typing import Optional, Union

import numpy as np
import torch

from mav_detection_tpu_torch.data.dataset import Dataset


class ExperimentDataset(Dataset):
    CROPPED_START_FRAME = 4 * 60 + 54
    DURATION_S = 15

    def __init__(self, logger: Optional[logging.Logger] = None,
                 sequence: str = "",
                 device: Union[str, torch.device] = "cuda") -> None:
        base = os.environ["EXPERIMENT_PATH"]
        super().__init__(base, logger, sequence, device=device)

        self.gps_log = np.genfromtxt(f"{self.state_path}/vn_gps_log.csv",
                                     delimiter=",", skip_header=1)
        self.imu_log = np.genfromtxt(f"{self.state_path}/vn_imu_log.csv",
                                     delimiter=",", skip_header=1)
        self.fps = (self.N + 1) / self.DURATION_S

        video_t = np.arange(self.N) / self.fps
        gps_t = self.gps_log[:, 2] - self.gps_log[0, 2] - self.CROPPED_START_FRAME
        imu_t = self.imu_log[:, 2] - self.imu_log[0, 2] - self.CROPPED_START_FRAME
        # int64: a 400 Hz IMU log spanning the alignment offset has >65k rows,
        # and index 0 must survive the ``b - 1`` in get_angular_difference
        self.video_gps_indices = np.argmin(
            np.abs(gps_t[None, :] - video_t[:, None]), axis=1)
        self.video_imu_indices = np.argmin(
            np.abs(imu_t[None, :] - video_t[:, None]), axis=1)

        # cumulative gyro integral for O(1) angular differences
        dt = np.diff(self.imu_log[:, 2], prepend=self.imu_log[0, 2])
        self._gyro_cumsum = np.cumsum(self.imu_log[:, 6:9] * dt[:, None], axis=0)

    def get_default_sequence(self) -> str:
        return "moving-sample"

    def get_gps_state(self, i: int) -> np.ndarray:
        return self.gps_log[self.video_gps_indices[i], :]

    def get_imu_state(self, i: int) -> np.ndarray:
        return self.imu_log[self.video_imu_indices[i], :]

    def get_angular_difference(self, first: int, second: int) -> np.ndarray:
        a = self.video_imu_indices[first]
        b = self.video_imu_indices[second]
        delta = self._gyro_cumsum[max(b - 1, 0)] - self._gyro_cumsum[max(a - 1, 0)]
        # body-frame remap with x/y sign flips
        delta = delta[[1, 2, 0]]
        delta[0] = -delta[0]
        delta[1] = -delta[1]
        return delta

    def get_delta_time(self, i: int) -> float:
        return 1.0 / self.fps

    def get_time(self, i: int) -> float:
        return i / self.fps
