"""VisDrone dataset (images under <base>/sequences/<seq>/): a copy of
``mav_detection_tpu.data.vis_drone``, with its env var and default
sequence."""
from __future__ import annotations

import logging
import os
from typing import Optional, Union

import torch

from mav_detection_tpu_torch.data.dataset import Dataset


class VisDroneDataset(Dataset):
    def __init__(self, logger: Optional[logging.Logger] = None,
                 sequence: str = "",
                 device: Union[str, torch.device] = "cuda") -> None:
        base = os.environ["VIS_DRONE_PATH"]
        super().__init__(base, logger, sequence, img_dir="", seq_dir="/sequences",
                         device=device)

    def get_default_sequence(self) -> str:
        return "uav0000244_01440_v"
