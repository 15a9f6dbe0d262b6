"""MIDGARD dataset (752x480 real drone footage): a copy of
``mav_detection_tpu.data.midgard``, with its env var and default sequence."""
from __future__ import annotations

import logging
import os
from typing import Optional, Union

import torch

from mav_detection_tpu_torch.data.dataset import Dataset


class MidgardDataset(Dataset):
    def __init__(self, logger: Optional[logging.Logger] = None,
                 sequence: str = "",
                 device: Union[str, torch.device] = "cuda") -> None:
        base = os.environ["MIDGARD_PATH"]
        super().__init__(base, logger, sequence, device=device)

    def get_default_sequence(self) -> str:
        return "countryside-natural/north-narrow"
