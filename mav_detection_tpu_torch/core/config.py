"""Typed run configuration.

Same enums, names and ``settings.json`` schema as
``mav_detection_tpu.core.config``; ``get_dataset`` builds the port's own
datasets (``mav_detection_tpu_torch.data``).
"""
from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional


class Mode(Enum):
    """Detection modes, names identical to the upstream RunConfig.Mode."""

    APPEARANCE_RGB = 0
    FLOW_UV = 1
    FLOW_RADIAL = 2
    FLOW_FOE_YOLO = 3
    FLOW_FOE_CLUSTERING = 4

    def __str__(self) -> str:
        return self.name


class DatasetType(Enum):
    MIDGARD = 0
    SIMULATION = 1
    EXPERIMENT = 2
    VIS_DRONE = 3
    SYNTHETIC = 4  # procedurally generated fixture (no simulator needed)

    def __str__(self) -> str:
        return self.name


class Algorithm(Enum):
    """Ego-motion algorithms."""

    NONE = 0
    FOE = 1
    AFFINE = 2
    HOMOGRAPHY = 3
    FUNDAMENTAL = 4
    ESSENTIAL = 5


class FlowSource(Enum):
    """Where dense flow comes from."""

    PRECOMPUTED = 0  # .flo files on disk
    FARNEBACK = 1    # on-device Farneback kernels
    LUCAS_KANADE = 2 # on-device pyramidal LK densified
    RAFT = 3         # on-device RAFT-style network
    GROUND_TRUTH = 4 # synthetic/sim GT flow


def _parse_enum(enum_cls: Any, key: str) -> Any:
    options = [m.name for m in enum_cls]
    k = key.upper()
    if k not in options:
        raise ValueError(
            f"{key} is not a valid {enum_cls.__name__}, has to be one of {', '.join(options)}"
        )
    return enum_cls[k]


DEFAULT_SETTINGS: Dict[str, Any] = {
    "train_sequences": [],
    "validation_sequences": [],
    "yolo_train_weights": {},
}


def load_settings(path: Optional[str] = None) -> Dict[str, Any]:
    """Load ``settings.json``; search CWD then the repo root, else defaults."""
    candidates = [path] if path else [
        os.path.join(os.getcwd(), "settings.json"),
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "settings.json"),
    ]
    for cand in candidates:
        if cand and os.path.exists(cand):
            with open(cand, "r") as f:
                loaded = json.load(f)
            merged = dict(DEFAULT_SETTINGS)
            merged.update(loaded)
            return merged
    return dict(DEFAULT_SETTINGS)


@dataclass
class RunConfig:
    dataset: str = "midgard"
    sequence: str = ""
    mode: Mode = Mode.FLOW_UV
    algorithm: Algorithm = Algorithm.ESSENTIAL
    flow_source: FlowSource = FlowSource.PRECOMPUTED
    debug: bool = False
    prepare_dataset: bool = False
    validate: bool = False
    headless: bool = True
    data_to_yolo: bool = False
    undistort: bool = False
    batch_size: int = 8
    # dense-FoE sampling budget for the fused detection step (upstream N=1000)
    foe_samples: int = 1000
    use_sparse_of: bool = False
    # frame-batch data parallelism over N devices (0 = single device)
    devices: int = 0
    # frame engine: "batch" (the ported one), "scan", "chunked", "spatial"
    engine: str = "batch"
    settings_path: Optional[str] = None
    logger: Optional[logging.Logger] = None
    settings: Dict[str, Any] = field(default_factory=dict)
    results: Dict[int, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if isinstance(self.mode, str):
            self.mode = _parse_enum(Mode, self.mode)
        if isinstance(self.algorithm, str):
            self.algorithm = _parse_enum(Algorithm, self.algorithm)
        if isinstance(self.flow_source, str):
            self.flow_source = _parse_enum(FlowSource, self.flow_source)
        if self.engine not in ("batch", "scan", "chunked", "spatial"):
            raise ValueError(
                f"engine={self.engine!r}: must be batch, scan, chunked or "
                "spatial")
        if not self.settings:
            self.settings = load_settings(self.settings_path)
        if self.logger is None:
            self.logger = logging.getLogger("mav_detection_tpu_torch")

    def get_dataset_type(self) -> DatasetType:
        return _parse_enum(DatasetType, self.dataset)

    def uses_nn_for_detection(self) -> bool:
        return self.mode in (Mode.FLOW_UV, Mode.FLOW_RADIAL, Mode.FLOW_FOE_YOLO)

    def get_all_sequences(self) -> List[str]:
        return list(self.settings.get("train_sequences", [])) + list(
            self.settings.get("validation_sequences", [])
        )

    def get_dataset(self, device="cuda"):  # -> data.Dataset (late import)
        from mav_detection_tpu_torch.data import make_dataset

        ds = make_dataset(self.get_dataset_type(), self.logger, self.sequence,
                          device=device)
        self.sequence = ds.sequence
        return ds

    def __str__(self) -> str:
        return f"{self.dataset}/{self.sequence}/{self.mode}"
