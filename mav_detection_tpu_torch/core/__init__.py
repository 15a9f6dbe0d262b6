from mav_detection_tpu_torch.core.rectangle import Rectangle
from mav_detection_tpu_torch.core.flo import read_flow, write_flow
from mav_detection_tpu_torch.core.frame_result import FrameResult
from mav_detection_tpu_torch.core.config import (
    Algorithm,
    DatasetType,
    FlowSource,
    Mode,
    RunConfig,
)

__all__ = [
    "Rectangle",
    "read_flow",
    "write_flow",
    "FrameResult",
    "Mode",
    "DatasetType",
    "Algorithm",
    "FlowSource",
    "RunConfig",
]
