from mav_detection_tpu_torch.ops.image.boxes import get_simple_bounding_box_device
from mav_detection_tpu_torch.ops.image.color import bgr_to_gray_host
from mav_detection_tpu_torch.ops.image.metrics import (
    _tpr_fpr,
    masked_mean_flow,
    tpr_fpr_counts,
)

__all__ = [
    "get_simple_bounding_box_device",
    "bgr_to_gray_host",
    "_tpr_fpr",
    "masked_mean_flow",
    "tpr_fpr_counts",
]
