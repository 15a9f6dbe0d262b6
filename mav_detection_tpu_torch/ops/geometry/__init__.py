from mav_detection_tpu_torch.ops.geometry.derotation import derotate, derotation_field
from mav_detection_tpu_torch.ops.geometry.foe import (
    foe_ransac,
    get_foe_dense,
    get_phi,
    line_intersections,
    sample_points,
)
from mav_detection_tpu_torch.ops.geometry.thresholds import (
    detection_masks,
    dynamic_angle_mask,
    fixed_angle_mask,
)

__all__ = [
    "derotate",
    "derotation_field",
    "foe_ransac",
    "get_foe_dense",
    "get_phi",
    "line_intersections",
    "sample_points",
    "detection_masks",
    "dynamic_angle_mask",
    "fixed_angle_mask",
]
