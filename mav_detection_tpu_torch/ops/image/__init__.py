from mav_detection_tpu_torch.ops.image.boxes import get_simple_bounding_box_device
from mav_detection_tpu_torch.ops.image.color import (
    bgr_to_gray,
    bgr_to_gray_host,
    rgb_to_gray,
)
from mav_detection_tpu_torch.ops.image.metrics import (
    _tpr_fpr,
    get_magnitude,
    get_rho,
    masked_mean_flow,
    tpr_fpr_counts,
)
from mav_detection_tpu_torch.ops.image.resize import resize, resize_percent
from mav_detection_tpu_torch.ops.image.visualize import (
    apply_colormap,
    colorbar_image,
    colorwheel_image,
    flow_radial_device,
    flow_to_color,
    flow_to_color_device,
    to_int,
    to_rgb,
)

__all__ = [
    "get_simple_bounding_box_device",
    "bgr_to_gray",
    "bgr_to_gray_host",
    "rgb_to_gray",
    "_tpr_fpr",
    "get_magnitude",
    "get_rho",
    "masked_mean_flow",
    "tpr_fpr_counts",
    "resize",
    "resize_percent",
    "apply_colormap",
    "colorbar_image",
    "colorwheel_image",
    "flow_radial_device",
    "flow_to_color",
    "flow_to_color_device",
    "to_int",
    "to_rgb",
]
