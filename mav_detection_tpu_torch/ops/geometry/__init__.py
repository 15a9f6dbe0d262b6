from mav_detection_tpu_torch.ops.geometry.derotation import derotate, derotation_field
from mav_detection_tpu_torch.ops.geometry.foe import (
    TraceState,
    foe_ransac,
    get_foe_dense,
    get_foe_sparse,
    get_foe_sparse_traced,
    get_phi,
    line_intersections,
    sample_points,
    trace_init,
    trace_update,
)
from mav_detection_tpu_torch.ops.geometry.global_motion import (
    affine_motion_field,
    homography_motion_field,
    subtract_global_motion,
)
from mav_detection_tpu_torch.ops.geometry.kmeans import cluster_image, kmeans
from mav_detection_tpu_torch.ops.geometry.ransac_fits import (
    decompose_essential,
    fit_affine_ransac,
    fit_essential_ransac,
    fit_fundamental_ransac,
    fit_homography_lstsq,
    fit_homography_ransac,
    rotation_matrix_to_euler,
)
from mav_detection_tpu_torch.ops.geometry.thresholds import (
    detection_masks,
    dynamic_angle_mask,
    fixed_angle_mask,
)
from mav_detection_tpu_torch.ops.geometry.warp import (
    remap_bilinear,
    warp_affine,
    warp_perspective,
)

__all__ = [
    "derotate",
    "derotation_field",
    "TraceState",
    "foe_ransac",
    "get_foe_dense",
    "get_foe_sparse",
    "get_foe_sparse_traced",
    "get_phi",
    "line_intersections",
    "sample_points",
    "trace_init",
    "trace_update",
    "affine_motion_field",
    "homography_motion_field",
    "subtract_global_motion",
    "cluster_image",
    "kmeans",
    "decompose_essential",
    "fit_affine_ransac",
    "fit_essential_ransac",
    "fit_fundamental_ransac",
    "fit_homography_lstsq",
    "fit_homography_ransac",
    "rotation_matrix_to_euler",
    "detection_masks",
    "dynamic_angle_mask",
    "fixed_angle_mask",
    "remap_bilinear",
    "warp_affine",
    "warp_perspective",
]
