from mav_detection_tpu_torch.ops.flow.farneback import (
    FarnebackParams,
    effective_fused_config,
    farneback_flow,
    farneback_flow_batch,
    jacobi_level,
    solve_flow,
    tuned_flow_params,
    update_matrices,
)
from mav_detection_tpu_torch.ops.flow.farneback_iter import (
    farneback_iterate,
    farneback_iterate_ref,
)

__all__ = [
    "FarnebackParams",
    "effective_fused_config",
    "farneback_flow",
    "farneback_flow_batch",
    "jacobi_level",
    "solve_flow",
    "tuned_flow_params",
    "update_matrices",
    "farneback_iterate",
    "farneback_iterate_ref",
]
