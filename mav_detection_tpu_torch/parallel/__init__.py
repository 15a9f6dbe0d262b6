"""Multi-device paths of the port (``mav_detection_tpu.parallel``): one
process per device in a ``torch.distributed`` group."""
from mav_detection_tpu_torch.parallel.mesh import (
    Mesh,
    aggregate_metrics_psum,
    detect_frames_sharded,
    launch,
    make_mesh,
    shard_frame_batch,
)
from mav_detection_tpu_torch.parallel.spatial import farneback_flow_spatial

__all__ = [
    "Mesh",
    "aggregate_metrics_psum",
    "detect_frames_sharded",
    "farneback_flow_spatial",
    "launch",
    "make_mesh",
    "shard_frame_batch",
]
