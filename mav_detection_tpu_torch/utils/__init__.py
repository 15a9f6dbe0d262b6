from mav_detection_tpu_torch.utils.device import resolve_device
from mav_detection_tpu_torch.utils.tracing import Tracer, trace_to

__all__ = ["resolve_device", "Tracer", "trace_to"]
