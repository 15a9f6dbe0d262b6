"""Carry the reference's configuration state into the port.

The Farneback + FoE path has no learned weights: its state is the numpy
matrices (built by the copied builders in ``ops/flow/farneback.py``, bit
equal to the reference's) and the ``FarnebackParams`` / ``DetectionStep``
settings. These converters take the reference's settings as plain dicts
(``dataclasses.asdict(params)``, ``step._asdict()``) so one description
configures both packages. The carried state of the sparse path (the trace
ring, the flow history, the feature pool, corners and tracks) crosses as
dicts of numpy arrays (``{k: np.asarray(v) for k, v in state._asdict()
.items()}`` on the reference's side, ``state_to_numpy`` on the port's).
Checkpoint conversion for RAFT, SkyUNet and YOLO comes when those nets are
ported.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Union

import numpy as np
import torch

from mav_detection_tpu_torch.ops.flow.farneback import FarnebackParams
from mav_detection_tpu_torch.ops.flow.lucas_kanade import (
    Corners,
    FeaturePool,
    TrackResult,
)
from mav_detection_tpu_torch.ops.geometry.boxsearch import FlowHistory
from mav_detection_tpu_torch.ops.geometry.foe import TraceState
from mav_detection_tpu_torch.pipeline.detector import DetectionStep

# reference knobs that only pick a TPU lowering, not the result
_TPU_ONLY = ("band_rows", "pallas_halo")


def farneback_params_from_reference(d: Mapping[str, Any]) -> FarnebackParams:
    """The port's ``FarnebackParams`` for a reference ``FarnebackParams``
    given as a dict. ``warp`` and ``fast`` carry over, the reference's
    ``warp="pallas"`` under the port's name for the fused iteration,
    ``"fused"``; the TPU lowering knobs are dropped. Reduced matmul precision
    is not ported and raises."""
    if d.get("precision", "highest") != "highest":
        raise NotImplementedError("the port runs every matmul in full fp32")
    known = set(FarnebackParams.__dataclass_fields__)
    unknown = set(d) - known - {"precision", *_TPU_ONLY}
    if unknown:
        raise ValueError(f"unknown FarnebackParams fields: {sorted(unknown)}")
    kw = {k: v for k, v in d.items() if k in known}
    if kw.get("warp") == "pallas":
        kw["warp"] = "fused"
    if kw.get("level_iters") is not None:
        kw["level_iters"] = tuple(kw["level_iters"])
    return FarnebackParams(**kw)


def detection_step_from_reference(d: Mapping[str, Any]) -> DetectionStep:
    """The port's ``DetectionStep`` for a reference one given as a dict
    (``batch_mode`` picks a JAX vectorization and does not change results)."""
    if d.get("batch_mode", "vmap") not in ("vmap", "map"):
        raise ValueError(f"unknown batch_mode {d['batch_mode']!r}")
    return DetectionStep(foe_samples=int(d.get("foe_samples", 1000)))


# ------------------------------------------------- carried state, as numpy
Device = Union[str, torch.device]


def _tensor(d: Mapping[str, Any], key: str, dtype: torch.dtype,
            device: Device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(d[key]), device=device).to(dtype)


def state_to_numpy(state: NamedTuple) -> Dict[str, np.ndarray]:
    """Any of the port's state tuples as a dict of numpy arrays, with the
    reference's field names."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in state._asdict().items()}


def trace_state_from_reference(d: Mapping[str, Any],
                               device: Device = "cpu") -> TraceState:
    return TraceState(
        positions=_tensor(d, "positions", torch.float32, device),
        alive=_tensor(d, "alive", torch.bool, device),
        age=_tensor(d, "age", torch.int32, device),
        head=int(np.asarray(d["head"])))


def flow_history_from_reference(d: Mapping[str, Any],
                                device: Device = "cpu") -> FlowHistory:
    return FlowHistory(buffer=_tensor(d, "buffer", torch.float32, device),
                       index=int(np.asarray(d["index"])))


def feature_pool_from_reference(d: Mapping[str, Any],
                                device: Device = "cpu") -> FeaturePool:
    return FeaturePool(points=_tensor(d, "points", torch.float32, device),
                       valid=_tensor(d, "valid", torch.bool, device))


def corners_from_reference(d: Mapping[str, Any],
                           device: Device = "cpu") -> Corners:
    return Corners(points=_tensor(d, "points", torch.float32, device),
                   valid=_tensor(d, "valid", torch.bool, device),
                   response=_tensor(d, "response", torch.float32, device))


def track_result_from_reference(d: Mapping[str, Any],
                                device: Device = "cpu") -> TrackResult:
    return TrackResult(points=_tensor(d, "points", torch.float32, device),
                       status=_tensor(d, "status", torch.bool, device),
                       error=_tensor(d, "error", torch.float32, device))
