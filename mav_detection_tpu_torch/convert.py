"""Carry the reference's configuration state into the port.

The Farneback + FoE path has no learned weights: its state is the numpy
matrices (built by the copied builders in ``ops/flow/farneback.py``, bit
equal to the reference's) and the ``FarnebackParams`` / ``DetectionStep``
settings. These converters take the reference's settings as plain dicts
(``dataclasses.asdict(params)``, ``step._asdict()``) so one description
configures both packages. Checkpoint conversion for RAFT, SkyUNet and YOLO
comes with the slice that ports those nets.
"""
from __future__ import annotations

from typing import Any, Mapping

from mav_detection_tpu_torch.ops.flow.farneback import FarnebackParams
from mav_detection_tpu_torch.pipeline.detector import DetectionStep

# reference knobs that only pick a TPU lowering, not the result
_TPU_ONLY = ("band_rows", "pallas_halo")


def farneback_params_from_reference(d: Mapping[str, Any]) -> FarnebackParams:
    """The port's ``FarnebackParams`` for a reference ``FarnebackParams``
    given as a dict. The port runs the reference's fused-iteration algorithm
    (``warp="pallas"``, which refits every iteration); ``warp="separable"``
    without the ``fast`` schedule is the same algorithm. The exact-gather
    warps, the sparse refit schedule and reduced matmul precision are not
    ported and raise."""
    warp = d.get("warp", "gather")
    if warp not in ("pallas", "separable"):
        raise NotImplementedError(
            f"warp={warp!r}: only the fused-iteration algorithm (warp "
            "'pallas', or 'separable' without fast) is ported")
    if warp == "separable" and d.get("fast", False):
        raise NotImplementedError("the fast refit schedule is not ported")
    if d.get("precision", "highest") != "highest":
        raise NotImplementedError("the port runs every matmul in full fp32")
    known = set(FarnebackParams.__dataclass_fields__)
    unknown = set(d) - known - {"warp", "fast", "precision", *_TPU_ONLY}
    if unknown:
        raise ValueError(f"unknown FarnebackParams fields: {sorted(unknown)}")
    kw = {k: v for k, v in d.items() if k in known}
    if kw.get("level_iters") is not None:
        kw["level_iters"] = tuple(kw["level_iters"])
    return FarnebackParams(**kw)


def detection_step_from_reference(d: Mapping[str, Any]) -> DetectionStep:
    """The port's ``DetectionStep`` for a reference one given as a dict
    (``batch_mode`` picks a JAX vectorization and does not change results)."""
    if d.get("batch_mode", "vmap") not in ("vmap", "map"):
        raise ValueError(f"unknown batch_mode {d['batch_mode']!r}")
    return DetectionStep(foe_samples=int(d.get("foe_samples", 1000)))
