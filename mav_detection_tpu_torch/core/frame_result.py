"""Per-frame detection result record.

Schema is identical to ``mav_detection_tpu.core.frame_result.FrameResult``
(itself the upstream project's ``FrameResult``), so downstream validation can
consume either package's ``results/image_*.json`` files interchangeably.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, Tuple


def _scalar(x: Any) -> Any:
    """Coerce numpy/torch scalars to plain Python for JSON round-tripping."""
    if hasattr(x, "item"):
        try:
            return x.item()
        except Exception:
            pass
    if isinstance(x, (tuple, list)):
        return [_scalar(v) for v in x]
    return x


@dataclass
class FrameResult:
    time: float = 0.0
    tpr: float = 0.0
    fpr: float = 0.0
    tpr_fixed: float = 0.0
    fpr_fixed: float = 0.0
    sky_tpr: float = 0.0
    sky_fpr: float = 0.0
    drone_size_pixels: float = 0.0
    drone_flow_pixels: Tuple[float, float] = (0.0, 0.0)
    foe_dense: Tuple[float, float] = (0.0, 0.0)
    foe_gt: Tuple[float, float] = (0.0, 0.0)
    center_phi: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "time": _scalar(self.time),
            "tpr": _scalar(self.tpr),
            "fpr": _scalar(self.fpr),
            "tpr_fixed": _scalar(self.tpr_fixed),
            "fpr_fixed": _scalar(self.fpr_fixed),
            "sky_tpr": _scalar(self.sky_tpr),
            "sky_fpr": _scalar(self.sky_fpr),
            "drone_size_pixels": _scalar(self.drone_size_pixels),
            "drone_flow_pixels": _scalar(list(self.drone_flow_pixels)),
            "foe_dense": _scalar(list(self.foe_dense)),
            "foe_gt": _scalar(list(self.foe_gt)),
            "center_phi": _scalar(self.center_phi),
        }

    def to_json(self) -> str:
        # indent=4 / sort_keys matches the upstream writer
        return json.dumps(self.to_dict(), indent=4, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FrameResult":
        fr = cls()
        fr.time = d.get("time", 0.0)
        fr.tpr = d.get("tpr", 0.0)
        fr.fpr = d.get("fpr", 0.0)
        fr.tpr_fixed = d.get("tpr_fixed", 0.0)
        fr.fpr_fixed = d.get("fpr_fixed", 0.0)
        fr.sky_tpr = d.get("sky_tpr", 0.0)
        fr.sky_fpr = d.get("sky_fpr", 0.0)
        fr.drone_size_pixels = d.get("drone_size_pixels", 0.0)
        fr.drone_flow_pixels = tuple(d.get("drone_flow_pixels", (0.0, 0.0)))
        fr.foe_dense = tuple(d.get("foe_dense", (0.0, 0.0)))
        gt = d.get("foe_gt", (0.0, 0.0))
        fr.foe_gt = tuple(gt) if gt is not None else (0.0, 0.0)
        fr.center_phi = d.get("center_phi", 0.0)
        return fr

    @classmethod
    def from_json_file(cls, path: str) -> "FrameResult":
        with open(path, "r") as f:
            return cls.from_dict(json.load(f))
