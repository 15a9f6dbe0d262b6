"""What the flow tools share: argument parsing, the bench scenes, the EPE
against GT and an oracle, and strict JSON.

The tools write strict JSON: a number the run could not take is ``null``,
never ``NaN`` (``json.dumps`` would print the bare token ``NaN``, which is
not JSON).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from mav_detection_tpu_torch.data.scene import (
    bench_scene,
    epe_interior,
    hires_scene_kwargs,
    make_scene,
)

HIRES_HW = (1024, 1920)
BENCH_HW = (480, 752)


def strict(obj):
    """``obj`` with every non-finite float replaced by None and numpy
    scalars and arrays turned into Python numbers and lists."""
    if isinstance(obj, dict):
        return {str(k): strict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [strict(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return strict(obj.tolist())
    if isinstance(obj, (np.floating, float)):
        v = float(obj)
        return v if math.isfinite(v) else None
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    return obj


def dumps(obj) -> str:
    """One line of strict JSON."""
    return json.dumps(strict(obj), allow_nan=False)


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the port's ``--device`` (the card by
    default; ``cpu`` runs the plain versions on the host clock)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return ap


def hw(text: str) -> Tuple[int, int]:
    """``"HxW"`` -> (H, W)."""
    h, w = (int(v) for v in text.lower().split("x"))
    return h, w


def ints(text: str) -> list:
    """``"1,4"`` -> [1, 4]."""
    return [int(v) for v in text.split(",") if v.strip()]


def scene(h: int, w: int, hires: bool):
    """(prev8, curr8, gt_flow) of the bench scene at (h, w): the reference
    resolution's scene (``hires_scene_kwargs``) with ``hires``, else the
    752x480 scene (``make_scene(0)``) scaled to the frame as
    ``data.scene.bench_scene`` scales it (the two are one at 752x480)."""
    if hires:
        return make_scene(0, h=h, w=w, **hires_scene_kwargs(h, w))
    if (h, w) == BENCH_HW:
        return make_scene(0)
    return bench_scene(0, h, w)[:3]


def oracle_flow(oracle, shape: Sequence[int]) -> Optional[np.ndarray]:
    """The oracle's (h, w, 2) flow: an array, a ``.npy`` path, or None (the
    package computes no cv2 flow itself: the caller passes the reference's
    ``cv2.calcOpticalFlowFarneback`` result in)."""
    if oracle is None:
        return None
    flow = np.load(oracle) if isinstance(oracle, str) else np.asarray(oracle)
    if flow.shape != tuple(shape):
        raise ValueError(f"oracle flow of shape {flow.shape}, expected {tuple(shape)}")
    return flow.astype(np.float32)


def epe(flow, ref) -> Optional[float]:
    """Mean EPE on the 16-px interior (bench.py's gate); None without
    ``ref``."""
    return None if ref is None else epe_interior(np.asarray(flow), ref)


def fmt(v, spec: str = ".4f") -> str:
    return "null" if v is None else format(v, spec)


def flow_detect_ms(prev8: np.ndarray, curr8: np.ndarray, batch: int, params, dev,
                   reps: int = 5) -> dict:
    """ms per frame of ``batch`` copies of the pair through the bench's step
    (``bench.make_step``): ``"ms"`` the batched flow, then
    ``detect_frame_batch_scalars`` on ``bench.py``'s inputs; ``"flow_ms"``
    the flow alone; both CUDA events on a card, the host clock on the CPU.
    And ``"flow_device_ms"``, the flow's device time from a replayed CUDA
    graph (the host clock on the CPU)."""
    from mav_detection_tpu_torch.bench import make_step
    from mav_detection_tpu_torch.utils.timing import eager_ms, kernel_ms

    flow, both = make_step(prev8, curr8, batch, params, dev)
    return {"flow_ms": eager_ms(flow, dev, reps) / batch, "ms": eager_ms(both, dev, reps) / batch,
            "flow_device_ms": kernel_ms(flow, dev, reps) / batch}


def masked_epe(flow, gt: np.ndarray, mask: np.ndarray) -> float:
    """Mean end-point error of (h, w, 2) ``flow`` against ``gt`` over
    ``mask``."""
    return float(np.linalg.norm(np.asarray(flow) - gt, axis=-1)[mask].mean())


def best_iou(boxes, gt_rect, sx: float = 1.0, sy: float = 1.0) -> float:
    """The best IoU (``Rectangle.calculate_iou_safe``) against ``gt_rect``
    of the valid boxes of a host ``Boxes`` (centre xywh), scaled by (sx,
    sy); 0 without a valid box."""
    from mav_detection_tpu_torch.core.rectangle import Rectangle

    best = 0.0
    for j in np.flatnonzero(np.asarray(boxes.valid)):
        x, y, bw, bh = np.asarray(boxes.xywh[j])
        rect = Rectangle(((x - bw / 2) * sx, (y - bh / 2) * sy), (bw * sx, bh * sy))
        best = max(best, Rectangle.calculate_iou_safe(rect, gt_rect))
    return float(best)


def mean_or_none(values) -> Optional[float]:
    """The mean of ``values``, None for none (the reference tools' rule)."""
    return float(sum(values) / len(values)) if values else None


@contextlib.contextmanager
def simdata_path(root: str):
    """``SIMDATA_PATH`` set to ``root`` for the block, then restored."""
    before = os.environ.get("SIMDATA_PATH")
    os.environ["SIMDATA_PATH"] = root
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("SIMDATA_PATH", None)
        else:
            os.environ["SIMDATA_PATH"] = before
