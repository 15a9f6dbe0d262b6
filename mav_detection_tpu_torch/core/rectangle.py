"""Axis-aligned rectangles with YOLO-format converters and IoU.

Copy of ``mav_detection_tpu.core.rectangle`` (numpy only): YOLO lines are
``"<obj_id> <cx> <cy> <w> <h>"`` with coordinates normalized to image size,
and IoU uses ``max(1.0, w*h)`` as the area floor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass
class Rectangle:
    topleft: Tuple[float, float]
    size: Tuple[float, float]

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_center(cls, center: Tuple[float, float], size: Tuple[float, float]) -> "Rectangle":
        return cls((center[0] - size[0] / 2, center[1] - size[1] / 2), size)

    @classmethod
    def from_points(cls, topleft: Tuple[float, float], bottomright: Tuple[float, float]) -> "Rectangle":
        return cls(topleft, (bottomright[0] - topleft[0], bottomright[1] - topleft[1]))

    @classmethod
    def from_yolo_input(cls, values: Sequence[float], img_size: np.ndarray) -> "Rectangle":
        """Parse one YOLO annotation line ``[obj, cx, cy, w, h]`` (normalized)."""
        img = np.asarray(img_size, dtype=np.float64)
        center = np.array([values[1], values[2]]) * img
        size = np.array([values[3], values[4]]) * img
        return cls.from_center((center[0], center[1]), (size[0], size[1]))

    @classmethod
    def from_yolo_output(cls, arr: Sequence[float]) -> "Rectangle":
        return cls((arr[0], arr[1]), (arr[2], arr[3]))

    # -- accessors ---------------------------------------------------------
    def get_topleft(self) -> Tuple[float, float]:
        return (self.topleft[0], self.topleft[1])

    def get_bottomright(self) -> Tuple[float, float]:
        return (self.topleft[0] + self.size[0], self.topleft[1] + self.size[1])

    def get_topleft_int(self) -> Tuple[int, int]:
        return (int(self.topleft[0]), int(self.topleft[1]))

    def get_bottomright_int(self) -> Tuple[int, int]:
        br = self.get_bottomright()
        return (int(br[0]), int(br[1]))

    def get_center(self) -> Tuple[float, float]:
        return (self.topleft[0] + self.size[0] / 2, self.topleft[1] + self.size[1] / 2)

    def get_center_int(self) -> Tuple[int, int]:
        c = self.get_center()
        return (int(c[0]), int(c[1]))

    def get_left(self) -> float:
        return self.topleft[0]

    def get_right(self) -> float:
        return self.topleft[0] + self.size[0]

    def get_top(self) -> float:
        return self.topleft[1]

    def get_bottom(self) -> float:
        return self.topleft[1] + self.size[1]

    def get_area(self) -> float:
        return max(1.0, self.size[0] * self.size[1])

    # -- YOLO format -------------------------------------------------------
    def to_yolo(self, img_size: np.ndarray, obj_id: int = 0) -> str:
        img = np.asarray(img_size, dtype=np.float64)
        center = np.array(self.get_center()) / img
        size = np.array(self.size) / img
        return f"{obj_id} {center[0]} {center[1]} {size[0]} {size[1]}\n"

    # -- metrics -----------------------------------------------------------
    @classmethod
    def calculate_iou(cls, r1: "Rectangle", r2: "Rectangle") -> float:
        """Upstream-exact IoU, INCLUDING its disjoint-box defect: when the
        boxes do not overlap both edge differences go negative and their
        product is a bogus positive "intersection". Kept for result parity;
        anything that *scores* with IoU must use :meth:`calculate_iou_safe`."""
        left = max(r1.get_left(), r2.get_left())
        right = min(r1.get_right(), r2.get_right())
        bottom = min(r1.get_bottom(), r2.get_bottom())
        top = max(r1.get_top(), r2.get_top())
        aoo = (right - left) * (bottom - top)
        aou = r1.get_area() + r2.get_area() - aoo
        return aoo / aou

    @classmethod
    def calculate_iou_safe(cls, r1: "Rectangle", r2: "Rectangle") -> float:
        """True IoU: 0 for disjoint boxes."""
        left = max(r1.get_left(), r2.get_left())
        right = min(r1.get_right(), r2.get_right())
        bottom = min(r1.get_bottom(), r2.get_bottom())
        top = max(r1.get_top(), r2.get_top())
        if right <= left or bottom <= top:
            return 0.0
        aoo = (right - left) * (bottom - top)
        return aoo / (r1.get_area() + r2.get_area() - aoo)


def parse_yolo_annotation(path: str, img_size: np.ndarray, min_area: float = 1.0) -> List[Rectangle]:
    """Read a YOLO ``.txt`` annotation file into rectangles, dropping
    degenerate (area <= ``min_area``) boxes as upstream does."""
    result: List[Rectangle] = []
    with open(path, "r") as f:
        for line in f.readlines():
            stripped = line.strip()
            if not stripped:
                continue
            values = [float(x) for x in stripped.split(" ")]
            rect = Rectangle.from_yolo_input(values, img_size)
            if rect.get_area() > min_area:
                result.append(rect)
    return result
