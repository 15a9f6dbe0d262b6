"""Simulation flight configuration (a copy of
``mav_detection_tpu.sim.sim_config``).

Behavioral contract of the reference's ``sim_config.py``: N/E/S/W headings,
flight modes {orbit, collision, line, foe_demo}, the name-mangled output
directory scheme, and per-mode start-position geometry — without the airsim
package dependency (vectors are plain dataclasses from ``sim.client``).
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np

from mav_detection_tpu_torch.sim.client import Vector3


class Orientation(Enum):
    NORTH = 0
    EAST = 1
    SOUTH = 2
    WEST = 3

    def __str__(self) -> str:
        return self.name.lower()

    def heading_deg(self) -> float:
        return {"NORTH": 0.0, "EAST": 90.0, "SOUTH": 180.0, "WEST": 270.0}[self.name]


class FlightMode(Enum):
    ORBIT = 0
    COLLISION = 1
    LINE = 2
    FOE_DEMO = 3

    def __str__(self) -> str:
        return self.name.lower()


def _parse(enum_cls, key: str):
    k = key.upper()
    options = [m.name for m in enum_cls]
    if k not in options:
        raise ValueError(
            f"{key} is not a valid {enum_cls.__name__}, has to be one of {', '.join(options)}")
    return enum_cls[k]


@dataclass
class SimConfig:
    base_name: str
    height_name: str
    center: Vector3
    orientation: Orientation
    radius: float
    ground_height: float
    orbit_speed: float
    global_speed: Vector3
    global_speed_name: str
    mode: FlightMode
    collision_angle: float

    @classmethod
    def get_mode(cls, key: str) -> FlightMode:
        return _parse(FlightMode, key)

    @classmethod
    def get_orientation(cls, key: str) -> Orientation:
        return _parse(Orientation, key)

    def __str__(self) -> str:
        return (f"{self.base_name}-{self.mode}-{self.collision_angle}-"
                f"{self.orientation}-{self.height_name}-{self.radius}-"
                f"{self.orbit_speed}-{self.global_speed_name}")

    # change detection between consecutive grid entries
    def is_different_location(self, other: "SimConfig") -> bool:
        return self.base_name != other.base_name or self.mode == FlightMode.COLLISION

    def is_different(self, other: "SimConfig") -> bool:
        return (self.is_different_location(other)
                or self.orientation != other.orientation
                or self.height_name != other.height_name
                or self.radius != other.radius
                or self.orbit_speed != other.orbit_speed
                or self.global_speed != other.global_speed)

    def get_start_position(self, is_observer: bool) -> Vector3:
        """Per-mode start geometry (reference ``sim_config.py:107-125``)."""
        if self.mode == FlightMode.ORBIT:
            if is_observer:
                return self.center
            heading = np.deg2rad(self.orientation.heading_deg() - 70)
            return self.center + Vector3(np.cos(heading), np.sin(heading), 0.0) * self.radius
        if self.mode == FlightMode.COLLISION:
            if is_observer:
                heading = np.deg2rad(self.orientation.heading_deg() + 180)
            else:
                heading = np.deg2rad(self.orientation.heading_deg() + self.collision_angle)
            return self.center + Vector3(np.cos(heading), np.sin(heading), 0.0) * self.radius
        if is_observer:
            return self.center
        return self.center + Vector3(1.0, -1.0, 0.15) * self.radius
