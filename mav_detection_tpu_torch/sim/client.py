"""Simulator client abstraction (a copy of ``mav_detection_tpu.sim.client``).

The choreography is written against a small ``SimClient`` interface with
two implementations:

* ``AirSimClient`` — thin adapter over the real ``airsim`` package (lazy
  import; raises a clear error when the package/simulator is unavailable).
* ``MockSimClient`` — a kinematic point-mass simulator with a pinhole-camera
  renderer. It integrates velocity commands, steps sim time, and synthesizes
  Scene/Depth/Segmentation captures (target drone rendered as a disc), so the
  entire data-collection stack runs hermetically in CI and produces
  pipeline-consumable sequences.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class Vector3:
    x_val: float = 0.0
    y_val: float = 0.0
    z_val: float = 0.0

    def __add__(self, o: "Vector3") -> "Vector3":
        return Vector3(self.x_val + o.x_val, self.y_val + o.y_val, self.z_val + o.z_val)

    def __sub__(self, o: "Vector3") -> "Vector3":
        return Vector3(self.x_val - o.x_val, self.y_val - o.y_val, self.z_val - o.z_val)

    def __mul__(self, s: float) -> "Vector3":
        return Vector3(self.x_val * s, self.y_val * s, self.z_val * s)

    def get_length(self) -> float:
        return math.sqrt(self.x_val ** 2 + self.y_val ** 2 + self.z_val ** 2)

    def to_numpy(self) -> np.ndarray:
        return np.array([self.x_val, self.y_val, self.z_val])


@dataclass
class ImageResponse:
    image_type: str            # "scene" | "depth" | "segmentation"
    pixels_as_float: bool
    data: np.ndarray           # (h, w[, 3]) uint8 or float32


class SimClient:
    """Interface consumed by the data-collection choreography."""

    def confirm_connection(self) -> None: ...
    def set_segmentation_ids(self) -> None: ...
    def enable_api_control(self, enable: bool, vehicle: str) -> None: ...
    def arm_disarm(self, arm: bool, vehicle: str) -> None: ...
    def get_position(self, vehicle: str) -> Vector3: ...
    def get_yaw(self, vehicle: str) -> float: ...
    def is_landed(self, vehicle: str) -> bool: ...
    def takeoff(self, vehicle: str) -> None: ...
    def set_pose(self, vehicle: str, position: Vector3, yaw: float) -> None: ...
    def move_to_position(self, vehicle: str, target: Vector3, speed: float) -> None: ...
    def move_by_velocity_z(self, vehicle: str, vx: float, vy: float, z: float,
                           yaw_deg: Optional[float] = None,
                           yaw_rate: Optional[float] = None) -> None: ...
    def land(self, vehicle: str) -> None: ...
    def continue_for_time(self, seconds: float) -> None: ...
    def pause(self, paused: bool) -> None: ...
    def capture(self, vehicle: str) -> List[ImageResponse]: ...
    def get_state(self, vehicle: str) -> Dict: ...
    def sim_time_ns(self) -> int: ...


# ---------------------------------------------------------------- AirSim
class AirSimClient(SimClient):
    """Adapter over the real airsim msgpack-RPC client."""

    def __init__(self, ip: Optional[str] = None, retry_forever: bool = True) -> None:
        try:
            import airsim  # type: ignore
        except ImportError as e:
            raise ImportError(
                "the 'airsim' package is not installed in this environment; "
                "use MockSimClient for hermetic data generation or install "
                "airsim where an UE4 simulator is reachable") from e
        self._airsim = airsim
        while True:
            try:
                self.client = airsim.MultirotorClient(ip=ip)
                self.client.confirmConnection()
                break
            except Exception:
                if not retry_forever:
                    raise
                time.sleep(1)

    def confirm_connection(self) -> None:
        self.client.confirmConnection()

    def set_segmentation_ids(self) -> None:
        self.client.simSetSegmentationObjectID("[\\w]*", 0, True)
        self.client.simSetSegmentationObjectID("Drone[\\w]*", 255, True)

    def enable_api_control(self, enable: bool, vehicle: str) -> None:
        self.client.enableApiControl(enable, vehicle)

    def arm_disarm(self, arm: bool, vehicle: str) -> None:
        self.client.armDisarm(arm, vehicle)

    def get_position(self, vehicle: str) -> Vector3:
        p = self.client.getMultirotorState(vehicle_name=vehicle).kinematics_estimated.position
        return Vector3(p.x_val, p.y_val, p.z_val)

    def get_yaw(self, vehicle: str) -> float:
        from scipy.spatial.transform import Rotation

        o = self.client.getMultirotorState(vehicle_name=vehicle).kinematics_estimated.orientation
        return float(Rotation.from_quat([o.x_val, o.y_val, o.z_val, o.w_val])
                     .as_euler("xyz")[2])

    def is_landed(self, vehicle: str) -> bool:
        return (self.client.getMultirotorState(vehicle_name=vehicle).landed_state
                == self._airsim.LandedState.Landed)

    def takeoff(self, vehicle: str) -> None:
        if self.is_landed(vehicle):
            self.client.takeoffAsync(vehicle_name=vehicle).join()

    def set_pose(self, vehicle: str, position: Vector3, yaw: float) -> None:
        a = self._airsim
        pose = a.Pose(a.Vector3r(position.x_val, position.y_val, position.z_val),
                      a.to_quaternion(0.0, 0.0, yaw))
        self.client.simSetVehiclePose(pose, True, vehicle_name=vehicle)

    def move_to_position(self, vehicle: str, target: Vector3, speed: float) -> None:
        self.client.moveToPositionAsync(target.x_val, target.y_val, target.z_val,
                                        speed, vehicle_name=vehicle).join()

    def move_by_velocity_z(self, vehicle: str, vx: float, vy: float, z: float,
                           yaw_deg: Optional[float] = None,
                           yaw_rate: Optional[float] = None) -> None:
        a = self._airsim
        if yaw_rate is not None:
            yaw_mode = a.YawMode(True, yaw_rate)
        elif yaw_deg is not None:
            yaw_mode = a.YawMode(False, yaw_deg)
        else:
            yaw_mode = a.YawMode()
        self.client.moveByVelocityZAsync(
            vx, vy, z, 10, a.DrivetrainType.MaxDegreeOfFreedom, yaw_mode,
            vehicle_name=vehicle)

    def land(self, vehicle: str) -> None:
        self.client.landAsync(vehicle_name=vehicle).join()

    def continue_for_time(self, seconds: float) -> None:
        self.client.simContinueForTime(seconds)

    def pause(self, paused: bool) -> None:
        self.client.simPause(paused)

    def capture(self, vehicle: str) -> List[ImageResponse]:
        a = self._airsim
        responses = self.client.simGetImages([
            a.ImageRequest("segment", a.ImageType.Segmentation),
            a.ImageRequest("high_res", a.ImageType.Scene),
            a.ImageRequest("depth", a.ImageType.DepthPerspective, True),
        ], vehicle_name=vehicle)
        out = []
        kind = {a.ImageType.Scene: "scene", a.ImageType.DepthPerspective: "depth",
                a.ImageType.Segmentation: "segmentation"}
        for r in responses:
            if r.pixels_as_float:
                data = np.array(a.get_pfm_array(r), np.float32)
            else:
                data = np.frombuffer(r.image_data_uint8, np.uint8)
                if r.height and r.width:
                    data = data.reshape(r.height, r.width, -1)
            out.append(ImageResponse(kind[r.image_type], r.pixels_as_float, data))
        return out

    def get_state(self, vehicle: str) -> Dict:
        state = self.client.getMultirotorState(vehicle_name=vehicle)
        imu = self.client.getImuData(imu_name="Imu", vehicle_name=vehicle)
        import json

        def jsonify(o):
            return json.loads(json.dumps(o, default=lambda x: getattr(x, "__dict__", str(x))))

        d = jsonify(state)
        d["imu"] = jsonify(imu)
        return d

    def sim_time_ns(self) -> int:
        return time.time_ns()


# ------------------------------------------------------------------ mock
@dataclass
class _Drone:
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    velocity: np.ndarray = field(default_factory=lambda: np.zeros(3))
    yaw: float = 0.0
    yaw_rate: float = 0.0
    landed: bool = True
    armed: bool = False
    target_z: Optional[float] = None


class MockSimClient(SimClient):
    """Kinematic two-drone simulator with a geometrically consistent pinhole
    renderer (hermetic CI).

    The renderer ray-casts a textured ground
    plane (world z = 0) and a direction-textured sky, records Euclidean
    depth (AirSim DepthPerspective semantics), and ``get_state`` emits a real
    ``ue4.viewProjectionMatrix`` (UE4 cm units, built by
    ``data.airsim_flow.pinhole_view_proj`` — the same projection the renderer
    uses), ``ue4.FoE`` and ``ue4.linearVelocity``. Captured frames, depths,
    and matrices are therefore mutually consistent: GT flow synthesized by
    ``data.airsim_flow.calculate_flow`` matches the rendered image motion,
    closing the fly -> states -> GT-flow -> detect loop without UE4.
    """

    def __init__(self, image_hw: Tuple[int, int] = (64, 96),
                 fov_deg: float = 90.0, seed: int = 0,
                 target_radius_m: float = 0.5) -> None:
        self.drones: Dict[str, _Drone] = {"Drone1": _Drone(), "Drone2": _Drone()}
        self.h, self.w = image_hw
        self.focal = (self.w / 2) / math.tan(math.radians(fov_deg) / 2)
        self.target_radius_m = target_radius_m
        self.time_s = 0.0
        self.paused = True
        self._rng = np.random.default_rng(seed)

    # -- connection/infra ------------------------------------------------
    def confirm_connection(self) -> None:
        pass

    def set_segmentation_ids(self) -> None:
        pass

    def enable_api_control(self, enable: bool, vehicle: str) -> None:
        pass

    def arm_disarm(self, arm: bool, vehicle: str) -> None:
        self.drones[vehicle].armed = arm

    # -- state -----------------------------------------------------------
    def get_position(self, vehicle: str) -> Vector3:
        p = self.drones[vehicle].position
        return Vector3(float(p[0]), float(p[1]), float(p[2]))

    def get_yaw(self, vehicle: str) -> float:
        return self.drones[vehicle].yaw

    def is_landed(self, vehicle: str) -> bool:
        return self.drones[vehicle].landed

    def takeoff(self, vehicle: str) -> None:
        d = self.drones[vehicle]
        d.landed = False
        d.position = d.position + np.array([0.0, 0.0, -1.5])

    def set_pose(self, vehicle: str, position: Vector3, yaw: float) -> None:
        d = self.drones[vehicle]
        d.position = position.to_numpy().astype(float)
        d.yaw = yaw
        d.velocity = np.zeros(3)

    def move_to_position(self, vehicle: str, target: Vector3, speed: float) -> None:
        self.drones[vehicle].position = target.to_numpy().astype(float)

    def move_by_velocity_z(self, vehicle: str, vx: float, vy: float, z: float,
                           yaw_deg: Optional[float] = None,
                           yaw_rate: Optional[float] = None) -> None:
        d = self.drones[vehicle]
        d.velocity = np.array([vx, vy, 0.0])
        d.target_z = z
        d.landed = False
        if yaw_deg is not None:
            d.yaw = math.radians(yaw_deg)
            d.yaw_rate = 0.0
        if yaw_rate is not None:
            d.yaw_rate = math.radians(yaw_rate)

    def land(self, vehicle: str) -> None:
        d = self.drones[vehicle]
        d.landed = True
        d.velocity = np.zeros(3)

    def continue_for_time(self, seconds: float) -> None:
        steps = max(int(seconds / 0.05), 1)
        dt = seconds / steps
        for _ in range(steps):
            for d in self.drones.values():
                if d.landed:
                    continue
                d.position = d.position + d.velocity * dt
                if d.target_z is not None:
                    d.position[2] += (d.target_z - d.position[2]) * min(1.0, 2 * dt)
                d.yaw += d.yaw_rate * dt
        self.time_s += seconds

    def pause(self, paused: bool) -> None:
        self.paused = paused

    # -- rendering -------------------------------------------------------
    def _project(self, observer: _Drone, point: np.ndarray) -> Optional[Tuple[float, float, float]]:
        """World point -> (px, py, depth) in the observer's camera, or None."""
        rel = point - observer.position
        cy, sy = math.cos(-observer.yaw), math.sin(-observer.yaw)
        # camera looks along +x of the body frame; z down (NED-ish)
        fwd = rel[0] * cy - rel[1] * sy
        right = rel[0] * sy + rel[1] * cy
        up = -rel[2]
        if fwd <= 0.1:
            return None
        px = self.w / 2 + self.focal * right / fwd
        py = self.h / 2 - self.focal * up / fwd
        return px, py, fwd

    _SKY_DEPTH_M = 1.0e4

    @staticmethod
    def _ground_texture(x: np.ndarray, y: np.ndarray,
                        gsd: np.ndarray) -> np.ndarray:
        """Procedural world-anchored ground albedo (smooth, trackable).

        ``gsd`` is the per-pixel ground sample distance (m/px): each sinusoid
        is Gaussian-attenuated by its wavenumber x gsd — mip-map style
        anti-aliasing, so distant ground stays photometrically consistent
        with the GT flow instead of shimmering (point-sampling a texture
        whose period drops below a pixel would alias)."""
        out = np.full(x.shape, 120.0)
        for amp, kx, ky, phase in ((55.0, 0.9, 0.7, 0.0),
                                   (30.0, 2.3, 1.1, 1.0),
                                   (18.0, 3.7, -2.9, 2.0),
                                   (12.0, 7.1, 6.3, 3.0)):
            att = np.exp(-0.5 * (kx * kx + ky * ky) * gsd * gsd)
            out = out + amp * att * np.sin(kx * x + ky * y + phase)
        return out

    @staticmethod
    def _sky_texture(az: np.ndarray, el: np.ndarray) -> np.ndarray:
        """Direction-anchored sky (bright; invariant to camera translation,
        consistent with the 'infinite' sky depth)."""
        return (200.0
                + 30.0 * np.sin(3.0 * az) * np.cos(5.0 * el)
                + 15.0 * np.sin(9.0 * az + 7.0 * el))

    def capture(self, vehicle: str) -> List[ImageResponse]:
        obs = self.drones[vehicle]
        other_name = "Drone2" if vehicle == "Drone1" else "Drone1"
        target = self.drones[other_name]
        h, w, f = self.h, self.w, self.focal

        # per-pixel world rays (same projection as _project / the VP matrix)
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        u = (xs - w / 2) / f                       # right coefficient
        v = (h / 2 - ys) / f                       # up coefficient
        cy, sy = math.cos(obs.yaw), math.sin(obs.yaw)
        fwd = np.array([cy, sy, 0.0])
        right = np.array([-sy, cy, 0.0])
        up = np.array([0.0, 0.0, -1.0])
        dirs = (fwd[None, None] + u[..., None] * right + v[..., None] * up)
        dir_norm = np.linalg.norm(dirs, axis=-1)

        # ray-cast the ground plane z = 0 (NED: camera z < 0 is above ground)
        dz = dirs[..., 2]
        with np.errstate(invalid="ignore", over="ignore"):
            t = np.where(dz > 1e-9, -obs.position[2] / np.maximum(dz, 1e-9),
                         np.inf)
            euclid = t * dir_norm
            is_ground = (t > 0) & (euclid < self._SKY_DEPTH_M)
            hit_x = obs.position[0] + t * dirs[..., 0]
            hit_y = obs.position[1] + t * dirs[..., 1]
        az = np.arctan2(dirs[..., 1], dirs[..., 0])
        el = np.arcsin(np.clip(-dirs[..., 2] / np.maximum(dir_norm, 1e-9), -1, 1))
        gsd = np.where(is_ground, euclid, 0.0) / f   # ground m per pixel
        scene = np.where(is_ground,
                         self._ground_texture(np.where(is_ground, hit_x, 0.0),
                                              np.where(is_ground, hit_y, 0.0),
                                              gsd),
                         self._sky_texture(az, el))
        depth = np.where(is_ground, euclid, self._SKY_DEPTH_M).astype(np.float32)
        seg = np.zeros((h, w), np.uint8)

        # target drone: textured disc, Euclidean center distance as depth
        proj = self._project(obs, target.position)
        if proj is not None:
            px, py, fwd_dist = proj
            dist = float(np.linalg.norm(target.position - obs.position))
            r = max(2.0, f * self.target_radius_m / max(fwd_dist, 0.5))
            dxp = xs - px
            dyp = ys - py
            mask = dxp ** 2 + dyp ** 2 <= r ** 2
            scene[mask] = (40.0 + 22.0 * np.sin(0.8 * dxp[mask])
                           * np.cos(0.8 * dyp[mask]))
            seg[mask] = 255
            depth[mask] = dist

        scene_rgb = np.repeat(np.clip(scene, 0, 255)[..., None], 3, -1).astype(np.uint8)
        seg_rgb = np.repeat(seg[..., None], 3, -1)
        return [
            ImageResponse("segmentation", False, seg_rgb),
            ImageResponse("scene", False, scene_rgb),
            ImageResponse("depth", True, depth),
        ]

    # -- state -----------------------------------------------------------
    def _view_proj(self, d: _Drone) -> np.ndarray:
        """UE4-convention VP matrix of this drone's camera (cm world units —
        the GT-flow path scales depth m->cm, reference airsim_optical_flow
        semantics)."""
        from mav_detection_tpu_torch.data.airsim_flow import pinhole_view_proj

        return pinhole_view_proj(d.position * 100.0, d.yaw, self.focal,
                                 (self.w, self.h))

    def _foe_normalized(self, d: _Drone) -> Tuple[float, float]:
        """Focus of expansion of this drone's own translation, in normalized
        image coordinates (UE4 state-dump convention, consumed by
        ``SimDataset.get_gt_foe``)."""
        cy, sy = math.cos(d.yaw), math.sin(d.yaw)
        fv = d.velocity[0] * cy + d.velocity[1] * sy
        rv = -d.velocity[0] * sy + d.velocity[1] * cy
        uv = -d.velocity[2]
        if abs(fv) < 1e-9:
            return 0.5, 0.5
        px = self.w / 2 + self.focal * rv / fv
        py = self.h / 2 - self.focal * uv / fv
        return px / self.w, py / self.h

    def get_state(self, vehicle: str) -> Dict:
        from mav_detection_tpu_torch.data.airsim_flow import format_view_proj

        d = self.drones[vehicle]
        half_yaw = d.yaw / 2
        foe = self._foe_normalized(d)
        return {
            "kinematics_estimated": {
                "position": {"x_val": d.position[0], "y_val": d.position[1],
                             "z_val": d.position[2]},
                "linear_velocity": {"x_val": d.velocity[0], "y_val": d.velocity[1],
                                    "z_val": d.velocity[2]},
            },
            "imu": {
                "time_stamp": self.sim_time_ns(),
                "orientation": {"x_val": 0.0, "y_val": 0.0,
                                "z_val": math.sin(half_yaw),
                                "w_val": math.cos(half_yaw)},
                "angular_velocity": {"x_val": 0.0, "y_val": 0.0, "z_val": d.yaw_rate},
            },
            # engine-side quantities: in real AirSim these arrive via the
            # UE4 state dumps that link_ue4_output joins in; the mock IS the
            # engine, so it emits them inline (same schema, sim_data.py /
            # airsim_flow.py consume either source)
            "ue4": {
                "viewProjectionMatrix": format_view_proj(self._view_proj(d)),
                "FoE": {"X": foe[0], "Y": foe[1]},
                "linearVelocity": {"X": d.velocity[0], "Y": d.velocity[1],
                                   "Z": d.velocity[2]},
            },
        }

    def sim_time_ns(self) -> int:
        return int(self.time_s * 1e9)
