"""Two-drone data-collection choreography (a copy of
``mav_detection_tpu.sim.control``, writing through the port's PNG and PFM
codecs).

The reference's flight/acquisition loop (``airsim-control.py``) re-expressed
against the ``SimClient`` interface: config-grid construction from
settings.json collections, the four flight patterns, the
step-pause-capture cycle, the target-visibility frame-drop heuristic, the
depth-buffer sanity check, per-frame vehicle-state JSON dumps, and the
post-hoc UE4-state timestamp join.

Unlike the reference, the choreography is simulator-agnostic — swap
``MockSimClient`` for ``AirSimClient`` and nothing else changes, which also
makes the whole acquisition stack testable in CI.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional

import numpy as np

from mav_detection_tpu_torch.data.dataset import create_if_not_exists, imwrite, write_pfm
from mav_detection_tpu_torch.sim.client import ImageResponse, SimClient, Vector3
from mav_detection_tpu_torch.sim.sim_config import FlightMode, Orientation, SimConfig

OBSERVER = "Drone1"
TARGET = "Drone2"


class SimDataCollector:
    def __init__(self, client: SimClient, collection: Dict[str, Any],
                 root_data_dir: str = "data", speed: float = 3.0,
                 max_iterations: int = 1000) -> None:
        self.client = client
        self.root_data_dir = root_data_dir
        self.speed = speed
        self.max_iterations = max_iterations
        self.iteration = 0
        self.timestamps: Dict[int, int] = {}
        self.minimum_segmentation_sum = float("inf")
        self.drone_in_frame_previous = False
        self.yaw_rate = 0.0  # deg/s
        self.max_yaw = np.deg2rad(30)
        self.base_dir = ""

        self.configs = self._build_grid(collection)
        create_if_not_exists(f"{self.root_data_dir}/states")

    # ------------------------------------------------------------- setup
    def _build_grid(self, collection: Dict[str, Any]) -> List[SimConfig]:
        """8-deep nested product over the collection axes
        (reference ``airsim-control.py:39-77``), skipping already-collected
        configurations (idempotent resume)."""
        orientations = [SimConfig.get_orientation(x) for x in collection["orientations"]]
        modes = [SimConfig.get_mode(x) for x in collection["modes"]]
        configs = []
        for sequence_name, center in collection["locations"].items():
            for orbit_speed in collection["orbit_speed"]:
                for gs_key, gs in collection["global_speed"].items():
                    for height_name, height in collection["heights"].items():
                        for orientation in orientations:
                            for radius in collection["radii"]:
                                for mode in modes:
                                    for angle in collection["collision_angles"]:
                                        cfg = SimConfig(
                                            sequence_name, height_name,
                                            Vector3(center["x"], center["y"],
                                                    center["z"] - height),
                                            orientation, radius, center["z"],
                                            orbit_speed,
                                            Vector3(gs["lin_x"], gs["sin_y"], gs["sin_z"]),
                                            gs_key, mode, angle)
                                        if not os.path.exists(self.get_base_dir(cfg)):
                                            configs.append(cfg)
        return configs

    def get_base_dir(self, config: SimConfig) -> str:
        return f"{self.root_data_dir}/{config}"

    # ----------------------------------------------------------- running
    def run(self) -> None:
        self.client.confirm_connection()
        self.client.set_segmentation_ids()
        for v in (OBSERVER, TARGET):
            self.client.enable_api_control(True, v)
            self.client.arm_disarm(True, v)
        try:
            for config in self.configs:
                self.prepare_run(config)
                self.fly_pattern(config)
                self.finish_sequence()
                for v in (OBSERVER, TARGET):
                    self.client.arm_disarm(False, v)
        finally:
            self.client.pause(False)

    def prepare_run(self, config: SimConfig) -> None:
        self.teleport(config)
        for v in (OBSERVER, TARGET):
            self.client.arm_disarm(True, v)
            self.client.takeoff(v)
        self.teleport(config)
        self.iteration = 0
        self.minimum_segmentation_sum = float("inf")
        self.drone_in_frame_previous = False

    def teleport(self, config: SimConfig) -> None:
        heading = np.deg2rad(config.orientation.heading_deg())
        self.client.set_pose(OBSERVER, config.get_start_position(True), heading)
        self.client.set_pose(TARGET, config.get_start_position(False), 0.0)

    def fly_pattern(self, config: SimConfig) -> None:
        self.base_dir = self.get_base_dir(config)
        self._prepare_sequence_dirs()
        if config.mode == FlightMode.ORBIT:
            self.fly_orbit(config)
        elif config.mode == FlightMode.COLLISION:
            self.fly_collision(config)
        elif config.mode == FlightMode.FOE_DEMO:
            self.fly_foe_demo(config)
        else:
            self.fly_straight(config)

    def _prepare_sequence_dirs(self) -> None:
        for d in ("images", "segmentations", "depths", "states"):
            create_if_not_exists(f"{self.base_dir}/{d}")

    # ------------------------------------------------------ flight modes
    def _step(self) -> None:
        """One sim-second step with paused capture (the reference's
        step-pause cadence, ``airsim-control.py:474-476``)."""
        self.client.continue_for_time(1.0)
        self.client.pause(True)

    def fly_orbit(self, config: SimConfig) -> None:
        lookahead = config.orbit_speed * np.pi / 180.0
        yaw_dir = 1.0
        base_heading = np.deg2rad(config.orientation.heading_deg())
        running = True
        while running and self.iteration < self.max_iterations:
            pt = self.client.get_position(TARGET)
            po = self.client.get_position(OBSERVER)
            dx, dy = pt.x_val - po.x_val, pt.y_val - po.y_val
            angle_to_center = math.atan2(dy, dx)
            camera_heading = np.rad2deg(angle_to_center - math.pi)
            lx = po.x_val + config.radius * math.cos(angle_to_center + lookahead)
            ly = po.y_val + config.radius * math.sin(angle_to_center + lookahead)
            self.client.move_by_velocity_z(
                TARGET, lx - pt.x_val + config.global_speed.x_val, ly - pt.y_val,
                po.z_val, yaw_deg=camera_heading)
            self.client.move_by_velocity_z(
                OBSERVER, config.global_speed.x_val, config.global_speed.y_val,
                config.center.z_val, yaw_rate=self.yaw_rate * yaw_dir)
            self._step()
            yaw_err = self.client.get_yaw(OBSERVER) - base_heading
            if abs(yaw_err) > self.max_yaw:
                yaw_dir = -math.copysign(1.0, yaw_err)
            self.capture(config)
            running = np.rad2deg(angle_to_center - base_heading) < 50
            self.iteration += 1

    def fly_collision(self, config: SimConfig) -> None:
        po = self.client.get_position(OBSERVER)
        z = po.z_val
        running = True
        while running and self.iteration < self.max_iterations:
            self._step()
            pt = self.client.get_position(TARGET)
            po = self.client.get_position(OBSERVER)
            for v in (OBSERVER, TARGET):
                direction = Vector3(config.center.x_val, config.center.y_val, z) - \
                    self.client.get_position(v)
                n = max(direction.get_length(), 1e-6)
                s = config.global_speed.x_val
                self.client.move_by_velocity_z(
                    v, direction.x_val / n * s, direction.y_val / n * s, z)
            if (pt - po).get_length() < 2:
                running = False
                self.client.pause(False)
            self.capture(config)
            self.iteration += 1

    def fly_foe_demo(self, config: SimConfig) -> None:
        while self.iteration < self.max_iterations:
            self.client.move_by_velocity_z(
                OBSERVER, config.global_speed.x_val, config.global_speed.y_val,
                config.center.z_val)
            self._step()
            self.capture(config)
            self.iteration += 1

    def fly_straight(self, config: SimConfig) -> None:
        running = True
        while running and self.iteration < self.max_iterations:
            pt = self.client.get_position(TARGET)
            po = self.client.get_position(OBSERVER)
            dx, dy = pt.x_val - po.x_val, pt.y_val - po.y_val
            camera_heading = np.rad2deg(math.atan2(dy, dx))
            # velocity factor compensating target drift (reference :411)
            vx = config.global_speed.x_val * 0.99333
            vy = config.orbit_speed * config.radius
            self.client.move_by_velocity_z(
                TARGET, vx, vy, po.z_val - 0.15 * config.radius,
                yaw_deg=camera_heading)
            self.client.move_by_velocity_z(
                OBSERVER, config.global_speed.x_val, config.global_speed.y_val,
                config.center.z_val, yaw_rate=self.yaw_rate)
            self._step()
            self.capture(config)
            running = pt.y_val < config.radius
            self.iteration += 1

    # ----------------------------------------------------------- capture
    def capture(self, config: SimConfig) -> None:
        responses = self.client.capture(OBSERVER)
        by_kind = {r.image_type: r for r in responses}

        seg = by_kind["segmentation"]
        seg_sum = float(np.sum(seg.data))
        self.minimum_segmentation_sum = min(self.minimum_segmentation_sum, seg_sum)
        drone_in_frame = (config.mode in (FlightMode.COLLISION, FlightMode.FOE_DEMO)
                          or (seg_sum > self.minimum_segmentation_sum
                              and self.iteration > 10))

        if drone_in_frame:
            imwrite(f"{self.base_dir}/segmentations/image_{self.iteration:05d}.png",
                    seg.data)
            imwrite(f"{self.base_dir}/images/image_{self.iteration:05d}.png",
                    by_kind["scene"].data)
            depth = by_kind["depth"].data
            if self.iteration > 10 and float(np.std(depth)) < 1e-6:
                raise ValueError(
                    f"depth buffer probably incorrect, std {np.std(depth)} too small")
            write_pfm(f"{self.base_dir}/depths/image_{self.iteration:05d}.pfm", depth)
            self.timestamps[self.iteration] = self.client.sim_time_ns()
            self.write_states()
        self.drone_in_frame_previous = drone_in_frame

    def write_states(self) -> None:
        result: Dict[str, Any] = {}
        for v in (OBSERVER, TARGET):
            result[v] = self.client.get_state(v)
        ts = self.client.sim_time_ns() // 1_000_000  # ms like the reference
        # zero-padded so lexical == numeric order (real AirSim ns-epoch
        # stamps are constant-width; mock ms stamps from t=0 are not)
        with open(f"{self.base_dir}/states/{ts:015d}.json", "w") as f:
            json.dump(result, f, indent=4, sort_keys=True)

    def finish_sequence(self) -> None:
        if self.timestamps:
            with open(f"{self.base_dir}/states/timestamps.json", "w") as f:
                json.dump({k: str(v) for k, v in self.timestamps.items()},
                          f, indent=4, sort_keys=True)
            self.timestamps = {}
        self.renormalize_indices()
        self.link_ue4_output()

    def renormalize_indices(self) -> None:
        """Re-index captured artifacts to consecutive image_%05d names: the
        visibility heuristic drops frames (orbit mode), and the dataset
        contract — in particular the GT-flow writer's image_{i}.pfm reads
        (``data/airsim_flow.py``) — expects gap-free indices (the reference
        renormalizes on dataset init instead, ``dataset.py:250-264``)."""
        import re

        for sub, ext in (("images", "png"), ("segmentations", "png"),
                         ("depths", "pfm")):
            d = f"{self.base_dir}/{sub}"
            if not os.path.isdir(d):
                continue
            files = sorted(f for f in os.listdir(d)
                           if re.fullmatch(rf"image_\d+[.]{ext}", f))
            for k, name in enumerate(files):
                target = f"image_{k:05d}.{ext}"
                if name != target:
                    # ascending rename: target index <= source index, and all
                    # smaller slots were already re-packed -> never collides
                    os.replace(os.path.join(d, name), os.path.join(d, target))

    def link_ue4_output(self) -> None:
        """Join UE4-side state dumps (written by the engine into
        data/states) into the per-frame state files by nearest timestamp
        (reference ``airsim-control.py:563-601``)."""
        in_dir = f"{self.root_data_dir}/states"
        out_dir = f"{self.base_dir}/states"

        def listed(d):
            files = sorted(f for f in os.listdir(d) if "timestamp" not in f)
            ts = np.array([int(os.path.basename(f).rstrip(".json")) for f in files])
            return [os.path.join(d, f) for f in files], ts

        in_files, in_ts = listed(in_dir)
        if not in_files:
            return
        out_files, out_ts = listed(out_dir)
        for out_file, ts in zip(out_files, out_ts):
            diffs = in_ts - ts
            sel = int(np.argmin(np.abs(diffs)))
            with open(out_file, "r") as f:
                result = json.load(f)
            with open(in_files[sel], "r") as f:
                ue4 = json.load(f)
            for v in (OBSERVER, TARGET):
                if v in ue4:
                    result[v]["ue4"] = ue4[v]
            result["thread_difference"] = int(diffs[sel])
            with open(out_file, "w") as f:
                json.dump(result, f, indent=4, sort_keys=True)


def main(argv: Optional[List[str]] = None) -> None:
    """Command-line entry mirroring the reference's data-acquisition tool
    (``airsim-control.py:618-627``): ``--collection`` selects a grid from
    settings.json. ``--mock`` swaps the AirSim RPC client for the hermetic
    mock simulator, so full collections can be flown without UE4 (the
    collected sequences feed ``SimDataset``'s GT-flow synthesis directly)."""
    import argparse

    from mav_detection_tpu_torch.core.config import load_settings

    ap = argparse.ArgumentParser(
        description="Two-drone data-collection choreography")
    ap.add_argument("--collection", required=True,
                    help="collection name under settings.json 'collections'")
    ap.add_argument("--mock", action="store_true",
                    help="use the hermetic mock simulator instead of AirSim")
    ap.add_argument("--ip", default=None,
                    help="AirSim RPC host (default: IP_ADDRESS env)")
    ap.add_argument("--data-dir", default="data", help="output root")
    ap.add_argument("--speed", type=float, default=3.0)
    ap.add_argument("--max-iterations", type=int, default=1000)
    ap.add_argument("--image-size", default=None, metavar="HxW",
                    help="mock-sim capture resolution, e.g. 1024x1920")
    args = ap.parse_args(argv)

    collections = load_settings().get("collections", {})
    if args.collection not in collections:
        raise SystemExit(
            f"unknown collection {args.collection!r}; available: "
            f"{sorted(collections)}")
    if args.mock:
        from mav_detection_tpu_torch.sim.client import MockSimClient

        hw = (tuple(int(v) for v in args.image_size.split("x"))
              if args.image_size else (64, 96))
        client: SimClient = MockSimClient(image_hw=hw)  # type: ignore[arg-type]
    else:
        from mav_detection_tpu_torch.sim.client import AirSimClient

        client = AirSimClient(ip=args.ip or os.environ.get("IP_ADDRESS"))
    SimDataCollector(client, collections[args.collection],
                     root_data_dir=args.data_dir, speed=args.speed,
                     max_iterations=args.max_iterations).run()
