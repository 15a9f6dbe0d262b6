"""Depth-capture smoke test: ``python -m mav_detection_tpu_torch.cli.demo``
(``mav_detection_tpu.cli.demo``).

Connect to the simulator, print the observer's position, grab one depth
image, jet-colormap it with the 5x near-range scale and write ``test.png``:
hermetic by default (``MockSimClient``), or against a real AirSim / UE4
install with ``--airsim``. The PNG goes through the port's own codec
(``data/dataset.imwrite``, BGR as OpenCV writes it), the colours through the
port's ``apply_colormap``.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np


def run_demo(client, vehicle: str = "Drone1",
             out_path: str = "test.png") -> np.ndarray:
    """Capture one depth frame, colormap it, write it; returns the (h, w, 3)
    uint8 BGR image. The depth is normalised to the frame's max, scaled by 5
    (everything nearer than a fifth of the far plane uses the whole colour
    range), clipped to 255 and jet-mapped."""
    from mav_detection_tpu_torch.data.dataset import imwrite
    from mav_detection_tpu_torch.ops.image.visualize import apply_colormap

    client.confirm_connection()
    print(f"{vehicle} position: {client.get_position(vehicle)}")

    depth = None
    for resp in client.capture(vehicle):
        if resp.image_type == "depth":
            depth = np.asarray(resp.data, np.float32)
    if depth is None:
        raise RuntimeError("capture returned no depth image")

    scaled = depth / max(float(depth.max()), 1e-9) * 255.0 * 5.0
    vis = apply_colormap(np.clip(scaled, 0, 255).astype(np.uint8))
    imwrite(out_path, vis)
    print(f"wrote {out_path} ({vis.shape[1]}x{vis.shape[0]}, "
          f"depth range {depth.min():.1f}..{depth.max():.1f} m)")
    return vis


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="depth-capture smoke test")
    ap.add_argument("--airsim", action="store_true",
                    help="connect to a real AirSim/UE4 simulator over RPC "
                         "instead of the hermetic mock")
    ap.add_argument("--ip", default=None, help="AirSim RPC host")
    ap.add_argument("--vehicle", default="Drone1")
    ap.add_argument("--image-size", default="256x384", metavar="HxW",
                    help="mock renderer resolution")
    ap.add_argument("--out", default="test.png")
    args = ap.parse_args(argv)

    if args.airsim:
        from mav_detection_tpu_torch.sim.client import AirSimClient

        client = AirSimClient(ip=args.ip or os.environ.get("IP_ADDRESS"),
                              retry_forever=False)
    else:
        from mav_detection_tpu_torch.sim.client import MockSimClient, Vector3

        h, w = (int(v) for v in args.image_size.split("x"))
        client = MockSimClient(image_hw=(h, w))
        # lift the mock observer off the ground so the depth image has
        # structure (ground gradient + sky band), like a hovering drone
        client.set_pose(args.vehicle, Vector3(0.0, 0.0, -30.0), 0.0)
    run_demo(client, args.vehicle, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
