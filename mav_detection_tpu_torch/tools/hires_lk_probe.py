"""Probe: Lucas-Kanade at the reference's 1920x1024 AirSim resolution.

The port of ``tools/hires_lk_probe.py``. On the hires bench scene it
measures both products of the LK path:

* the sparse tracks the FoE consumes: Shi-Tomasi corners (``--corners``,
  quality 0.05) tracked by pyramidal LK; the tracks that survive, and the
  EPE of their displacements against the analytic GT at each corner (mean
  and 90th percentile);
* the densified field of ``--flow-source LUCAS_KANADE``
  (``lk_dense_flow``): the EPE against GT on the 16-px interior, and ms per
  frame at each batch of ``--batches`` (CUDA events around the frames'
  calls: the port's LK takes one frame pair a call, in place of the tool's
  vmap)::

    python -m mav_detection_tpu_torch.tools.hires_lk_probe [--batches 1,8]
        [--corners 2000] [--size 1024x1920]

``--device cpu`` (the tool's ``--cpu``) times on the host clock (one
repetition).
"""
from __future__ import annotations

import numpy as np
import torch

from mav_detection_tpu_torch.ops.flow.lucas_kanade import (
    lk_dense_flow,
    lucas_kanade_track,
    shi_tomasi_corners,
)
from mav_detection_tpu_torch.tools.common import HIRES_HW, dumps, epe, hw, ints, parser, scene
from mav_detection_tpu_torch.utils.device import resolve_device
from mav_detection_tpu_torch.utils.timing import device_name, eager_ms

REPS = 3


def track_errors(g0: torch.Tensor, g1: torch.Tensor, gt: np.ndarray, corners: int):
    """(tracked displacement EPE vs GT at each surviving corner, the
    surviving corners (x, y)): Shi-Tomasi then pyramidal LK."""
    h, w = gt.shape[:2]
    c = shi_tomasi_corners(g0, max_corners=corners, quality_level=0.05)
    t = lucas_kanade_track(g0, g1, c.points)
    ok = (c.valid & t.status).cpu().numpy()
    pts = c.points.cpu().numpy()[ok]
    disp = (t.points - c.points).cpu().numpy()[ok]
    gt_at = gt[np.clip(pts[:, 1].astype(int), 0, h - 1), np.clip(pts[:, 0].astype(int), 0, w - 1)]
    return np.linalg.norm(disp - gt_at, axis=-1), pts


def main(argv=None, device=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--batches", default="1,8")
    ap.add_argument("--corners", type=int, default=2000,
                    help="Shi-Tomasi budget (the reference's maxCorners=2000)")
    ap.add_argument("--size", type=hw, default=HIRES_HW, metavar="HxW")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    reps = REPS if dev.type == "cuda" else 1
    h, w = args.size
    prev8, curr8, gt = scene(h, w, hires=True)
    name = device_name(dev)
    print(f"device={name} {w}x{h} max |gt| {np.abs(gt).max():.1f} px corners={args.corners}")
    g0 = torch.as_tensor(prev8, dtype=torch.float32).to(dev)
    g1 = torch.as_tensor(curr8, dtype=torch.float32).to(dev)

    err, _ = track_errors(g0, g1, gt, args.corners)
    res = {"device": name, "size": f"{w}x{h}", "corners": args.corners,
           "tracks": int(err.size),
           "track_epe_mean": float(err.mean()) if err.size else None,
           "track_epe_p90": float(np.quantile(err, 0.9)) if err.size else None}
    print(dumps({k: res[k] for k in ("tracks", "track_epe_mean", "track_epe_p90")}))
    dense = lk_dense_flow(g0, g1, max_corners=args.corners)
    res["dense_epe_gt"] = epe(dense.cpu().numpy(), gt)
    print(dumps({"dense_epe_gt": res["dense_epe_gt"]}))

    res["batches"] = []
    for b in ints(args.batches):
        pb, cb = g0.repeat(b, 1, 1), g1.repeat(b, 1, 1)
        ms = eager_ms(lambda: [lk_dense_flow(pb[i], cb[i], max_corners=args.corners)
                               for i in range(b)], dev, reps, warm=1) / b
        row = {"batch": b, "ms_per_frame": ms, "fps": 1e3 / ms,
               "clock": "cuda events" if dev.type == "cuda" else "host (cpu)"}
        res["batches"].append(row)
        print(dumps(row))
    print(dumps(res))
    return res


if __name__ == "__main__":
    main()
