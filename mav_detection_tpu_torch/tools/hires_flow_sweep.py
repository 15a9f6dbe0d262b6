"""Sweep: Farneback's algorithmic axes at the reference's 1920x1024.

The port of ``tools/hires_flow_sweep.py``. The tool swept the Pallas
kernel's layout (``band_rows``, halo layout, column tiling) with the
algorithm; those are TPU-only knobs with no counterpart here, so only the
algorithmic axes are swept: ``--levels`` x ``--max-shift``, with
pyr_scale 0.5 and 6 iterations on the fused kernel. On the hires bench
scene, per point: the EPE on the 16-px interior against the analytic GT
(the gate, < 0.55 px: cv2 with a full pyramid floors near 0.48 px on this
scene, so the single-level cv2 oracle is recorded for information only)
and against the oracle (``--oracle PATH.npy`` or ``main(..., oracle=...)``,
the reference's ``cv2.calcOpticalFlowFarneback(..., 0.4, 1, 12, 10, 8, 1.2,
0)``; ``null`` without it); then, for the points inside the gate, ms per
frame of flow + detection at ``--batch`` copies of the pair as the bench
times it (``bench.gpu_ms_per_frame``: a replayed CUDA graph of the step,
``ms_b*``, with the same step eager beside it, ``eager_ms_b*``), of the
flow alone (CUDA events) and the flow's device time (a replayed CUDA
graph), and a table ranked by the last batch's flow + detection time. The
tool's cv2-on-the-CPU baseline has no counterpart (the package runs no
cv2)::

    python -m mav_detection_tpu_torch.tools.hires_flow_sweep [--batch 1,4]
        [--levels 2,3] [--max-shift 8,16] [--quick] [--oracle cv2.npy]

``--device cpu`` times on the host clock.
"""
from __future__ import annotations

import itertools

import numpy as np

from mav_detection_tpu_torch.bench import gpu_ms_per_frame
from mav_detection_tpu_torch.ops.flow import farneback_iter as fi
from mav_detection_tpu_torch.ops.flow.farneback import FarnebackParams, farneback_flow
from mav_detection_tpu_torch.tools.common import (
    HIRES_HW,
    dumps,
    epe,
    flow_detect_ms,
    fmt,
    hw,
    ints,
    oracle_flow,
    parser,
    scene,
)
from mav_detection_tpu_torch.utils.device import resolve_device
from mav_detection_tpu_torch.utils.timing import device_name

EPE_GT_GATE_PX = 0.55


def point_params(levels: int, shift: int) -> FarnebackParams:
    return FarnebackParams(levels=levels, pyr_scale=0.5, warp="fused", iterations=6,
                           max_shift=shift)


def main(argv=None, device=None, oracle=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--batch", default="1,4", help="comma-separated batch sizes to time")
    ap.add_argument("--max-shift", default="8,16")
    ap.add_argument("--levels", default="2,3")
    ap.add_argument("--quick", action="store_true", help="batch 1 only")
    ap.add_argument("--size", type=hw, default=HIRES_HW, metavar="HxW",
                    help="the hires scene at another frame size")
    ap.add_argument("--oracle", default=None, help=".npy of the cv2 oracle's flow")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    h, w = args.size
    prev8, curr8, gt = scene(h, w, hires=True)
    ref = oracle_flow(oracle if oracle is not None else args.oracle, gt.shape)
    name = device_name(dev)
    print(f"scene {w}x{h} on {name}: max |gt flow| {np.abs(gt).max():.1f} px; band_rows, "
          f"halo and column tiling: TPU-only knobs, no counterpart; cv2-CPU baseline: "
          f"no counterpart")
    if ref is not None:
        print(f"cv2 oracle (single-level, the reference call) EPE vs GT: "
              f"{epe(ref, gt):.4f} px")
    batches = [1] if args.quick else ints(args.batch)

    points = []
    for levels, shift in itertools.product(ints(args.levels), ints(args.max_shift)):
        p = point_params(levels, shift)
        fi.reset_launch_counts()
        ours = farneback_flow(prev8, curr8, p, dev).cpu()
        pt = {"levels": levels, "max_shift": shift, "epe_gt": epe(ours, gt),
              "epe_cv2": epe(ours, ref),
              "launches_per_pair": fi.LAUNCHES["farneback_iterate_fused"]}
        pt["gate_pass"] = pt["epe_gt"] < EPE_GT_GATE_PX
        print(f"levels={levels} shift={shift}: EPE vs GT {pt['epe_gt']:.4f} px "
              f"(vs single-level cv2 {fmt(pt['epe_cv2'])} px)"
              + ("" if pt["gate_pass"] else f": EPE GATE FAIL (>= {EPE_GT_GATE_PX})"))
        if pt["gate_pass"]:
            for b in batches:
                g = gpu_ms_per_frame(prev8, curr8, b, p, dev)
                pt[f"ms_b{b}"], pt[f"eager_ms_b{b}"] = g["ms"], g["eager_ms"]
                t = flow_detect_ms(prev8, curr8, b, p, dev)
                pt[f"flow_ms_b{b}"] = t["flow_ms"]
                pt[f"flow_device_ms_b{b}"] = t["flow_device_ms"]
            print(dumps(pt))
        points.append(pt)

    key = f"ms_b{batches[-1]}"
    ranked = sorted((p for p in points if p["gate_pass"]), key=lambda p: p[key])
    print(f"\n=== ranked (best first, by {key}: flow + detect ms per frame) ===")
    for p in ranked:
        print(dumps(p))
    res = {"device": name, "size": f"{w}x{h}", "batches": batches,
           "gate_px": EPE_GT_GATE_PX, "points": points, "ranked": ranked,
           "clock": "cuda events" if dev.type == "cuda" else "host (cpu)"}
    if ranked:
        best = ranked[0]
        print(f"\nwinner: levels={best['levels']} max_shift={best['max_shift']} -> "
              f"{best[key]:.3f} ms/frame at batch {batches[-1]} ({1e3 / best[key]:.1f} "
              f"frames/s on {name})")
    print(dumps(res))
    return res


if __name__ == "__main__":
    main()
