"""Sweep: the per-level iteration schedule against the EPE gates.

The port of ``tools/iter_schedule_sweep.py``. On the bench scene (752x480,
``--hires`` 1920x1024), for each per-level schedule (finest first; ``None``
is the flat ``iterations``, the control) over the product's
``tuned_flow_params``: ms per frame of the batched flow + detection step
(CUDA events, ``--batch`` copies of the pair) and of the flow alone (also
its device time, a replayed CUDA graph), frames/s, and the EPE of ``farneback_flow`` on the 16-px interior against
the scene's analytic GT and against the cv2 oracle. The package computes no
cv2 flow: the oracle, ``cv2.calcOpticalFlowFarneback(prev8, curr8, None,
0.4, 1, 12, 10, 8, 1.2, 0)`` on the same frames, comes in as ``--oracle
PATH.npy`` or ``main(..., oracle=array)``; without it ``epe_cv2`` is
``null``. The identity schedule (6, 6, 6) must give the control's flow and
launches (``identity_equal`` in the result)::

    python -m mav_detection_tpu_torch.tools.iter_schedule_sweep [--hires]
        [--batch 8] [--schedules '3,4,8;flat'] [--oracle cv2.npy]

``--device cpu`` (the tool's ``--cpu``) times on the host clock.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from mav_detection_tpu_torch.ops.flow import farneback_iter as fi
from mav_detection_tpu_torch.ops.flow.farneback import farneback_flow, tuned_flow_params
from mav_detection_tpu_torch.tools.common import (
    BENCH_HW,
    HIRES_HW,
    dumps,
    epe,
    flow_detect_ms,
    fmt,
    hw,
    oracle_flow,
    parser,
    scene,
)
from mav_detection_tpu_torch.utils.device import resolve_device
from mav_detection_tpu_torch.utils.timing import device_name

SCHEDULES = [
    None,             # flat `iterations` (the shipped default, the control)
    (6, 6, 6),        # must equal the control (identity check)
    (5, 6, 8),
    (4, 8, 8),
    (4, 8, 12),
    (4, 6, 10),
    (3, 8, 12),
    (5, 5, 5),
    (4, 4, 8),
]
IDENTITY = (6, 6, 6)


def parse_schedules(text: str) -> list:
    """``"3,4,8;flat"`` -> [(3, 4, 8), None]."""
    return [None if s.strip() == "flat" else tuple(int(v) for v in s.split(","))
            for s in text.split(";") if s.strip()]


def main(argv=None, device=None, oracle=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--hires", action="store_true",
                    help="sweep at 1920x1024 instead of 752x480")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--no-timing", action="store_true",
                    help="accuracy only")
    ap.add_argument("--schedules", default="",
                    help="semicolon-separated finest-first tuples to sweep "
                         "instead of the built-in list; 'flat' = the control")
    ap.add_argument("--size", type=hw, default=None, metavar="HxW",
                    help="the scene at another frame size")
    ap.add_argument("--oracle", default=None, help=".npy of the cv2 oracle's flow")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    h, w = args.size or (HIRES_HW if args.hires else BENCH_HW)
    prev8, curr8, gt = scene(h, w, args.hires)
    ref = oracle_flow(oracle if oracle is not None else args.oracle, gt.shape)
    base = tuned_flow_params(h, w)
    name = device_name(dev)
    print(f"# {w}x{h} batch={args.batch} device={name} base max_shift={base.max_shift} "
          f"flat_iters={base.iterations} (band_rows: TPU-only knob, no counterpart); "
          f"cv2 oracle {'given' if ref is not None else 'not given: epe_cv2 null'}")
    schedules = parse_schedules(args.schedules) if args.schedules else SCHEDULES

    rows, flows = [], {}
    for sched in schedules:
        p = replace(base, level_iters=sched)
        fi.reset_launch_counts()
        ours = farneback_flow(prev8, curr8, p, dev).cpu()
        launches = fi.LAUNCHES["farneback_iterate_fused"]
        flows[sched] = (ours, launches)
        t = ({"ms": None, "flow_ms": None, "flow_device_ms": None} if args.no_timing
             else flow_detect_ms(prev8, curr8, args.batch, p, dev))
        ms = t["ms"]
        row = {"level_iters": list(sched) if sched else None, "ms_per_frame": ms,
               "fps": None if ms is None else 1e3 / ms, "flow_ms_per_frame": t["flow_ms"],
               "flow_device_ms_per_frame": t["flow_device_ms"],
               "epe_cv2": epe(ours, ref), "epe_gt": epe(ours, gt),
               "launches_per_pair": launches, "clock": "cuda events"
               if dev.type == "cuda" else "host (cpu)"}
        rows.append(row)
        print(dumps(row))
    res = {"device": name, "size": f"{w}x{h}", "batch": args.batch,
           "flat_iterations": base.iterations, "rows": rows, "identity_equal": None}
    if None in flows and IDENTITY in flows:
        (a, la), (b, lb) = flows[None], flows[IDENTITY]
        res["identity_equal"] = bool(torch.equal(a, b)) and la == lb
        print(f"identity schedule {IDENTITY} equal to the control: {res['identity_equal']}")
    best = [r for r in rows if r["ms_per_frame"] is not None]
    if best:
        r = min(best, key=lambda r: r["ms_per_frame"])
        print(f"fastest: {r['level_iters']} {r['ms_per_frame']:.4f} ms/frame, EPE vs GT "
              f"{r['epe_gt']:.4f}, vs cv2 {fmt(r['epe_cv2'])}")
    print(dumps(res))
    return res


if __name__ == "__main__":
    main()
