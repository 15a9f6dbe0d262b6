"""Probe: RAFT flow at the reference's 1920x1024 AirSim resolution.

The port of ``tools/hires_raft_probe.py``. On the hires bench scene with
the shipped checkpoint (the probe refuses to report a random init) and
the product configuration, the net runs at (H/d, W/d) with ``--downscale
d`` (the frames resized and the flow resized back and scaled by d, as
``jax.image.resize`` does: the features live near the trained scale), and
reports the EPE against the analytic GT on the 16-px interior once, after
checking that the scene does not saturate the banded volumes' 16 px. Then
for each batch of ``--batches`` (the pair repeated; the port's batch
dimension in place of the tool's vmap): ms per frame (CUDA events),
frames/s, peak device memory, and the largest difference between the
batch's flows and the single pair's. A batch that does not fit in device
memory is reported as such, and the next one is tried; nothing falls back
to a smaller size::

    python -m mav_detection_tpu_torch.tools.hires_raft_probe [--batches 1,2,4]
        [--iters 0] [--downscale 1]

``--device cpu`` times on the host clock (one repetition).
"""
from __future__ import annotations

import numpy as np
import torch

from mav_detection_tpu_torch.models import pretrained
from mav_detection_tpu_torch.models import raft as R
from mav_detection_tpu_torch.ops.flow.farneback import resize_linear_cf
from mav_detection_tpu_torch.tools.common import HIRES_HW, dumps, epe, hw, ints, parser, scene
from mav_detection_tpu_torch.utils.device import resolve_device
from mav_detection_tpu_torch.utils.timing import device_name, eager_ms

REPS = 3


def net_flow(model, a: torch.Tensor, c: torch.Tensor, iters: int, d: int,
             config: R.RAFTConfig = R.INFERENCE_CONFIG) -> torch.Tensor:
    """(b, h, w, 3) float frames -> (b, h, w, 2) flow; with ``d`` > 1 the
    net runs at (h/d, w/d) and its flow is resized back and scaled by d."""
    h, w = a.shape[1:3]
    if d > 1:
        a, c = (resize_linear_cf(t.permute(0, 3, 1, 2), (h // d, w // d)).permute(0, 2, 3, 1)
                for t in (a, c))
    f = R.raft_flow(model, a, c, iters, config)
    if d > 1:
        f = resize_linear_cf(f.permute(0, 3, 1, 2), (h, w)).permute(0, 2, 3, 1) * float(d)
    return f


def main(argv=None, device=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--batches", default="1,2,4")
    ap.add_argument("--iters", type=int, default=0, help="0 = the product default")
    ap.add_argument("--downscale", type=int, default=1,
                    help="run the net at (H/d, W/d) and upsample the flow x d")
    ap.add_argument("--size", type=hw, default=HIRES_HW, metavar="HxW",
                    help="the hires scene at another frame size")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    iters, d = args.iters or R.PRODUCT_ITERS, args.downscale
    cfg = R.INFERENCE_CONFIG
    reps = REPS if dev.type == "cuda" else 1
    h, w = args.size
    prev8, curr8, gt = scene(h, w, hires=True)
    model = pretrained.load_raft(dev)
    if model is None:
        raise RuntimeError("no shipped RAFT checkpoint: refusing to report untrained numbers")
    name = device_name(dev)
    print(f"device={name} frame {w}x{h} iters={iters} downscale {d} max |gt flow| "
          f"{np.abs(gt).max():.1f} px")
    p3 = torch.as_tensor(np.repeat(prev8[None, ..., None], 3, -1), dtype=torch.float32).to(dev)
    c3 = torch.as_tensor(np.repeat(curr8[None, ..., None], 3, -1), dtype=torch.float32).to(dev)
    flow1 = net_flow(model, p3, c3, iters, d, cfg)
    saturated = R.check_flow_saturation(flow1 / d, cfg)
    if saturated:
        raise RuntimeError("the scene saturated the 16 px band at the net's working scale")
    epe_gt = epe(flow1[0].cpu().numpy(), gt)
    print(f"EPE vs analytic GT (downscale {d}): {epe_gt:.4f} px")
    res = {"device": name, "size": f"{w}x{h}", "iters": iters, "downscale": d,
           "epe_gt": epe_gt, "saturated": saturated, "batches": [],
           "first_batch_not_fitting": None}
    for b in ints(args.batches):
        pb, cb = p3.repeat(b, 1, 1, 1), c3.repeat(b, 1, 1, 1)
        try:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            fb = net_flow(model, pb, cb, iters, d, cfg)
            ms = eager_ms(lambda: net_flow(model, pb, cb, iters, d, cfg), dev, reps, warm=0) / b
        except torch.OutOfMemoryError as e:
            del pb, cb
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            row = {"batch": b, "error": type(e).__name__}
            if res["first_batch_not_fitting"] is None:
                res["first_batch_not_fitting"] = b
            print(dumps(row))
            print(f"  {e}")
            res["batches"].append(row)
            continue
        row = {"batch": b, "ms_per_frame": ms, "fps": 1e3 / ms, "epe_gt": epe_gt,
               "max_vs_single_px": float((fb - flow1).abs().max()),
               "finite": bool(torch.isfinite(fb).all()),
               "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None)}
        res["batches"].append(row)
        print(dumps(row))
    print(dumps(res))
    return res


if __name__ == "__main__":
    main()
