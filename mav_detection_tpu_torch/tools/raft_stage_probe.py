"""Probe: RAFT inference split into its stages, at 752x480.

The port of ``tools/raft_stage_probe.py``. On a random uint8 frame pair
with the shipped checkpoint (a seeded random init where none is shipped),
the product configuration (``INFERENCE_CONFIG``: banded local volumes,
bf16 convolutions; ``PRODUCT_ITERS`` refinement iterations), it times on
the card's clock (CUDA events around eager calls; the device time of a
replayed CUDA graph beside it where the stage can be captured):

  full iters=1 / 6   the whole forward (``raft_flow``); the slope is the
                     cost of one refinement iteration;
  encoder            the two fnet passes of the forward;
  corr volumes       ``build_local_corr_volumes`` on the encoder's features
                     (the feature pyramid built outside, as the tool does);
  batch              ``--batch`` pairs (8) through the port's batch
                     dimension (the tool's vmap) and through a Python loop
                     of single-pair calls (the tool's ``lax.map``), ms per
                     frame, and the largest difference between the two
                     flows;

each beside its bound: the convolutions' fp32 and bf16 operations
(``models.layers.conv_flops``), the volumes' dot products, and the bytes of
the weights, inputs and outputs::

    python -m mav_detection_tpu_torch.tools.raft_stage_probe [H W]
        [--batch 8]

``--device cpu`` times on the host clock (one repetition).
"""
from __future__ import annotations

import numpy as np
import torch

from mav_detection_tpu_torch.models import pretrained
from mav_detection_tpu_torch.models import raft as R
from mav_detection_tpu_torch.models.layers import conv_flops
from mav_detection_tpu_torch.tools.common import dumps, parser
from mav_detection_tpu_torch.utils.device import resolve_device
from mav_detection_tpu_torch.utils.timing import (
    bound_ms,
    device_name,
    eager_ms,
    fmt_share,
    graph_ms,
    nbytes,
    share_of_bound,
)

REPS = 5


def load_model(dev: torch.device) -> tuple:
    """(the shipped RAFT on ``dev``, True), or a seeded random one and
    False where no checkpoint is shipped."""
    model = pretrained.load_raft(dev)
    if model is not None:
        return model, True
    return R.create_raft(torch.Generator().manual_seed(0)).to(dev), False


def stage_times(fn, dev: torch.device, reps: int) -> dict:
    """{"ms": events (host clock on the CPU), "device_ms": a replayed CUDA
    graph's, None where the stage cannot be captured or on the CPU}."""
    ms = eager_ms(fn, dev, reps, warm=1)
    device = None
    if dev.type == "cuda":
        try:
            device = graph_ms(fn, reps)
        except RuntimeError:
            torch.cuda.synchronize(dev)
    return {"ms": ms, "device_ms": device}


def volume_flops(vols, channels: int) -> float:
    """The dot products the local volumes hold: C multiply-adds each."""
    return sum(2.0 * v.numel() * channels for v in vols)


def main(argv=None, device=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("H", type=int, nargs="?", default=480)
    ap.add_argument("W", type=int, nargs="?", default=752)
    ap.add_argument("--batch", type=int, default=8,
                    help="pairs of the batch path (the tool's 8)")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    H, W, nb = args.H, args.W, args.batch
    reps = REPS if dev.type == "cuda" else 1
    model, shipped = load_model(dev)
    cfg, iters = R.INFERENCE_CONFIG, R.PRODUCT_ITERS
    dt, r = cfg.dtype, cfg.corr_radius
    name = device_name(dev)
    print(f"device={name} {W}x{H} RAFT {'shipped checkpoint' if shipped else 'random init'}, "
          f"{str(dt).replace('torch.', '')} convolutions, banded local volumes")
    rng = np.random.default_rng(0)
    img1 = torch.as_tensor(rng.integers(0, 255, (1, H, W, 3)), dtype=torch.uint8).to(dev)
    img2 = torch.as_tensor(rng.integers(0, 255, (1, H, W, 3)), dtype=torch.uint8).to(dev)
    weights = nbytes(*model.parameters())
    res = {"device": name, "size": f"{W}x{H}", "shipped_checkpoint": shipped,
           "iters": iters, "stages": {}}

    with torch.no_grad():
        x1 = R._images_nchw(img1, dev) / 127.5 - 1.0
        x2 = R._images_nchw(img2, dev) / 127.5 - 1.0
        f1, f2 = model.fnet(x1, dt), model.fnet(x2, dt)
        pyr = R.build_feature_pyramid(f2, cfg.corr_levels)
        vols = R.build_local_corr_volumes(f1, pyr, r, cfg.max_flow_lookup)
        vol_ops = volume_flops(vols, f1.shape[1])
        out_bytes = 4 * 2 * H * W

        def add(tag, fn, nbytes_, extra_fp32=0.0):
            fl = conv_flops(model, fn)
            t = stage_times(fn, dev, reps)
            bound, by = bound_ms(nbytes_, fl["fp32"] + extra_fp32, fl["bf16"])
            t.update(bound_ms=bound, bound_by=by, gflop_bf16=fl["bf16"] / 1e9,
                     gflop_fp32=(fl["fp32"] + extra_fp32) / 1e9,
                     share_of_bound=share_of_bound(bound, t["device_ms"] or t["ms"], dev))
            res["stages"][tag] = t
            return t

        for k in (1, iters):
            add(f"full iters={k}", lambda k=k: R.raft_flow(model, img1, img2, k, cfg),
                weights + nbytes(img1, img2) + out_bytes, vol_ops)
        full1, full6 = res["stages"]["full iters=1"], res["stages"][f"full iters={iters}"]
        res["slope_ms_per_iter"] = (full6["ms"] - full1["ms"]) / (iters - 1)
        res["slope_device_ms_per_iter"] = (
            None if full1["device_ms"] is None or full6["device_ms"] is None
            else (full6["device_ms"] - full1["device_ms"]) / (iters - 1))
        add("encoder (fnet x2)", lambda: (model.fnet(x1, dt), model.fnet(x2, dt)),
            nbytes(*model.fnet.parameters()) + nbytes(x1, x2, f1, f2))
        add("local corr volumes", lambda: R.build_local_corr_volumes(
            f1, pyr, r, cfg.max_flow_lookup), nbytes(f1, *pyr, *vols), vol_ops)

        b1 = torch.as_tensor(rng.integers(0, 255, (nb, H, W, 3)), dtype=torch.uint8).to(dev)
        b2 = torch.as_tensor(rng.integers(0, 255, (nb, H, W, 3)), dtype=torch.uint8).to(dev)

        def batch():
            return R.raft_flow(model, b1, b2, iters, cfg)

        def loop():
            return torch.cat([R.raft_flow(model, b1[i:i + 1], b2[i:i + 1], iters, cfg)
                              for i in range(nb)])

        fb, fl_ = batch(), loop()
        paths = {}
        for tag, fn, flow in (("batch", batch, fb), ("loop", loop, fl_)):
            ms = eager_ms(fn, dev, reps, warm=1) / nb
            paths[tag] = {"ms_per_frame": ms, "fps": 1e3 / ms,
                          "finite": bool(torch.isfinite(flow).all())}
        res["batch_paths"] = {"pairs": nb, **paths,
                              "max_batch_vs_loop_px": float((fb - fl_).abs().max())}

    for tag, t in res["stages"].items():
        dev_ms = "not measured" if t["device_ms"] is None else f"{t['device_ms']:.3f}"
        print(f"{tag}: {t['ms']:.3f} ms (device {dev_ms}), bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}: {t['gflop_bf16']:.3f} GFLOP bf16 + {t['gflop_fp32']:.3f} "
              f"fp32), share {fmt_share(t['share_of_bound'])}")
    print(f"slope {res['slope_ms_per_iter']:.3f} ms/iter")
    bp = res["batch_paths"]
    for tag in ("batch", "loop"):
        print(f"batch{nb} {tag}: {bp[tag]['ms_per_frame']:.2f} ms/frame "
              f"({bp[tag]['fps']:.1f} frames/s on {name}), finite={bp[tag]['finite']}")
    print(f"batch against loop: max |diff| {bp['max_batch_vs_loop_px']:.3g} px")
    print(dumps(res))
    return res


if __name__ == "__main__":
    main()
