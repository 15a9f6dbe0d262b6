"""Probe: the y stage's shift chain in five forms, on the card.

The port of ``tools/chain_probe.py``. It times the fused Farneback kernel's
y stage alone, on ``--bands`` stacked slabs of the real block geometry
(rows th + 2P, columns tw + 2P, P = S + 1 + m; output mrows x acols =
(th + 2m) x (tw + 2m + 2S + 1)), the 5 planes' results summed, in the
forms of the CUDA kernel ``y_stage`` (``csrc/shift_probes.cu``):

  A  the (2S+2)-step chain wgt = [sy=s](1-fy) + [sy=s-1]fy; acc += wgt x_s
  B  A with the mask of step s carried to step s + 1
  C  select-accumulate of the floor and ceil taps, one lerp at the end
  D  C with the taps and accumulators in bf16, the lerp in fp32
  T  the two taps read directly: the port's fused kernel's own form

each from a replayed CUDA graph of ``--reps`` launches beside its bytes
bound, each held to its plain version (``torch.equal``) at this size, and
each against A (A, B and T must be exact). The stacked slab repeats rows
(sr / th of them), so it moves more bytes than the fused kernel's y stage,
which reads R1's 5 planes and the flow's 2 once per pixel; both counts are
printed. sy is drawn per cell, as the tool draws it; ``--sy-run N`` keeps it
constant over runs of N columns (each run takes its first column's draw),
as a flow that is smooth across neighbouring columns gives it::

    python -m mav_detection_tpu_torch.tools.chain_probe [--S 8 --th 24 --tw 752]
    python -m mav_detection_tpu_torch.tools.chain_probe --th 32 --tw 64 --bands 1440 --sy-run 32

``--device cpu`` runs the plain versions on the host clock. The tool's
``--interpret`` has no counterpart.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from mav_detection_tpu_torch.ops.flow import shift_probes as sp
from mav_detection_tpu_torch.utils.device import resolve_device
from mav_detection_tpu_torch.utils.timing import (
    bound_ms,
    device_name,
    eager_ms,
    fmt_share,
    kernel_ms,
    share_of_bound,
)

EXACT_VS_A = ("A", "B", "T")


def fused_y_bytes(bands: int, th: int, tw: int) -> int:
    """Bytes the fused kernel's y stage must read for the same output
    pixels: R1's 5 planes and the flow's 2, once each (its A stays in
    shared memory)."""
    return 4 * 7 * bands * th * tw


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--S", type=int, default=8)
    ap.add_argument("--th", type=int, default=24)
    ap.add_argument("--tw", type=int, default=752)
    ap.add_argument("--m", type=int, default=6)
    ap.add_argument("--bands", type=int, default=20)
    ap.add_argument("--reps", type=int, default=300)
    ap.add_argument("--sy-run", type=int, default=1,
                    help="columns per run of constant sy (1: sy per cell)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    g = sp.YGeometry(args.S, args.th, args.tw, args.m)
    bands = args.bands
    name = device_name(dev)
    nbytes = sp.y_stage_bytes(g, bands)
    fused = fused_y_bytes(bands, g.th, g.tw)
    print(f"device={name} S={g.S} th={g.th} tw={g.tw} block ({g.mrows}x{g.acols}) "
          f"slab ({g.sr}x{g.cw}) grid {bands} sy-run {args.sy_run}; slab form "
          f"{nbytes} B, the fused kernel's y stage {fused} B")

    rng = np.random.default_rng(0)
    slab, sy, fy = sp.y_stage_inputs(rng, g, bands, dev)
    if args.sy_run > 1:
        a = torch.arange(g.acols, device=dev)
        sy = sy[:, :, a - a % args.sy_run].contiguous()
    res = {"device": name, "S": g.S, "th": g.th, "tw": g.tw, "m": g.m,
           "bands": bands, "sy_run": args.sy_run, "bytes": nbytes,
           "fused_y_bytes": fused, "variants": {}}
    outs = {}
    for variant in sp.VARIANTS:
        o = sp.y_stage(slab, sy, fy, g.S, g.m, variant)
        us = kernel_ms(lambda v=variant, o=o: sp.y_stage(slab, sy, fy, g.S, g.m, v, out=o),
                       dev, args.reps) * 1e3
        want = sp.y_stage_ref(slab, sy, fy, g.S, g.m, variant)
        plain_ms = eager_ms(lambda v=variant: sp.y_stage_ref(slab, sy, fy, g.S, g.m, v),
                            dev, 3, 1)
        bound, by = bound_ms(nbytes, sp.y_stage_ops(g, bands, variant))
        outs[variant] = o
        d = float((o - outs["A"]).abs().max())
        err = float((o - want).abs().max())
        equal = bool(torch.equal(o, want))
        base = res["variants"].get("A", {}).get("us", us)
        share = share_of_bound(bound * 1e3, us, dev)
        res["variants"][variant] = {"us": us, "bound_us": bound * 1e3,
                                    "bound_by": by, "share": share,
                                    "max_diff_vs_A": d, "plain_ms": plain_ms,
                                    "equal_to_plain": equal, "max_abs_err": err}
        flag = "  (EXPECTED EXACT!)" if variant in EXACT_VS_A and d != 0.0 else ""
        miss = "" if equal else "  (EXPECTED EQUAL!)"
        print(f"[{variant}] {us:9.1f} us  ({base / us:4.2f}x vs A)  "
              f"max|diff vs A|={d:.2e}{flag}  bound {bound * 1e3:.1f} us ({by}), "
              f"share {fmt_share(share)}; plain {plain_ms:.4f} ms, "
              f"equal_to_plain={equal}{miss}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return res


if __name__ == "__main__":
    main()
