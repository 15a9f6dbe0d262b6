"""Probe: where one Farneback solver iteration's time goes, at batch 1 and 8.

The port of ``tools/batch_overhead_probe.py``, which split one iteration of
the TPU solver into its kernel (``pl.pallas_call`` on pre-stacked inputs)
and the XLA restack around it. Here one iteration is one launch of the
fused CUDA kernel ``farneback_iterate_fused`` (``csrc/farneback_iter.cu``),
and the probe reports ms per frame per iteration on the tool's random
planes (S = 8, winsize 12, 6 iterations):

  full    the product call ``farneback_iterate`` with 6 iterations, eager
          (CUDA events around repeated calls);
  kernel  ``iterate_fused_cuda`` alone on fixed inputs, replayed in a CUDA
          graph (device time only);
  glue    full - kernel: the wrapper work around the launches, the port's
          counterpart of the tool's restack;

beside the kernel's bound (``farneback_iter.fused_bound``: R0, R1, flow
in and out once each, the border once; the operations the iteration needs,
no halo) and the blocks the launch runs on (``fused_schedule``; an H100's
132 SMs on the CPU). The tool's element-halo column is a TPU-only knob with no
counterpart here::

    python -m mav_detection_tpu_torch.tools.batch_overhead_probe [H W]

``--device cpu`` times the plain versions on the host clock.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from mav_detection_tpu_torch import _build
from mav_detection_tpu_torch.ops.flow import farneback_iter as fi
from mav_detection_tpu_torch.utils.device import resolve_device
from mav_detection_tpu_torch.utils.timing import (
    device_name,
    eager_ms,
    fmt_share,
    kernel_ms,
    share_of_bound,
)

S, WIN, ITERS = 8, 12, 6
FULL_REPS, KERNEL_REPS = 10, 50


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("H", type=int, nargs="?", default=480)
    ap.add_argument("W", type=int, nargs="?", default=752)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    H, W = args.H, args.W
    name = device_name(dev)
    print(f"device={name} {H}x{W} S={S} winsize {WIN} {ITERS} iterations")

    rng = np.random.default_rng(0)
    res = {"device": name, "H": H, "W": W, "S": S, "winsize": WIN,
           "iterations": ITERS, "batches": []}
    for b in (1, 8):
        R0, R1 = (torch.as_tensor(rng.random((b, 5, H, W)), dtype=torch.float32).to(dev)
                  for _ in range(2))
        flow = torch.as_tensor(rng.random((b, 2, H, W)), dtype=torch.float32).to(dev)
        border = torch.ones((H, W), dtype=torch.float32, device=dev)
        full = eager_ms(lambda: fi.farneback_iterate(R0, R1, flow, border, ITERS, WIN, S),
                        dev, FULL_REPS)
        if dev.type == "cuda":
            o = torch.empty_like(flow)
            launch = kernel_ms(lambda: fi.iterate_fused_cuda(R0, R1, flow, border, o, WIN, S),
                               dev, KERNEL_REPS)
            sms = _build.sm_count(R0.device.index)
        else:
            launch = kernel_ms(lambda: fi.box_solve_ref(fi.update_matrices_ref(
                R0, R1, flow, border, S), WIN), dev, FULL_REPS)
            sms = fi.H100_SMS
        geo = fi.fused_schedule(b, H, W, WIN, S, sms)
        bound, by = fi.fused_bound(b, H, W, WIN)
        row = {"b": b, "full_ms": full / (b * ITERS), "kernel_ms": launch / b,
               "glue_ms": full / (b * ITERS) - launch / b,
               "kernel_ms_per_launch": launch, "bound_ms_per_launch": bound,
               "geometry": str(geo),
               "bound_by": by,
               "kernel_share_of_bound": share_of_bound(bound, launch, dev)}
        res["batches"].append(row)
        print(f"b={b}: full {row['full_ms']:.5f} ms/frame/iter | kernel "
              f"{row['kernel_ms']:.5f} | glue {row['glue_ms']:.5f} | element-halo "
              f"no counterpart (TPU-only knob) | kernel {launch:.5f} ms per launch, "
              f"bound {bound:.5f} ms ({by}), share "
              f"{fmt_share(row['kernel_share_of_bound'])}")
    return res


if __name__ == "__main__":
    main()
