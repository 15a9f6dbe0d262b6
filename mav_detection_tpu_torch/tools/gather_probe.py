"""Probe: the (2S+2)-step select chain against a two-tap gather, on the card.

The port of ``tools/gather_probe.py``. The fused Farneback kernel's shifted
read ``A[j, a] = x[j + sy[j, a], a]`` is, in the TPU kernel, a (2S+2)-step
accumulate of one-hot selects; the probe times that chain and a gather of
its two taps (plus lerp) on one (rows x cols) fp32 plane, along the rows
(axis 0) and along the columns (axis 1), and checks that the two agree
exactly. Here the two are the CUDA kernels ``shift_chain`` and
``shift_gather`` (``csrc/shift_probes.cu``), timed from a replayed CUDA
graph of ``--reps`` launches, each beside its bytes bound and held to its
plain version (``torch.equal``) at this size::

    python -m mav_detection_tpu_torch.tools.gather_probe [--rows 64 --cols 768 --S 8]

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


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--cols", type=int, default=768)
    ap.add_argument("--S", type=int, default=8)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    rows, cols, S = args.rows, args.cols, args.S
    name = device_name(dev)
    print(f"device={name} plane {rows}x{cols} S={S}")

    rng = np.random.default_rng(0)
    out = {"device": name, "rows": rows, "cols": cols, "S": S, "axes": []}
    for axis in (0, 1):
        x, sy, fy = sp.shift_inputs(rng, rows, cols, S, axis, dev)
        nbytes = sp.shift_bytes(rows, cols, S, axis)
        res = {"axis": axis, "bytes": nbytes}
        outs = {}
        for kernel, fn, ref in (("shift_chain", sp.shift_chain, sp.shift_chain_ref),
                                ("shift_gather", sp.shift_gather, sp.shift_gather_ref)):
            o = fn(x, sy, fy, S, axis)
            outs[kernel] = o
            us = kernel_ms(lambda fn=fn, o=o: fn(x, sy, fy, S, axis, out=o),
                           dev, args.reps) * 1e3
            want = ref(x, sy, fy, S, axis)
            plain_ms = eager_ms(lambda ref=ref: ref(x, sy, fy, S, axis), dev, 3, 1)
            bound, by = bound_ms(nbytes, sp.shift_ops(kernel, rows, cols, S))
            res[kernel] = {"us": us, "bound_us": bound * 1e3, "bound_by": by,
                           "share": share_of_bound(bound * 1e3, us, dev),
                           "plain_ms": plain_ms, "equal_to_plain": bool(torch.equal(o, want)),
                           "max_abs_err": float((o - want).abs().max())}
        exact = bool(torch.equal(outs["shift_gather"], outs["shift_chain"]))
        res["exact_vs_chain"] = exact
        ch, ga = res["shift_chain"], res["shift_gather"]
        print(f"[chain  axis={axis}] {ch['us']:8.1f} us  bound {ch['bound_us']:.1f} us "
              f"({ch['bound_by']}, {nbytes} B), share {fmt_share(ch['share'])}; plain "
              f"{ch['plain_ms']:.4f} ms, equal_to_plain={ch['equal_to_plain']}")
        print(f"[gather axis={axis}] {ga['us']:8.1f} us ({ch['us'] / ga['us']:.2f}x vs "
              f"chain) exact_vs_chain={exact}  bound {ga['bound_us']:.1f} us, "
              f"share {fmt_share(ga['share'])}; plain {ga['plain_ms']:.4f} ms, "
              f"equal_to_plain={ga['equal_to_plain']}")
        out["axes"].append(res)
    return out


if __name__ == "__main__":
    main()
