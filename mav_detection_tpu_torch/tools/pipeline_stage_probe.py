"""Probe: where the Farneback flow stage's time goes, at batch 1 and 8.

The port of ``tools/pipeline_stage_probe.py``. On random 752x480 frames
with the tool's parameters (levels 2, pyr_scale 0.5, 6 iterations, S 8) it
times, in ms per frame, each stage twice on the card's clock: eager, CUDA
events around repeated calls (what a caller waits for, the host's enqueue
included where it is the slower), and as device time, a CUDA graph of the
stage replayed (the tool's amortised in-program repetition):

  pipeline   ``farneback_flow_batch`` end to end;
  iter@Lk    ``farneback_iterate`` alone at each pyramid layer, all of the
             layer's iterations;
  preproc    the smooth + resize + polynomial expansion of every layer
             (``poly_exp_pyr_pair_cf``: the band kernel on the card), the
             border maps and the inter-level flow resize, measured directly;
  residual   pipeline - iterates - preproc: the glue between them (on the
             device clock, the work no stage above holds; eager, also the
             host's share);

each beside its bound: ``fused_bound`` per launch of the iterate (with
the blocks the kernel runs on beside it, ``fused_schedule``), and for preproc
the expansion's least operations and its bytes (``farneback_expand.expand_bound``:
each frame read once, the coefficients written once) with the flow resize's
matmuls.
The layers are the shapes ``_farneback_cf`` launches on
(``_pyramid_scales``); the JAX tool's ``round(H * 0.5**k)`` is printed
beside them. The stages compose to ``farneback_flow_batch``'s flow
(``staged_flow``; ``composed_equal`` in the result). ``band_rows`` is a
TPU-only knob with no counterpart here::

    python -m mav_detection_tpu_torch.tools.pipeline_stage_probe [H W]

``--device cpu`` runs the plain versions on the host clock (no share of a
card's bound).
"""
from __future__ import annotations

import numpy as np
import torch

from mav_detection_tpu_torch.ops.flow import farneback as fb
from mav_detection_tpu_torch.ops.flow import farneback_expand as fe
from mav_detection_tpu_torch.ops.flow import farneback_iter as fi
from mav_detection_tpu_torch.tools.common import dumps, parser
from mav_detection_tpu_torch.utils.device import resolve_device
from mav_detection_tpu_torch.utils.timing import (
    bound_ms,
    device_name,
    eager_ms,
    fmt_share,
    kernel_ms,
    share_of_bound,
)

# the bench / product configuration of the JAX tool (its band_rows aside)
PARAMS = fb.FarnebackParams(levels=2, pyr_scale=0.5, warp="fused",
                            iterations=6, max_shift=8)
REPS = 10


def layer_shapes(h: int, w: int, params: fb.FarnebackParams) -> list:
    """(lh, lw) of every layer ``_farneback_cf`` runs, finest first."""
    return [(int(round(h * s)), int(round(w * s)))
            for s in fb._pyramid_scales(h, w, params)]


def jax_tool_shapes(h: int, w: int, params: fb.FarnebackParams) -> list:
    """The JAX tool's layer shapes, ``round(H * pyr_scale**k)`` for k = 0 ..
    levels: it does not drop the layers ``_pyramid_scales`` caps."""
    return [(int(round(h * params.pyr_scale ** k)), int(round(w * params.pyr_scale ** k)))
            for k in range(params.levels + 1)]


def level_inputs(prev: torch.Tensor, curr: torch.Tensor, flow, params: fb.FarnebackParams,
                 k_level: int, scales: list) -> tuple:
    """What ``_farneback_cf`` computes at layer ``k_level`` before the
    iterate: (R0, R1, flow, border, iterations); ``flow`` is the coarser
    layer's result, or None at the coarsest."""
    scale = scales[k_level]
    sigma = (1.0 / scale - 1.0) * 0.5
    smooth_sz = max(int(round(sigma * 5)) | 1, 3)
    b, h, w = prev.shape
    lh, lw = int(round(h * scale)), int(round(w * scale))
    if flow is None:
        flow = torch.zeros((b, 2, lh, lw), dtype=torch.float32, device=prev.device)
    else:
        flow = fb.resize_linear_cf(flow, (lh, lw)) * (1.0 / params.pyr_scale)
    smooth = fb._gaussian_kernel(smooth_sz, sigma)
    R0, R1 = fb.poly_exp_pyr_pair_cf(prev, curr, smooth, lh, lw, params.poly_n,
                                     params.poly_sigma)
    return (R0, R1, flow, fb.border_scale_map(lh, lw, prev.device),
            fb._level_iter_count(params, k_level))


def staged_flow(prev: torch.Tensor, curr: torch.Tensor,
                params: fb.FarnebackParams) -> torch.Tensor:
    """``_farneback_cf`` split at the stages this probe times: per layer,
    coarsest first, ``level_inputs`` and then ``farneback_iterate``; (b, h,
    w, 2) flow."""
    prev, curr = prev.to(torch.float32), curr.to(torch.float32)
    scales = fb._pyramid_scales(prev.shape[1], prev.shape[2], params)
    flow = None
    for k in reversed(range(len(scales))):
        R0, R1, flow, border, n = level_inputs(prev, curr, flow, params, k, scales)
        flow = fi.farneback_iterate(R0, R1, flow.contiguous(), border, n,
                                    params.winsize, params.max_shift)
    return flow.permute(0, 2, 3, 1)


def preproc_bound(b: int, h: int, w: int, params: fb.FarnebackParams) -> tuple:
    """(least ms, "bytes" or "operations") of every layer's preprocessing:
    the least operations of the expansion of both frames
    (``farneback_expand.expand_ops``: smooth, resize and moments in turn)
    and the flow resize's fp32 matmuls; each frame read once per layer, R0,
    R1, the border map and the resized flow written once."""
    shapes = layer_shapes(h, w, params)
    ops = 0.0
    nbytes = 0
    for k, (scale, (lh, lw)) in enumerate(zip(fb._pyramid_scales(h, w, params), shapes)):
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth = fb._gaussian_kernel(max(int(round(sigma * 5)) | 1, 3), sigma)
        ops += fe.expand_ops(2 * b, h, w, lh, lw,
                             fb._expand_taps(h, w, lh, lw, smooth, params.poly_n))
        nbytes += fe.expand_bytes(2 * b, h, w, lh, lw) // 4 + lh * lw
        if k + 1 < len(shapes):
            ch, cw = shapes[k + 1]
            ops += 2 * b * (2.0 * lh * ch * cw + 2.0 * lh * cw * lw)
            nbytes += lh * ch + lw * cw + 2 * b * (ch * cw + lh * lw)
    return bound_ms(4.0 * nbytes, ops)


def main(argv=None, device=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("H", type=int, nargs="?", default=480)
    ap.add_argument("W", type=int, nargs="?", default=752)
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    H, W, params = args.H, args.W, PARAMS
    name = device_name(dev)
    shapes, jax_shapes = layer_shapes(H, W, params), jax_tool_shapes(H, W, params)
    scales = fb._pyramid_scales(H, W, params)
    print(f"device={name} {H}x{W} params: levels={params.levels} "
          f"pyr_scale={params.pyr_scale} iters={params.iterations} S={params.max_shift} "
          f"(band_rows: TPU-only knob, no counterpart)")
    print(f"layers _farneback_cf runs on {shapes}; the JAX tool's round(H * "
          f"{params.pyr_scale}**k) {jax_shapes} ({'the same' if shapes == jax_shapes else 'differ'})")

    rng = np.random.default_rng(0)
    res = {"device": name, "H": H, "W": W, "S": params.max_shift,
           "iterations": [fb._level_iter_count(params, k) for k in range(len(shapes))],
           "layers": [f"{h}x{w}" for h, w in shapes],
           "jax_tool_layers": [f"{h}x{w}" for h, w in jax_shapes],
           "layers_agree_with_jax_tool": shapes == jax_shapes, "batches": []}
    for b in (1, 8):
        prev = torch.as_tensor(rng.random((b, H, W)) * 255, dtype=torch.float32).to(dev)
        curr = torch.as_tensor(rng.random((b, H, W)) * 255, dtype=torch.float32).to(dev)
        flow = fb.farneback_flow_batch(prev, curr, params, dev)
        composed = staged_flow(prev, curr, params)
        equal = bool(torch.equal(flow, composed))

        def pipeline():
            return fb.farneback_flow_batch(prev, curr, params, dev)

        pipe = eager_ms(pipeline, dev, REPS) / b
        pipe_dev = kernel_ms(pipeline, dev, REPS) / b

        layers = []
        for k, (lh, lw) in enumerate(shapes):
            n = fb._level_iter_count(params, k)
            R0, R1 = (torch.as_tensor(rng.random((b, 5, lh, lw)), dtype=torch.float32).to(dev)
                      for _ in range(2))
            fl = torch.as_tensor(rng.random((b, 2, lh, lw)), dtype=torch.float32).to(dev)
            bor = torch.ones((lh, lw), dtype=torch.float32, device=dev)

            def iterate(R0=R0, R1=R1, fl=fl, bor=bor, n=n):
                return fi.farneback_iterate(R0, R1, fl, bor, n, params.winsize,
                                            params.max_shift)

            geo = fi.fused_schedule(b, lh, lw, params.winsize, params.max_shift,
                                    fi._sm_count(dev.index) if dev.type == "cuda"
                                    else fi.H100_SMS)
            per_launch, by = fi.fused_bound(b, lh, lw, params.winsize)
            eager = eager_ms(iterate, dev, REPS)
            graph = kernel_ms(iterate, dev, REPS)
            layers.append({"layer": f"L{k}", "shape": f"{lh}x{lw}", "iterations": n,
                           "ms": eager / b, "device_ms": graph / b,
                           "bound_ms": n * per_launch / b, "bound_by": by,
                           "geometry": str(geo),
                           "share_of_bound": share_of_bound(n * per_launch, graph, dev)})

        # every layer's preprocessing, with flows of the shapes the
        # pipeline hands each layer
        coarse = [None if k + 1 == len(shapes) else
                  torch.zeros((b, 2) + shapes[k + 1], device=dev) for k in range(len(shapes))]
        def preproc():
            return [level_inputs(prev, curr, coarse[k], params, k, scales)
                    for k in reversed(range(len(shapes)))]

        pre = eager_ms(preproc, dev, REPS) / b
        pre_dev = kernel_ms(preproc, dev, REPS) / b
        pre_bound, pre_by = preproc_bound(b, H, W, params)
        iters = sum(lv["ms"] for lv in layers)
        iters_dev = sum(lv["device_ms"] for lv in layers)
        row = {"b": b, "pipeline_ms": pipe, "pipeline_device_ms": pipe_dev,
               "layers": layers, "iterate_ms": iters, "iterate_device_ms": iters_dev,
               "iterate_bound_ms": sum(lv["bound_ms"] for lv in layers),
               "preproc_ms": pre, "preproc_device_ms": pre_dev,
               "preproc_bound_ms": pre_bound / b, "preproc_bound_by": pre_by,
               "preproc_share_of_bound": share_of_bound(pre_bound / b, pre_dev, dev),
               "residual_ms": pipe - iters - pre,
               "residual_device_ms": pipe_dev - iters_dev - pre_dev,
               "composed_equal": equal,
               "launches_per_call": sum(lv["iterations"] for lv in layers)}
        res["batches"].append(row)
        parts = " | ".join(f"iter@{lv['layer']} {lv['ms']:.4f} (device {lv['device_ms']:.4f}, "
                           f"bound {lv['bound_ms']:.4f}, share "
                           f"{fmt_share(lv['share_of_bound'])})" for lv in layers)
        print(f"b={b}: pipeline {pipe:.4f} ms/frame (device {pipe_dev:.4f}) | {parts} | "
              f"preproc {pre:.4f} (device {pre_dev:.4f}, bound {row['preproc_bound_ms']:.4f} "
              f"{pre_by}, share {fmt_share(row['preproc_share_of_bound'])}) | residual "
              f"(glue) {row['residual_ms']:.4f} (device {row['residual_device_ms']:.4f}); "
              f"stages compose to the pipeline's flow: {equal}")
    res["composed_equal"] = all(r["composed_equal"] for r in res["batches"])
    print(dumps(res))
    return res


if __name__ == "__main__":
    main()
