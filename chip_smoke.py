#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``mav_detection_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line (plus its seconds):
  1. device  — the card's name and power limit (nvidia-smi); fails without a
               card.
  2. build   — compiles csrc/farneback_iter.cu with nvcc for sm_90a.
  3. kernels — the fused iterate kernel against its plain PyTorch version
               on the card, on coefficients of a seeded scene at the main
               path's shapes (480x752 b=8 S=8 and 1024x1920 b=2 S=16): one
               iteration (must be bit-exact) and the whole (2, 3, 8) level
               schedule; then its time per launch (CUDA events around a
               replayed CUDA graph of 50 launches) at every pyramid layer
               (b=8 at 752x480, b=2 and b=4 at 1920x1024), kernel ms per
               batch, its plain version's time, its bound, every tile
               shape's time at each layer, and its shared memory,
               registers and blocks per SM.
  4. accuracy — flow EPE vs the analytic GT of the scipy-rendered scene on
               the 16-px interior: < 0.40 px at 752x480, < 0.55 px at
               1920x1024.
  5. main path — Processor.run_detection_foe with FARNEBACK flow at 480x752
               (20 frames, batch 8: the tail batch is padded) and 1024x1920
               (6 frames, batch 4), launch counters zeroed just before and
               read just after each run; every FrameResult field must be
               finite, FrameResult JSON is written and read back. Then the
               device time of one full batch's flow and detection steps
               (CUDA events) against the run's wall time per batch.
Then the kernels JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises before that line and
exits non-zero; so does a machine without a card, or a directory without
the package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and fp32 non-tensor rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# fp32 operations of farneback_iterate_fused, counted from
# csrc/farneback_iter.cu, per cell of each stage (integer index work not
# counted): the y stage per A-window cell (coordinate block 20, 5 planes x 3,
# 1 - fy), the x stage and normal equations per M-region cell (coordinate
# block 20, 1 - fx, 5 x 3, combination 37), and the mean and 2x2 solve per
# output pixel; the box sums add 5 planes x taps per vertical and per
# horizontal sum
OPS_Y_STAGE = 36
OPS_UPDATE = 73
OPS_SOLVE = 18

KERNEL_ROWS = {
    "farneback_iterate_fused": dict(
        route="cuda", source="mav_detection_tpu_torch/csrc/farneback_iter.cu",
        replaces="mav_detection_tpu/ops/flow/farneback_pallas.py:328"),
}
SCHEDULE_TOL_PX = 1e-4   # whole schedule; one iteration must be exact
NAN_WITHOUT_TARGET = ("tpr", "tpr_fixed", "drone_flow_pixels")


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warm: int = 3) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after warm-up."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn`` (kernel launches on the current
    stream), from a CUDA graph of ``reps`` calls replayed after warm-up, so
    that the host's time per launch does not show between short kernels."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, 5, 2) / reps


def scene_batch(b: int, h: int, w: int, hires: bool):
    from mav_detection_tpu_torch.data.scene import hires_scene_kwargs, make_scene

    kw = hires_scene_kwargs(h, w) if hires else {}
    scenes = [make_scene(seed, h=h, w=w, **kw) for seed in range(b)]
    return (np.stack([s[0] for s in scenes]), np.stack([s[1] for s in scenes]),
            np.stack([s[2] for s in scenes]))


def fused_bound(b: int, h: int, w: int, win: int, S: int, tile) -> tuple:
    """Least time of one iteration on the card: the larger of the bytes the
    function must move (R0, R1, flow in and out once each, the border once)
    over the HBM rate and the fp32 operations the kernel does on these
    shapes, halo recompute included, over the fp32 rate."""
    th, tw = tile
    m = win // 2
    taps = 2 * m + 1
    mrh, mrw = th + 2 * m, tw + 2 * m
    aw = mrw + 2 * S + 1
    per_tile = (OPS_Y_STAGE * mrh * aw + OPS_UPDATE * mrh * mrw
                + 5 * taps * (th * mrw + th * tw) + OPS_SOLVE * th * tw)
    ops = per_tile * b * -(-h // th) * -(-w // tw)
    nbytes = 4 * (14 * b * h * w + h * w)
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS_PER_S * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def level_inputs(dev, prev, curr, gt, params):
    """(R0, R1, flow, border, iterations) at every pyramid layer, finest
    first, as _farneback_cf builds them; flow is the GT scaled to the layer."""
    import torch

    from mav_detection_tpu_torch.ops.flow import farneback as fb

    p = torch.as_tensor(prev, device=dev).float()
    c = torch.as_tensor(curr, device=dev).float()
    g = torch.as_tensor(gt, device=dev).permute(0, 3, 1, 2).contiguous()
    _, h, w = p.shape
    out = []
    for k, scale in enumerate(fb._pyramid_scales(h, w, params)):
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth = fb._gaussian_kernel(max(int(round(sigma * 5)) | 1, 3), sigma)
        lh, lw = int(round(h * scale)), int(round(w * scale))
        R0 = fb.poly_exp_pyr_cf(p, smooth, lh, lw, params.poly_n, params.poly_sigma)
        R1 = fb.poly_exp_pyr_cf(c, smooth, lh, lw, params.poly_n, params.poly_sigma)
        flow = (g if k == 0 else fb.resize_linear_cf(g, (lh, lw)) * scale).contiguous()
        out.append((R0, R1, flow, fb.border_scale_map(lh, lw, dev),
                    fb._level_iter_count(params, k)))
    return p, c, out


def phase_kernels(dev, b: int, h: int, w: int, hires: bool,
                  time_batches=None) -> dict:
    """The fused kernel vs its plain version at one main-path size (one
    iteration bit-exact, the whole level schedule within SCHEDULE_TOL_PX),
    then its time at every layer of the pyramid for each batch size in
    ``time_batches``, and every tile shape's time at the finest layer."""
    import torch

    from mav_detection_tpu_torch.ops.flow import farneback as fb
    from mav_detection_tpu_torch.ops.flow import farneback_iter as fi

    params = fb.tuned_flow_params(h, w)
    S, win = params.max_shift, params.winsize
    nb = max([b, *(time_batches or ())])
    prev, curr, gt = scene_batch(nb, h, w, hires)
    p, c, levels = level_inputs(dev, prev[:b], curr[:b], gt[:b], params)

    # one iteration at the finest layer, kernel and plain version on the
    # same inputs
    R0, R1, flow0, border, _ = levels[0]
    out = torch.empty_like(flow0)
    fi.iterate_fused_cuda(R0, R1, flow0, border, out, win, S)
    out_ref = fi.box_solve_ref(fi.update_matrices_ref(R0, R1, flow0, border, S), win)
    torch.cuda.synchronize()
    err = float((out - out_ref).abs().max())
    if not torch.equal(out, out_ref):
        raise AssertionError(f"{h}x{w}: one iteration not bit-exact ({err})")

    # the whole level schedule through the pyramid, kernel vs plain: the
    # second run swaps the solver's iterate for its plain version
    flow_k = fb._farneback_cf(p, c, params)
    fb.farneback_iterate = fi.farneback_iterate_ref
    try:
        flow_r = fb._farneback_cf(p, c, params)
    finally:
        fb.farneback_iterate = fi.farneback_iterate
    err_sched = float((flow_k - flow_r).abs().max())
    if not err_sched <= SCHEDULE_TOL_PX:
        raise AssertionError(f"{h}x{w}: level schedule differs by {err_sched} px")

    def time_layer(lv, tile=None):
        R0, R1, flow, border, _ = lv
        o = torch.empty_like(flow)
        return graph_ms(lambda: fi.iterate_fused_cuda(
            R0, R1, flow, border, o, win, S, tile=tile), 50)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    timings = {}
    for tb in (time_batches or (b,)):
        lvs = levels if tb == b else level_inputs(
            dev, prev[:tb], curr[:tb], gt[:tb], params)[2]
        rows = []
        for lv in lvs:
            R0, R1, flow, border, iters = lv
            lh, lw = flow.shape[-2:]
            tile = fi.tile_for(tb, lh, lw, sms)
            bound, by = fused_bound(tb, lh, lw, win, S, tile)
            plain = time_ms(lambda: fi.box_solve_ref(fi.update_matrices_ref(
                R0, R1, flow, border, S), win), 5, 1)
            rows.append({"shape": f"b={tb} {lh}x{lw} S={S}", "iterations": iters,
                         "tile": "x".join(map(str, tile)), "ms": time_layer(lv),
                         "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                         "tiles_ms": {f"{th}x{tw}": time_layer(lv, (th, tw))
                                      for th, tw in sorted(fi.TILES)}})
        timings[tb] = {
            "layers": rows,
            "ms_per_batch": sum(r["iterations"] * r["ms"] for r in rows),
            "bound_ms_per_batch": sum(r["iterations"] * r["bound_ms"] for r in rows),
            "plain_ms_per_batch": sum(r["iterations"] * r["plain_ms"] for r in rows),
        }
    return {"shape": f"b={b} {h}x{w} S={S}", "max_abs_err": err,
            "schedule_err_px": err_sched, "timings": timings,
            "resources": {f"{th}x{tw}": fi.fused_kernel_info(win, S, (th, tw))
                          for th, tw in sorted(fi.TILES)}}


def phase_accuracy(dev) -> dict:
    import torch

    from mav_detection_tpu_torch.data.scene import (
        epe_interior,
        hires_scene_kwargs,
        make_scene,
    )
    from mav_detection_tpu_torch.ops.flow import farneback_flow

    res = {}
    for (h, w), gate, kw in (((480, 752), 0.40, {}),
                             ((1024, 1920), 0.55, None)):
        kw = hires_scene_kwargs(h, w) if kw is None else kw
        prev, curr, gt = make_scene(0, h=h, w=w, **kw)
        flow = farneback_flow(prev, curr, device=dev)
        torch.cuda.synchronize()
        epe = epe_interior(flow.cpu().numpy(), gt)
        if not epe < gate:
            raise AssertionError(f"{w}x{h}: EPE vs GT {epe} px >= {gate}")
        res[f"{w}x{h}"] = {"epe_gt_px": epe, "gate_px": gate}
    return res


def phase_main_path(dev, h: int, w: int, n_frames: int, batch: int) -> dict:
    import torch

    from mav_detection_tpu_torch.core.config import FlowSource, RunConfig
    from mav_detection_tpu_torch.core.frame_result import FrameResult
    from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
    from mav_detection_tpu_torch.ops.flow import farneback as fb
    from mav_detection_tpu_torch.ops.flow import farneback_iter as fi
    from mav_detection_tpu_torch.pipeline.detector import detect_frame_batch_scalars
    from mav_detection_tpu_torch.pipeline.processor import Processor
    from mav_detection_tpu_torch.utils.tracing import Tracer

    cfg = RunConfig(dataset="synthetic", flow_source="FARNEBACK",
                    batch_size=batch, headless=True)
    sp = SyntheticParams(height=h, width=w, n_frames=n_frames)
    cfg.get_dataset = lambda: SyntheticDataset(params=sp)
    t0 = time.perf_counter()
    proc = Processor(cfg, device=dev)
    gen_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        ds = proc.dataset
        ds.seq_path = tmp
        ds.results_path = os.path.join(tmp, "results")
        proc.run_detection_foe()                       # warm-up run
        torch.cuda.synchronize()
        proc.tracer = Tracer()
        proc.detection_results = {}
        fi.reset_launch_counts()
        t0 = time.perf_counter()
        results = proc.run_detection_foe()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fi.LAUNCHES)
        n_pairs = n_frames - 1
        if sorted(results) != list(range(n_pairs)):
            raise AssertionError(f"{w}x{h}: results for {sorted(results)}")
        params = proc._farneback
        per_batch = sum(fb._level_iter_count(params, k)
                        for k in range(len(fb._pyramid_scales(h, w, params))))
        expected = per_batch * -(-n_pairs // batch)
        for k, n in launches.items():
            if n != expected:
                raise AssertionError(f"{k}: {n} launches, expected {expected}")
        foe_err = []
        for i, fr in results.items():
            d = fr.to_dict()
            if d["drone_size_pixels"] == 0:
                # no target in the frame: the rates over the target's pixels
                # are 0/0 on the reference too
                for key in NAN_WITHOUT_TARGET:
                    d.pop(key)
            vals = np.array([v for x in d.values() for v in np.atleast_1d(x)],
                            np.float64)
            if not np.isfinite(vals).all():
                raise AssertionError(f"{w}x{h} frame {i}: non-finite {fr}")
            back = FrameResult.from_json_file(
                os.path.join(ds.results_path, f"image_{i:05d}.json"))
            if json.dumps(back.to_dict()) != json.dumps(fr.to_dict()):
                raise AssertionError(f"frame {i}: JSON does not round-trip")
            foe_err.append(float(np.hypot(*np.subtract(fr.foe_dense, fr.foe_gt))))

        # device time of one full batch's two steps (CUDA events), against
        # the wall time per batch of the run above
        staged = proc._stage_batch(list(range(batch)), FlowSource.FARNEBACK)
        flow = proc._flow_from_staged(staged)
        aux = [proc._to_dev(staged[k]) for k in
               ("gt_flow", "omegas", "dts", "segs", "skys", "depths", "gt_foes")]
        gen = torch.Generator(device=dev).manual_seed(0)
        step = proc._detection_step()
        flow_ms = time_ms(lambda: proc._flow_from_staged(staged), 10)
        detect_ms = time_ms(lambda: detect_frame_batch_scalars(
            flow, *aux, generator=gen, config=step), 10)
    batch_wall_ms = wall * 1e3 / -(-n_pairs // batch)
    return {
        "size": f"{w}x{h}", "frames": n_frames, "batch": batch,
        "pairs": n_pairs, "dataset_gen_s": gen_s, "wall_s": wall,
        "frames_per_s": n_pairs / wall, "launches": launches,
        "median_foe_err_px": float(np.median(foe_err)),
        "stages_ms": {k: v["total_s"] * 1e3 for k, v in proc.tracer.as_dict().items()},
        "device_ms_per_batch": {"flow": flow_ms, "detect": detect_ms},
        "wall_ms_per_batch": batch_wall_ms,
        "device_idle_share": 1.0 - (flow_ms + detect_ms) / batch_wall_ms,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    from mav_detection_tpu_torch import _build
    from mav_detection_tpu_torch.ops.flow import farneback_iter as fi
    from mav_detection_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    times = {}

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    times["device"] = time.perf_counter() - t0
    say(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
        f"{torch.backends.cudnn.allow_tf32} ({times['device']:.1f} s)")

    build_s = _build.build_seconds()
    regs = [ln.strip() for ln in _build.BUILD_LOG.splitlines()
            if "registers" in ln]
    times["build"] = build_s
    say(f"[build] csrc/farneback_iter.cu built in {build_s:.2f} s; "
        f"ptxas: {regs}")

    t0 = time.perf_counter()
    main_shape = phase_kernels(dev, 8, 480, 752, hires=False)
    hires_shape = phase_kernels(dev, 2, 1024, 1920, hires=True,
                                time_batches=(2, 4))
    times["kernels"] = time.perf_counter() - t0
    for r in (main_shape, hires_shape):
        say(f"[kernels] farneback_iterate_fused {r['shape']}: one iteration "
            f"max_abs_err {r['max_abs_err']} (tol 0, bit-exact), whole "
            f"schedule {r['schedule_err_px']} px (tol {SCHEDULE_TOL_PX}); "
            f"resources per tile {json.dumps(r['resources'])}")
        for tb, t in r["timings"].items():
            for lv in t["layers"]:
                say(f"[kernels]   {lv['shape']} x{lv['iterations']}: tile "
                    f"{lv['tile']} {lv['ms']:.5f} ms/launch, plain "
                    f"{lv['plain_ms']:.4f} ms, bound {lv['bound_ms']:.5f} ms "
                    f"({lv['bound_by']}), share of bound "
                    f"{lv['bound_ms'] / lv['ms']:.3f}; every tile "
                    f"{json.dumps(lv['tiles_ms'])}")
            say(f"[kernels]   b={tb}: kernel {t['ms_per_batch']:.5f} ms per "
                f"batch (bound {t['bound_ms_per_batch']:.5f}, plain "
                f"{t['plain_ms_per_batch']:.4f})")
    say(f"[kernels] ({times['kernels']:.1f} s)")

    t0 = time.perf_counter()
    acc = phase_accuracy(dev)
    times["accuracy"] = time.perf_counter() - t0
    say(f"[accuracy] EPE vs GT (16-px interior): {json.dumps(acc)} "
        f"({times['accuracy']:.1f} s)")

    t0 = time.perf_counter()
    runs = [phase_main_path(dev, 480, 752, 20, 8),
            phase_main_path(dev, 1024, 1920, 6, 4)]
    times["main_path"] = time.perf_counter() - t0
    for r in runs:
        say(f"[main path] {r['size']} {r['pairs']} pairs batch {r['batch']}: "
            f"{r['frames_per_s']:.2f} frames/s on {smi}, median FoE err "
            f"{r['median_foe_err_px']:.3f} px, launches {r['launches']}, "
            f"stages ms {json.dumps(r['stages_ms'])}, device ms per batch "
            f"{json.dumps(r['device_ms_per_batch'])} of {r['wall_ms_per_batch']:.3f} "
            f"ms wall (device idle share {r['device_idle_share']:.3f})")
    say(f"[phases] seconds {json.dumps(times)}")

    k = "farneback_iterate_fused"
    main_t = main_shape["timings"][8]
    fine = main_t["layers"][0]
    rows = [{
        "name": k, **KERNEL_ROWS[k],
        "launches": runs[0]["launches"][k],
        "max_abs_err": main_shape["max_abs_err"], "ms": fine["ms"],
        "plain_ms": fine["plain_ms"], "bound_ms": fine["bound_ms"],
        "bound_by": fine["bound_by"], "library_ms": None,
        "shape": fine["shape"], "tolerance": 0.0, "check": "pass",
        "schedule_err_px": main_shape["schedule_err_px"],
        "launches_1920x1024": runs[1]["launches"][k],
        "tile": fine["tile"], **main_shape["resources"][fine["tile"]],
        "per_batch": {f"{size} b={tb}": {
            key: t[key] for key in ("ms_per_batch", "bound_ms_per_batch",
                                    "plain_ms_per_batch")}
            for size, r in (("480x752", main_shape), ("1024x1920", hires_shape))
            for tb, t in r["timings"].items()},
        "hires": {"shape": hires_shape["timings"][2]["layers"][0]["shape"],
                  **{key: hires_shape["timings"][2]["layers"][0][key] for key in
                     ("ms", "plain_ms", "bound_ms")},
                  "max_abs_err": hires_shape["max_abs_err"],
                  "schedule_err_px": hires_shape["schedule_err_px"]},
    }]
    say(json.dumps({"kernels": rows,
                    "main_path": [{k: r[k] for k in (
                        "size", "frames_per_s", "median_foe_err_px",
                        "device_ms_per_batch", "wall_ms_per_batch",
                        "device_idle_share")} for r in runs]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
