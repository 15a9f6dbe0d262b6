#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``mav_detection_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --multi 4     # four cards: phase ``multi`` at world
                                        # size 4, then dryrun_multichip(4)

Phases, each printing one line (plus its seconds):
  1. device  — the card's name and power limit (nvidia-smi); fails without a
               card.
  2. build   — compiles csrc/farneback_iter.cu with nvcc for sm_90a and
               runtime/native/loader.cpp with g++, both started together.
  3. kernels — the iteration against its plain PyTorch version on the card,
               on coefficients of a seeded scene at the main paths' shapes
               (480x752 b=8 S=8, 1024x1920 b=2 S=16, and the scan engine's
               b=1 at both sizes): farneback_iterate_fused as scheduled
               (row-streaming strips, or the tile design's blocks on layers
               too short to stream), and forced onto strips and onto tiles
               (the yardstick) on every layer; one iteration of each bit-exact
               (torch.equal) at every pyramid layer, and the whole (2, 3, 8)
               level schedule; then timed in turns (tiled, fused, fused,
               tiled, and the strips twice where the schedule gives a layer
               tiles; CUDA events around a replayed CUDA graph of 50
               launches) at every layer (b=8 at 752x480, b=2 and b=4 at
               1920x1024, b=1 at both), each with the iteration's bound and
               its share, geometry or tile, its operations with the halo,
               registers, spills (ptxas), shared memory and blocks per SM,
               the plain version's time, the ms per batch of each, and the
               finest layers' shares against the 0.5 target.
 3b. probes  — the TPU probe kernels of tools/, ported as
               csrc/shift_probes.cu: shift_chain, shift_gather and the y
               stage in forms A, B, C, D and T, each equal (torch.equal) to
               its plain version on both axes, at S = 1, 8 and 16 and at
               sizes off the block; then, launch counters zeroed, the probe
               entry points (mav_detection_tpu_torch/tools/), each holding
               every kernel to its plain version at the size it times: the
               tools' defaults, the fused kernel's finest layer at b=8
               (3840x752; 160 bands of 24x752, sy per cell and in runs of
               32 columns) and its tile geometry (1440 tiles of 32x64, sy
               in runs of 32); each kernel's time per launch (a replayed
               CUDA graph) beside its bound, the plain versions' and
               grid_sample's times, the y stage's forms T and A as shares
               of a launch of each design at b=8 480x752 (T on the tiles'
               geometry against its prediction), and
               batch_overhead_probe (ms per frame per iteration, full,
               kernel and glue, at b=1 and b=8).
  4. accuracy — flow EPE with the product's tuned_flow_params on the
               16-px interior of the scipy-rendered scene: vs its analytic
               GT < 0.40 px at 752x480, < 0.55 px at 1920x1024; vs
               bench.py's cv2 oracle call (0.4, 1, 12, 10, 8, 1.2, 0)
               < 0.1 px at 752x480 (the north star's first gate).
  5. main path — Processor.run_detection_foe with FARNEBACK flow at 480x752
               (12 frames, batch 8: the tail batch is padded) and 1024x1920
               (6 frames, batch 4), launch counters zeroed just before and
               read just after each run; every FrameResult field must be
               finite, FrameResult JSON is written and read back. Then the
               device time of one full batch's flow and detection steps
               (CUDA events) against the run's wall time per batch.
  6. modules  — every tensor function of the homography / Lucas-Kanade /
               debug-image surface (image ops, warps, motion fields, RANSAC
               fits, k-means, window search, flow history, corners, LK
               tracks, dense LK, sparse FoE and its trace ring) at 752x480 on
               the card against the same function of the port on the CPU
               with the same explicit draws; then the time per frame of
               corner selection, LK tracking, dense LK, k-means and the
               window search (host clock around a synchronised call). Then
               the tensor-code Farneback solvers the same way: update_matrices
               with each warp on a flow inside and one beyond the separable
               warp's reach, solve_flow, jacobi_level with fast on and off,
               and farneback_flow with warp="auto", fast=True.
  7. artifacts — the FoE loop (FARNEBACK, batch 8, 12 frames) with
               save_images on, into a temporary sequence directory: the
               four PNG sets, video.npz and the JSON counted and their
               shapes checked; seconds per frame of the artifacts stage.
  8. homography — --algorithm HOMOGRAPHY --flow-source FARNEBACK, 8 frames,
               plain and with use_sparse_of, on the card and on the CPU:
               per-frame IoU, the kernel's launches, stage times.
  9. lucas_kanade — sparse tracks and lk_dense_flow on the 752x480 bench
               scene against its analytic GT (track EPE < 0.12 px, dense
               interior EPE < 1.6 px, survivors >= 75 % of max_corners), then
               the FoE loop with --flow-source LUCAS_KANADE, 4 frames.
 10. scan    — Processor with engine="scan", FARNEBACK, 752x480, 12 frames:
               143 = 13 x 11 kernel launches, every field finite, JSON
               written and read back, every FrameResult field against the
               batch engine's on the same per-transition draws; the dense
               loop once more with torch.cuda.set_sync_debug_mode("error");
               wall and device ms per transition (device: a replayed CUDA
               graph of one transition) and the device idle share. Then 6
               frames with use_sparse_of (results/foe_sparse.npy), then
               1920x1024, 4 frames.
 11. native  — the loader's g++ build alone; 16 .flo files at 752x480
               written natively and read by numpy and the reverse, bit
               equal; the prefetcher in order within its depth; a truncated
               file raises; a PRECOMPUTED run of the main path from files on
               disk through the prefetcher against the same run through the
               numpy reader; ms per file of each reader.
 12. entry   — entry(): fn(*example_args) on the card, finite, the FoE inside
               the image and within 0.5 px of the same call on the CPU.
 13. nets    — the learned nets: both shipped checkpoints read from
               checkpoints/ by the port's own reader (the RAFT one migrated)
               and converted, with the time of each; SkyUNet card against
               CPU at 752x480 and its sky TPR / FPR against the scene's sky
               band; RAFT card against CPU (fp32 and bf16) at 240x320 and
               752x480, and its EPE against the analytic GT at 240x320 (8
               iterations), 752x480 (6) and 1920x1024 (the quarter-scale
               operating point); Processor.run_detection_foe with
               FlowSource.RAFT at 752x480 (12 frames, batch 8) and 1920x1024
               (6 frames, batch 4): frames/s, device ms per batch, idle
               share, escalation rungs, host looks per batch, every
               FrameResult finite; then the device ms of each RAFT stage at
               752x480 b=8 beside its bound.
 14. datasets — sequences on disk. MIDGARD layout at 752x480 (12 frames,
               written by SyntheticDataset(materialize_to=...)): the CLI with
               its defaults and --headless (PRECOMPUTED falling back to the
               fused Farneback kernel, 26 launches; the SkyUNet in the loop),
               again on the cached HRNet-layout masks, again with .flo files
               through the prefetcher (0 launches), and with --engine scan;
               every FrameResult JSON finite; card against CPU on 4 frames
               with the same draws (FoE 0.5 px, rates 0.02). Then without
               depths/: both engines keep the ones plane (sky_tpr the mask's
               share, sky_fpr NaN). A Paeth-filtered 752x480 RGB PNG decoded
               natively and by the plain loop, bit-equal, ms per frame of
               each. AirSim layout at 1920x1024: 7 mock captures collected,
               SimDataset synthesising GT flow on the card (card against CPU
               within 0.05 px), the FoE loop at batch 4 on GROUND_TRUTH and
               FARNEBACK flow (the kernel at S=16): frames/s, median FoE
               error, finite in-frame FoE. Each CLI run ends in the
               Validator (mode FLOW_UV: TinyYOLO on the imagery of the GT
               flow); its launches and seconds are counted apart.
 15. yolo    — TinyYOLO and what stands on it: the four shipped
               checkpoints read and converted, with the time of each; raw
               predictions and decoded boxes card against CPU at 240x320 and
               752x480 (fp32 and bf16); mean IoU and detection rate per mode
               on two fixtures against the JAX package's numbers
               (YOLO_JAX); forward and decode+NMS device time at 752x480
               b=8 (CUDA graph and events) beside their bounds, device
               activities per call, host looks per batch; the REST server
               in-process (12 frames per npz request: answers equal
               engine.predict, 4 concurrent posts, non-npz 400, requests/s);
               the CLI's bare defaults on a MIDGARD-layout copy without
               optical-flow/ (detection, then validation with the fused
               kernel's launches counted apart), the remote branch against
               the port's server (equal IoU stats), and --prepare-dataset in
               FLOW_FOE_YOLO mode.
 16. train   — training on the card (cli/train.py; no hand kernel, the
               trainers run none in the reference either): one update of
               each trainer's loss and optimizer chain from the shipped
               weights, card against CPU on the same scene draws (RAFT fp32
               and bf16 at 160x128 b=8, SkyUNet and TinyYOLO bf16 at 320x240
               b=8); train_raft, train_sky and train_yolo (APPEARANCE_RGB,
               FLOW_UV) resumed from the shipped weights for 2 chunks of 10
               steps with their selectors into a temporary
               MAV_CHECKPOINT_PATH: ms per step, steps/s, share of the bound
               (3x the forward's convolution FLOPs), max_memory_allocated,
               host looks inside and per chunk, one more step under the
               profiler (its device ops and idle share), the weights written
               and read back equal; the evals of the shipped checkpoints
               against the JAX package's numbers
               (tests/train_reference_numbers.py, TRAIN_EVAL_TOL); the CLI
               `--model all --steps 20 --chunk 10` in a subprocess, its
               three files read back; checkpoints/ byte-unchanged (sha256).
 17. tools   — trace_to around one 752x480 b=8 main-path batch (the ten
               device ops that take the most time; the fused kernel's
               launches counted); foe_angular_error_map card against CPU;
               run_demo on the mock client; the figures' numbers with
               matplotlib barred (nothing written).
 17b. tools_flow — the stage probes and flow sweeps of tools/, ported
               (mav_detection_tpu_torch/tools/), each main(...) once at the
               tool's frame size with the fused kernel's counter zeroed just
               before: pipeline_stage_probe (752x480, b=1 and 8: the flow
               stage split into the iterate per layer, the preprocessing
               matmuls and the glue, each beside its bound),
               iter_schedule_sweep (752x480 b=8: the control, the identity
               (6, 6, 6) and the product (2, 3, 8) schedules, EPE vs GT and
               vs the cv2 oracle computed here), hires_flow_sweep
               (1920x1024: levels {2, 3} x S {8, 16}, b=1 and 4),
               hires_pipeline_probe (the Processor loop on 7 mock AirSim
               captures at 1920x1024, the count phase datasets renders,
               --no-images: the compute loop; the link canary),
               raft_stage_probe (752x480: full forward at 1 and 6
               iterations, encoder, volumes, batch 8 against a loop),
               hires_raft_probe (1920x1024, batches 1, 2, 4), hires_lk_probe
               (1920x1024, b=1 and 8) and spatial_probe (1920x1024, the
               product's parameters: unsharded and the mesh of 1; P = 2 and
               4 run under --multi 4). Each tool's own checks gate the run
               (phase_tools_flow lists them); the whole of each result is
               written to build/chip_smoke/tools_flow.json.
 17c. tools_eval — the evaluation and RAFT-retraining tools of tools/,
               ported, each main(...) once with the fused kernel's counter
               zeroed just before: cross_domain_eval at its defaults
               (240x320, 3 seeds; the mock simulator at 128x96) against the
               rails of tests/test_cross_domain.py, and card against CPU on
               seed 1 and the mock captures; raft_advantage_probe at 240x320
               (tuned_flow_params: the fused kernel must launch), each
               family card against CPU; hires_eval at 1920x1024 against
               tests/test_hires.py's rails, device ms per frame beside each
               net's bound; foe_reference_scale cut to 60 frames at 480x256
               (3 frames past the frames >= 56 rule); then, into a temporary
               copy of checkpoints/ as MAV_CHECKPOINT_PATH, finetune_raft
               (20 steps, chunk 10; its shipped baseline against the JAX
               package's evals within TRAIN_EVAL_TOL, the candidate read
               back; its gates printed, failing after 20 steps as
               expected), soup_raft at alphas 0, 0.5 and 1 (alpha 0's evals
               equal the shipped weights', alpha 1's the candidate's) and
               pan_curriculum with 2 steps per phase (three sentinels; run
               again, every phase skipped); nothing ships unless its gates
               pass, and checkpoints/ stays byte-unchanged (sha256). The
               whole result goes to build/chip_smoke/tools_eval.json.
 18. multi   — the multi-device paths at world size 1 with NCCL, in one
               spawned rank (parallel/mesh.launch), each warmed up once and
               then timed with the launch counters zeroed: the data-parallel
               FoE loop (752x480, b=8, 12 frames) against the one-card
               loop's FrameResults and its pooled TPR/FPR; spatial
               Farneback at 1920x1024 against the unsharded separable
               solver (1e-3 px), beside the batched fused solver's b=1
               latency; the chunked engine on the 12-frame sequence against
               the scan engine; one data-parallel RAFT training chunk
               (160x128, b=8) against the one-card chunk (the reference's
               rtol 2e-2 / atol 1e-3). Frames/s, ms per pair, transition
               and step on the host clock; the fused kernel's launches on
               each path (none on spatial: tensor-code separable warp).
 19. bench   — python -m mav_detection_tpu_torch.bench (its main) at bench.py's
               sizes, bench.py's cv2 oracle and baseline call passed in, the
               fused kernel's counter zeroed just before: the chip-health
               canaries (a chained 2048^3 bf16 matmul and the bare iterate
               kernel at b=8 480x752, each a replayed CUDA graph, against this
               card's healthy bands; a DEGRADED verdict is printed), then the
               flow + detect headline at 752x480 b=8 and b=1 and 1920x1024 b=8
               from replayed CUDA graphs of the step, eager beside them; the
               bench's own gates (EPE vs cv2 < 0.1 px at 752x480, vs GT < 0.55
               px at 1920x1024); its one strict JSON line printed after its
               seconds. A null headline, a failed gate or no launch fails it.
``--multi N`` also runs spatial_probe on N cards (P = 2, 4, 8 up to N).
Then the nets, datasets, yolo, train, tools, tools_flow, tools_eval and
multi JSON line, the kernels JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises before that line and
exits non-zero; so does a machine without a card, or a directory without
the package.
"""
from __future__ import annotations

import collections
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# the card's timing (CUDA events; a replayed CUDA graph), the H100 SXM peaks
# and the bounds from them (the fused kernel's: bytes and operations)
from mav_detection_tpu_torch.models.layers import conv_flops as _conv_flops
from mav_detection_tpu_torch.utils.timing import bound_ms, fmt_share, graph_ms
from mav_detection_tpu_torch.utils.timing import nbytes as _nbytes
from mav_detection_tpu_torch.utils.timing import events_ms as time_ms

# One row per hand kernel: its route and source, the TPU kernel it replaces
# (file:line of the function), and the pl.pallas_call sites (file:line) of
# the repo that run that TPU kernel (tests/test_torch_probes.py holds every
# site of the repo to this table)
_PROBES_CU = "mav_detection_tpu_torch/csrc/shift_probes.cu"
KERNEL_ROWS = {
    "farneback_iterate_fused": dict(
        route="cuda", source="mav_detection_tpu_torch/csrc/farneback_iter.cu",
        replaces="mav_detection_tpu/ops/flow/farneback_pallas.py:328",
        sites=("mav_detection_tpu/ops/flow/farneback_pallas.py:419",
               "mav_detection_tpu/ops/flow/farneback_pallas.py:451",
               "tools/batch_overhead_probe.py:114")),
    "shift_chain": dict(route="cuda", source=_PROBES_CU,
                        replaces="tools/gather_probe.py:39",
                        sites=("tools/gather_probe.py:94",)),
    "shift_gather": dict(route="cuda", source=_PROBES_CU,
                         replaces="tools/gather_probe.py:56",
                         sites=("tools/gather_probe.py:94",)),
    # variants A-D of the chain probe's kernel; T is the port's two-tap form
    # of the same function (variant A's)
    **{f"y_stage_{v}": dict(route="cuda", source=_PROBES_CU,
                            replaces="tools/chain_probe.py:50",
                            sites=("tools/chain_probe.py:126",))
       for v in "ABCDT"},
    # replaces no pallas_call: the reference leaves the polynomial expansion
    # to XLA's dot (mav_detection_tpu/ops/flow/farneback.py::_poly_exp_pyr_cf)
    "farneback_expand": dict(route="cuda",
                             source="mav_detection_tpu_torch/csrc/farneback_expand.cu",
                             replaces=None, sites=()),
}
# the band kernel against the matmuls it replaces: within this share of the
# coefficients' largest magnitude (ROADMAP B9)
EXPAND_TOL = 1e-5
# the y stage's share of one farneback_iterate_fused launch at b=8 480x752,
# predicted in PERF.md before it was measured: the two-tap form T on
# the kernel's 32x64 tile geometry (1440 tiles), sy in runs of 32 columns
Y_STAGE_SHARE_PREDICTED = (0.45, 0.6)
SCHEDULE_TOL_PX = 1e-4   # whole schedule; one iteration must be exact
# bench.py's oracle call (pyr_scale, levels, winsize, iterations, poly_n,
# poly_sigma, flags) and its gate on the port's flow at 752x480
# (bench.py:238-243; the reference's flow reads 0.0495 px, BENCH_r05.json)
CV2_ORACLE_ARGS = (0.4, 1, 12, 10, 8, 1.2, 0)
CV2_GATE_PX = 0.1
NAN_WITHOUT_TARGET = ("tpr", "tpr_fixed", "drone_flow_pixels")

# nets phase gates. The JAX package's numbers on the same scipy renders
# (tests/nets_reference_numbers.py, CPU): RAFT EPE / drone EPE 0.21213 /
# 0.46367 px at 240x320 (8 iterations, seed 1), 3.41352 / 0.42099 px at
# 752x480 (6, seed 0), 1.80235 / 1.34495 px at 1920x1024 (quarter scale);
# SkyUNet TPR 1.0, FPR 0.0 at 752x480. 240x320 and the sky net keep the
# reference's rails (tests/test_cross_domain.py:53-62); the other two sizes
# have none there and are gated at the JAX number + 0.1 px.
RAFT_EPE_GATES = {  # size: (h, w, iters, seed, EPE gate, drone EPE gate)
    "320x240": (240, 320, 8, 1, 0.40, 2.0),
    "752x480": (480, 752, 6, 0, 3.41352 + 0.1, 0.42099 + 0.1),
    "1920x1024": (1024, 1920, None, 0, 1.80235 + 0.1, 1.34495 + 0.1),
}
SKY_TPR_MIN, SKY_FPR_MAX = 0.9, 0.05
# card against the port's CPU: fp32 (TF32 off) and the product bf16 config,
# whose convolutions round at other points in cuDNN and oneDNN
RAFT_CARD_CPU_TOL_PX = {"fp32": 0.02, "bf16": 0.5}
SKY_CARD_CPU_TOL = {"fp32": 1e-3, "bf16": 0.25}     # logits
SKY_MASK_AGREEMENT = 0.995

# yolo phase gates. The JAX package's mean IoU and detection rate per fixture
# and mode with the shipped per-mode checkpoints, on the CPU:
#     JAX_PLATFORMS=cpu python tests/yolo_reference_numbers.py
# (scored as mav_detection_tpu.cli.train.eval_yolo scores them; "holdout" is
# eval_yolo's fixture, "product" the 24-frame default SyntheticDataset). The
# card's mean IoU must lie within YOLO_IOU_TOL of it and its rate within one
# frame. docs/PERF_TPU.md's TPU-era figures are context, not gates.
YOLO_JAX = {
    "holdout FLOW_UV": (0.92667045147838, 1.0),
    "holdout FLOW_RADIAL": (0.8345997480097799, 0.9166666666666666),
    "holdout FLOW_FOE_YOLO": (0.9191497349503889, 1.0),
    "product FLOW_UV": (0.8108844140926488, 0.875),
    "product FLOW_RADIAL": (0.9266057277189753, 1.0),
    "product FLOW_FOE_YOLO": (0.8001393938594671, 0.875),
}
YOLO_FIXTURES = {
    "holdout": dict(seed=779, n_frames=12, drone_radius=11, drone_start=(240.0, 70.0),
                    drone_velocity=(-4.0, 3.0)),
    "product": {},
}
YOLO_IOU_TOL = 0.05
# TinyYOLO card against the port's CPU: raw predictions (logits), fp32 (TF32
# off) and the product bf16, whose 8-bit mantissa is 0.125 wide at the
# logits' largest magnitudes (~25) and which cuDNN and oneDNN round at other
# points (measured 0.56-0.63 logits at 240x320 and 752x480 on the H100);
# decoded boxes: kept boxes per frame may differ by YOLO_KEPT_DIFF, and each
# card box overlaps its best CPU box by at least YOLO_MATCHED_IOU
YOLO_CARD_CPU_TOL = {"fp32": 1e-3, "bf16": 1.0}
YOLO_KEPT_DIFF = {"fp32": 0, "bf16": 1}
YOLO_MATCHED_IOU = {"fp32": 0.99, "bf16": 0.9}
YOLO_NAMES = ("yolo", "yolo_flow_uv", "yolo_flow_radial", "yolo_flow_foe_yolo")


def say(msg: str) -> None:
    print(msg, flush=True)


def scene_batch(b: int, h: int, w: int, hires: bool):
    from mav_detection_tpu_torch.data.scene import hires_scene_kwargs, make_scene

    kw = hires_scene_kwargs(h, w) if hires else {}
    scenes = [make_scene(seed, h=h, w=w, **kw) for seed in range(b)]
    return (np.stack([s[0] for s in scenes]), np.stack([s[1] for s in scenes]),
            np.stack([s[2] for s in scenes]))


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
        R0, R1 = fb.poly_exp_pyr_pair_cf(p, c, smooth, lh, lw, params.poly_n,
                                         params.poly_sigma)
        flow = (g if k == 0 else fb.resize_linear_cf(g, (lh, lw)) * scale).contiguous()
        out.append((R0, R1, flow, fb.border_scale_map(lh, lw, dev),
                    fb._level_iter_count(params, k)))
    return p, c, out


def kernel_ptxas(log: str) -> dict:
    """Registers and spill bytes of every instance of the iteration's two
    designs, from nvcc's ``-Xptxas -v`` report: "strips m6" is the
    row-streaming kernel with m = 6 compiled in (m-1: the run-time-m
    kernel); "tiled 32x64 m6" the tile design on its 32x64 tile."""
    out, name = {}, None
    for ln in log.splitlines():
        fn = re.search(r"Compiling entry function '([^']+)'", ln)
        if fn:
            mangled = fn.group(1)
            st = re.search(r"iterate_strip_kernelILi(n?\d+)EE", mangled)
            tl = re.search(r"iterate_tiled_kernelILi(\d+)ELi(\d+)ELi(n?\d+)E", mangled)
            name = (f"strips m{st.group(1).replace('n', '-')}"
                    if st else f"tiled {tl.group(1)}x{tl.group(2)} m"
                    f"{tl.group(3).replace('n', '-')}" if tl else None)
            if name:
                out[name] = {}
            continue
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if name and sp:
            out[name].update(spill_stores=int(sp.group(1)), spill_loads=int(sp.group(2)))
        rg = re.search(r"Used (\d+) registers", ln)
        if name and rg:
            out[name]["registers"] = int(rg.group(1))
    return out


def phase_kernels(dev, b: int, h: int, w: int, hires: bool,
                  time_batches=None, ptxas=None) -> dict:
    """The iteration against the plain version at one main-path size:
    farneback_iterate_fused as scheduled (``fused_schedule``: row-streaming
    strips, or the tile design's blocks on layers too short to stream), and
    forced onto strips and onto tiles on every layer; one iteration of each
    ``torch.equal`` at every pyramid layer, the whole level schedule within
    SCHEDULE_TOL_PX. Then,
    for each batch size in ``time_batches``, every layer timed in turns (the
    tile design, farneback_iterate_fused twice, the tile design again; and
    the strips twice where the schedule gives the layer tiles; a replayed
    CUDA graph of 50 launches each), each with the iteration's bound and its
    share, geometry or tile, its operations with the halo against the
    iteration's, registers, spills, shared memory and blocks per SM
    (``ptxas``: kernel_ptxas of the build), the plain version's time, and
    the ms per batch of each."""
    import torch

    from mav_detection_tpu_torch.ops.flow import farneback as fb
    from mav_detection_tpu_torch.ops.flow import farneback_iter as fi

    params = fb.tuned_flow_params(h, w)
    S, win = params.max_shift, params.winsize
    m = win // 2
    nb = max([b, *(time_batches or ())])
    prev, curr, gt = scene_batch(nb, h, w, hires)
    p, c, levels = level_inputs(dev, prev[:b], curr[:b], gt[:b], params)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def launcher(design, bb, lh, lw):
        geo = {"fused": None, "strips": fi.strip_geometry(bb, lh, lw, win, S, sms),
               "tiled": fi.tile_for(bb, lh, lw, sms)}[design]
        return lambda *a: fi.iterate_fused_cuda(*a, geometry=geo)

    # one iteration at every layer, each way and the plain version on the
    # same inputs
    exact = []
    for R0, R1, flow0, border, _ in levels:
        lh, lw = flow0.shape[-2:]
        ref = fi.box_solve_ref(fi.update_matrices_ref(R0, R1, flow0, border, S), win)
        errs = {}
        for design in ("fused", "strips", "tiled"):
            out = torch.empty_like(flow0)
            launcher(design, b, lh, lw)(R0, R1, flow0, border, out, win, S)
            torch.cuda.synchronize()
            errs[design] = float((out - ref).abs().max())
            if not torch.equal(out, ref):
                raise AssertionError(f"{design} b={b} {lh}x{lw}: one iteration "
                                     f"not bit-exact ({errs[design]})")
        exact.append({"shape": f"b={b} {lh}x{lw}", "max_abs_err": errs})

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

    ptxas = ptxas or {}
    mm = 6 if m == 6 else -1
    timings = {}
    for tb in (time_batches or (b,)):
        lvs = levels if tb == b else level_inputs(
            dev, prev[:tb], curr[:tb], gt[:tb], params)[2]
        rows = []
        for R0, R1, flow, border, iters in lvs:
            lh, lw = flow.shape[-2:]
            o = torch.empty_like(flow)

            def timed(design):
                launch = launcher(design, tb, lh, lw)
                return graph_ms(lambda: launch(R0, R1, flow, border, o, win, S), 50)

            geo = fi.strip_geometry(tb, lh, lw, win, S, sms)
            sched = fi.fused_schedule(tb, lh, lw, win, S, sms)
            tile = fi.tile_for(tb, lh, lw, sms)
            turns = [("tiled", timed("tiled")), ("fused", timed("fused")),
                     ("fused", timed("fused")), ("tiled", timed("tiled"))]
            if sched != geo:
                turns += [("strips", timed("strips")), ("strips", timed("strips"))]
            plain = time_ms(lambda: fi.box_solve_ref(fi.update_matrices_ref(
                R0, R1, flow, border, S), win), 5, 1)
            bound = fi.fused_bound(tb, lh, lw, win)
            ops = fi.fused_ops(tb, lh, lw, win)
            strip_row = {"geometry": str(geo),
                         "ops_with_halo": fi.strip_ops(tb, lh, lw, win, S, geo),
                         **fi.fused_kernel_info(win, S, geo),
                         **{k: v for k, v in ptxas.get(f"strips m{mm}", {}).items()
                            if k.startswith("spill")}}
            tile_row = {"tile": "x".join(map(str, tile)),
                        "ops_with_halo": fi.tiled_ops(tb, lh, lw, win, S, tile),
                        **fi.fused_kernel_info(win, S, tile),
                        **{k: v for k, v in ptxas.get(
                            f"tiled {tile[0]}x{tile[1]} m{mm}", {}).items()
                           if k.startswith("spill")}}
            row = {"shape": f"b={tb} {lh}x{lw} S={S}", "iterations": iters,
                   "plain_ms": plain, "turns": [[d, t] for d, t in turns],
                   "ops": ops, "schedule": "strips" if sched == geo else "tiles"}
            for design, info in (("fused", strip_row if sched == geo else tile_row),
                                 ("strips", strip_row), ("tiled", tile_row)):
                ts = [t for d, t in turns if d == design] or [
                    t for d, t in turns if d == "fused"]
                ms = sum(ts) / len(ts)
                row[design] = {"ms": ms, "bound_ms": bound[0], "bound_by": bound[1],
                               "share": bound[0] / ms, **info}
            rows.append(row)
        timings[tb] = {"layers": rows,
                       "plain_ms_per_batch": sum(r["iterations"] * r["plain_ms"] for r in rows),
                       **{f"{d}_{k}_per_batch": sum(r["iterations"] * r[d][k] for r in rows)
                          for d in ("fused", "strips", "tiled") for k in ("ms", "bound_ms")}}
    return {"shape": f"b={b} {h}x{w} S={S}", "exact": exact,
            "max_abs_err": max(e["max_abs_err"]["fused"] for e in exact),
            "schedule_err_px": err_sched, "timings": timings}


def phase_expand(dev, shapes=((8, 480, 752), (8, 1024, 1920), (1, 480, 752),
                              (1, 1024, 1920)), reps: int = 20) -> dict:
    """The polynomial expansion's band kernel (``poly_exp_pyr_pair_cf``, both
    frames of each pair) at every layer of the product's pyramid, per
    (b, h, w) of ``shapes``: held within EXPAND_TOL of the plain version
    (the two matmuls on the card, TF32 off), then timed in turns (plain,
    kernel, kernel, plain; replayed CUDA graphs of ``reps`` calls) beside
    its bound (``expand_bound``), with its launches, tiles, registers,
    shared memory and blocks per SM, and the ms per batch of each."""
    import torch

    from mav_detection_tpu_torch.ops.flow import farneback as fb
    from mav_detection_tpu_torch.ops.flow import farneback_expand as fe

    out = []
    for b, h, w in shapes:
        g = torch.Generator(device=dev).manual_seed(h + b)
        prev, curr = (torch.rand(b, h, w, device=dev, generator=g) * 255 for _ in range(2))
        params = fb.tuned_flow_params(h, w)
        layers = []
        for scale in fb._pyramid_scales(h, w, params):
            sigma = (1.0 / scale - 1.0) * 0.5
            smooth = fb._gaussian_kernel(max(int(round(sigma * 5)) | 1, 3), sigma)
            lh, lw = int(round(h * scale)), int(round(w * scale))
            args = (h, w, lh, lw, smooth, params.poly_n, params.poly_sigma)
            a = (smooth, lh, lw, params.poly_n, params.poly_sigma)

            def kernel(a=a):
                return fb.poly_exp_pyr_pair_cf(prev, curr, *a)

            def plain(a=a):
                return fb.poly_exp_pyr_ref(prev, *a), fb.poly_exp_pyr_ref(curr, *a)

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(got, want))
            if not err <= EXPAND_TOL:
                raise AssertionError(f"expand b={b} {lh}x{lw} of {h}x{w}: {err} of the "
                                     f"coefficients' scale, over {EXPAND_TOL}")
            turns = [("plain", graph_ms(plain, reps)), ("kernel", graph_ms(kernel, reps)),
                     ("kernel", graph_ms(kernel, reps)), ("plain", graph_ms(plain, reps))]
            bands = fb._expand_bands_np(*args)
            bound, by = fe.expand_bound(2 * b, h, w, lh, lw,
                                        fb._expand_taps(h, w, lh, lw, smooth, params.poly_n))
            ms = sum(t for d, t in turns if d == "kernel") / 2
            launches = fb._expand_plan(args, 2 * b)
            layers.append({
                "shape": f"b={b} {lh}x{lw} of {h}x{w}", "Kv": bands.Kv, "Kh": bands.Kh,
                "ms": ms, "plain_ms": sum(t for d, t in turns if d == "plain") / 2,
                "bound_ms": bound, "bound_by": by, "share": bound / ms,
                "rel_err": err, "turns": [[d, t] for d, t in turns],
                "launches": [{**k._asdict(), **fe.kernel_info(k)} for k in launches]})
        out.append({"shape": f"b={b} {h}x{w}", "layers": layers,
                    **{f"{key}_per_batch": sum(lv[key] for lv in layers)
                       for key in ("ms", "plain_ms", "bound_ms")}})
    return {"shapes": out, "max_rel_err": max(lv["rel_err"] for r in out
                                              for lv in r["layers"])}


def _say_expand(ex: dict, smi: str, seconds: float) -> None:
    for r in ex["shapes"]:
        for lv in r["layers"]:
            ks = "; ".join(f"{k['kernel']} {k['th']}x{k['tw']} tile, {k['blocks']} blocks, "
                           f"{k['registers']} registers, {k['smem_bytes']} B shared, "
                           f"{k['blocks_per_sm']} per SM, local {k['local_bytes']} B"
                           for k in lv["launches"])
            say(f"[expand]   {lv['shape']} (bands {lv['Kv']} x {lv['Kh']} taps) on {smi}: "
                f"{lv['ms']:.5f} ms against the bound {lv['bound_ms']:.5f} ms "
                f"({lv['bound_by']}, share {lv['share']:.3f}); plain matmuls "
                f"{lv['plain_ms']:.5f} ms; relative error {lv['rel_err']:.3g}; in turns "
                f"{json.dumps([[d, round(t, 5)] for d, t in lv['turns']])}; {ks}")
        say(f"[expand]   {r['shape']} per batch: {r['ms_per_batch']:.5f} ms (bound "
            f"{r['bound_ms_per_batch']:.5f}, plain {r['plain_ms_per_batch']:.5f})")
    say(f"[expand] band kernel within {EXPAND_TOL} of the matmuls everywhere "
        f"(largest {ex['max_rel_err']:.3g}) ({seconds:.1f} s)")


def _expand_row(ex: dict, launches: dict) -> dict:
    """The kernels-line row of the band kernel: b=8 480x752, every layer,
    and the other shapes beside; ``launches``: the launches counted on each
    main-path run (``"launches"`` the batch engine's at 752x480)."""
    k = "farneback_expand"
    first, *rest = ex["shapes"]
    fine = first["layers"][0]
    return {"name": k, **KERNEL_ROWS[k], **launches,
            "max_rel_err": ex["max_rel_err"], "ms": fine["ms"], "plain_ms": fine["plain_ms"],
            "bound_ms": fine["bound_ms"], "bound_by": fine["bound_by"],
            "library_ms": fine["plain_ms"],
            "library_note": "the plain version is the two torch.matmul calls it replaces",
            "shape": fine["shape"], "tolerance": EXPAND_TOL, "check": "pass",
            "layers": first["layers"], "per_batch": {key: first[key] for key in (
                "ms_per_batch", "plain_ms_per_batch", "bound_ms_per_batch")},
            "other_shapes": rest}


def _library_lerp(x, sy, fy, S: int, axis: int):
    """The two-tap lerp of shift_gather as one grid_sample call (bilinear,
    border, corners aligned): the grid and the call."""
    import torch
    import torch.nn.functional as F

    nr, nc = x.shape
    rows, cols = (nr - 2 * S - 1, nc) if axis == 0 else (nr, nc - 2 * S - 1)
    r = torch.arange(rows, device=x.device, dtype=torch.float32)[:, None]
    c = torch.arange(cols, device=x.device, dtype=torch.float32)[None, :]
    t = sy[:rows, :cols] + S + fy[:rows, :cols]
    gy, gx = (r + t, c.expand(rows, cols)) if axis == 0 else (r.expand(rows, cols), c + t)
    grid = torch.stack([gx * (2.0 / (nc - 1)) - 1.0, gy * (2.0 / (nr - 1)) - 1.0], -1)
    x4, grid = x[None, None], grid[None].contiguous()
    return lambda: F.grid_sample(x4, grid, mode="bilinear", padding_mode="border",
                                 align_corners=True)


def phase_probes(dev, fine=(3840, 752, 160), tile=(32, 64, 1440),
                 tiled_ms_b8=None) -> dict:
    """The probe kernels of csrc/shift_probes.cu against their plain
    versions (torch.equal): both axes, S = 1 and 8 (compiled in) and 16 (the
    run-time-S instance), sizes on and off the block; then, with the launch
    counters zeroed, the probe entry points, each of which holds every
    kernel to its plain version at the size it times: at the tools'
    defaults, at the fused kernel's finest layer at b=8 (``fine``: shift
    rows, columns, y-stage bands of 24x752; the y stage with sy per cell
    and in runs of 32 columns), the y stage on the fused kernel's own tile
    geometry (``tile``: rows, columns, tiles; the same A-window cells per
    output, sy in runs of 32 columns), and batch_overhead_probe; then
    grid_sample's time at the finest layer. The y stage's shares are of
    farneback_iterate_fused's launch at b=8 480x752 (batch_overhead_probe)
    and of the tile design there (``tiled_ms_b8``, phase 3), whose tile
    geometry the probe was built to split."""
    import torch

    from mav_detection_tpu_torch.ops.flow import farneback_iter as fi
    from mav_detection_tpu_torch.ops.flow import shift_probes as sp
    from mav_detection_tpu_torch.tools import (
        batch_overhead_probe,
        chain_probe,
        gather_probe,
    )

    rng = np.random.default_rng(0)
    errs = {k: 0.0 for k in sp.KERNELS}
    checks = 0

    def hold(kernel, equal, err, tag):
        nonlocal checks
        errs[kernel] = max(errs[kernel], err)
        if not equal:
            raise AssertionError(f"{kernel} {tag}: differs from its plain "
                                 f"version by {err}")
        checks += 1

    def hold_now(kernel, got, want, tag):
        torch.cuda.synchronize()
        hold(kernel, torch.equal(got, want), float((got - want).abs().max()), tag)

    for S in (1, 8, 16):
        for axis in (0, 1):
            for rows, cols in ((37, 45), (64, 768)):
                tag = f"{rows}x{cols} S={S} axis={axis}"
                x, sy, fy = sp.shift_inputs(rng, rows, cols, S, axis, dev)
                chain = sp.shift_chain(x, sy, fy, S, axis)
                gather = sp.shift_gather(x, sy, fy, S, axis)
                hold_now("shift_chain", chain, sp.shift_chain_ref(x, sy, fy, S, axis), tag)
                hold_now("shift_gather", gather, sp.shift_gather_ref(x, sy, fy, S, axis), tag)
                if not torch.equal(gather, chain):
                    raise AssertionError(f"shift_gather {tag}: not exact against the chain")
        for th, tw, m, bands in ((5, 37, 3, 2), (24, 752, 6, 3)):
            g = sp.YGeometry(S, th, tw, m)
            tag = f"bands={bands} th={th} tw={tw} m={m} S={S}"
            slab, sy, fy = sp.y_stage_inputs(rng, g, bands, dev)
            outs = {v: sp.y_stage(slab, sy, fy, S, m, v) for v in sp.VARIANTS}
            for v, o in outs.items():
                hold_now(f"y_stage_{v}", o, sp.y_stage_ref(slab, sy, fy, S, m, v), tag)
            for v in chain_probe.EXACT_VS_A:
                if not torch.equal(outs[v], outs["A"]):
                    raise AssertionError(f"y_stage_{v} {tag}: not exact against A")

    rows, cols, bands = fine
    th, tw, tiles = tile
    sp.reset_launch_counts()
    fi.reset_launch_counts()
    runs = {"gather_default": gather_probe.main([], device=dev),
            "chain_default": chain_probe.main([], device=dev),
            "gather_fine": gather_probe.main(["--rows", str(rows), "--cols", str(cols),
                                              "--reps", "50"], device=dev),
            "chain_fine": chain_probe.main(["--bands", str(bands), "--reps", "50"],
                                           device=dev),
            "chain_fine_runs": chain_probe.main(["--bands", str(bands), "--reps", "50",
                                                 "--sy-run", "32"], device=dev),
            "chain_tile": chain_probe.main(["--th", str(th), "--tw", str(tw), "--bands",
                                            str(tiles), "--reps", "50", "--sy-run", "32"],
                                           device=dev),
            "batch_overhead": batch_overhead_probe.main([], device=dev)}
    torch.cuda.synchronize()
    launches = dict(sp.LAUNCHES)
    fused_launches = fi.LAUNCHES["farneback_iterate_fused"]
    missing = [k for k, n in launches.items() if n == 0]
    if missing or fused_launches == 0:
        raise AssertionError(f"probes: no launch of {missing or 'the fused kernel'}")
    # every kernel at every size the probes timed, against its plain version
    for name, run in runs.items():
        for a in run.get("axes", ()):
            tag = f"{name} {run['rows']}x{run['cols']} axis={a['axis']}"
            for k in ("shift_chain", "shift_gather"):
                hold(k, a[k]["equal_to_plain"], a[k]["max_abs_err"], tag)
            if not a["exact_vs_chain"]:
                raise AssertionError(f"shift_gather {tag}: not exact against the chain")
        for v, r in run.get("variants", {}).items():
            tag = f"{name} bands={run['bands']} th={run['th']} tw={run['tw']}"
            hold(f"y_stage_{v}", r["equal_to_plain"], r["max_abs_err"], tag)
            if v in chain_probe.EXACT_VS_A and r["max_diff_vs_A"] != 0.0:
                raise AssertionError(f"y_stage_{v} {tag}: not exact against A")

    # grid_sample at the finest layer, on the probe's draws
    library, lib_err = [], {}
    rng = np.random.default_rng(0)
    for axis in (0, 1):
        x, sy, fy = sp.shift_inputs(rng, rows, cols, 8, axis, dev)
        lib = _library_lerp(x, sy, fy, 8, axis)
        library.append(time_ms(lib, 10, 2))
        lib_err[axis] = float((lib()[0, 0] - sp.shift_gather(x, sy, fy, 8, axis)).abs().max())
    sp.reset_launch_counts()   # the comparisons' launches do not count
    # at the finest layer's shapes (the y stage's block follows its rows)
    fine_mrows = sp.YGeometry(8, 24, 752, 6).mrows
    resources = {k: sp.kernel_info(k, 8, mrows=fine_mrows) for k in sp.KERNELS}

    fused_ms = runs["batch_overhead"]["batches"][1]["kernel_ms_per_launch"]
    launch_ms = {"fused": fused_ms, **({"tiled": tiled_ms_b8} if tiled_ms_b8 else {})}
    shares = {d: {f"{v} {r}": runs[r]["variants"][v]["us"] / 1e3 / ms
                  for r in ("chain_fine", "chain_fine_runs", "chain_tile")
                  for v in ("T", "A")} for d, ms in launch_ms.items()}
    return {"checks": checks, "max_abs_err": errs, "launches": launches,
            "fused_launches": fused_launches, "runs": runs,
            "library_ms": library, "library_max_abs_diff": lib_err,
            "resources": resources, "launch_ms_b8": launch_ms, "shares": shares}


def phase_accuracy(dev) -> dict:
    """EPE of the port's flow with the product's ``tuned_flow_params`` on
    the 16-px interior of the bench scene: against the analytic GT at both
    sizes, and at 752x480 against bench.py's cv2 oracle call (the north
    star's first gate, < 0.1 px)."""
    import cv2
    import torch

    from mav_detection_tpu_torch.data.scene import (
        epe_interior,
        hires_scene_kwargs,
        make_scene,
    )
    from mav_detection_tpu_torch.ops.flow import farneback_flow, tuned_flow_params

    res = {}
    for (h, w), gate, kw in (((480, 752), 0.40, {}),
                             ((1024, 1920), 0.55, None)):
        kw = hires_scene_kwargs(h, w) if kw is None else kw
        prev, curr, gt = make_scene(0, h=h, w=w, **kw)
        flow = farneback_flow(prev, curr, tuned_flow_params(h, w), device=dev)
        torch.cuda.synchronize()
        flow = flow.cpu().numpy()
        epe = epe_interior(flow, gt)
        if not epe < gate:
            raise AssertionError(f"{w}x{h}: EPE vs GT {epe} px >= {gate}")
        res[f"{w}x{h}"] = {"epe_gt_px": epe, "gate_px": gate}
        if (h, w) == (480, 752):
            ref = cv2.calcOpticalFlowFarneback(prev, curr, None, *CV2_ORACLE_ARGS)
            epe_cv2 = epe_interior(flow, ref)
            if not epe_cv2 < CV2_GATE_PX:
                raise AssertionError(f"{w}x{h}: EPE vs cv2 {epe_cv2} px >= {CV2_GATE_PX}")
            res[f"{w}x{h}"].update(epe_cv2_px=epe_cv2, cv2_gate_px=CV2_GATE_PX)
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
    cfg.get_dataset = lambda **_: SyntheticDataset(params=sp)
    t0 = time.perf_counter()
    proc = Processor(cfg, device=dev)
    proc.save_images = False       # a throughput run: JSON only
    gen_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        ds = proc.dataset
        ds.seq_path = tmp
        ds.results_path = os.path.join(tmp, "results")
        proc.run_detection_foe()                       # warm-up run
        torch.cuda.synchronize()
        proc.tracer = Tracer()
        proc.detection_results = {}
        _reset_launches()
        t0 = time.perf_counter()
        results = proc.run_detection_foe()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
        n_pairs = n_frames - 1
        if sorted(results) != list(range(n_pairs)):
            raise AssertionError(f"{w}x{h}: results for {sorted(results)}")
        params = proc._farneback
        per_batch = sum(fb._level_iter_count(params, k)
                        for k in range(len(fb._pyramid_scales(h, w, params))))
        expected = per_batch * -(-n_pairs // batch)
        for k in fi.KERNELS:
            if launches[k] != expected:
                raise AssertionError(f"{k}: {launches[k]} launches, expected {expected}")
        # the band kernel: 1 + 1 + 2 launches a batch (two passes on the
        # coarsest layer), for both frames of each pair
        if _expand_per_call(params, h, w) != 4:
            raise AssertionError(f"{w}x{h}: band kernel plan of "
                                 f"{_expand_per_call(params, h, w)} launches a batch")
        _hold_expand(f"main path {w}x{h}", launches, params, h, w)
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
        flow = proc._flow_from_staged(staged, FlowSource.FARNEBACK)
        aux = [proc._to_dev(staged[k]) for k in
               ("gt_flow", "omegas", "dts", "segs", "skys", "depths", "gt_foes")]
        gen = torch.Generator(device=dev).manual_seed(0)
        step = proc._detection_step()
        flow_ms = time_ms(lambda: proc._flow_from_staged(
            staged, FlowSource.FARNEBACK), 10)
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


def wall_ms(fn, reps: int = 3, warm: int = 1) -> float:
    """Mean ms per call on the host's clock, the card synchronised before
    and after: for functions that are sequences of small launches with a
    look from the host in between, where the user waits for both."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


class Checks:
    """Card-vs-CPU comparisons of one phase: every row is printed, and the
    phase fails after the last one if any missed its tolerance."""

    def __init__(self, phase: str) -> None:
        self.phase = phase
        self.rows = []

    def add(self, name: str, value: float, tol: float, what: str,
            at_least: bool = False) -> None:
        ok = bool(value >= tol if at_least else value <= tol)
        self.rows.append((name, ok))
        say(f"[{self.phase}]   {name}: {what} {value:.6g} "
            f"({'>=' if at_least else '<='} {tol:g}) {'ok' if ok else 'MISS'}")

    def finish(self) -> int:
        missed = [n for n, ok in self.rows if not ok]
        if missed:
            raise AssertionError(f"{self.phase}: out of tolerance: {missed}")
        return len(self.rows)


def _np(t):
    return t.detach().cpu().numpy()


def _both(fn, dev, *arrays):
    """``fn`` on the card and on the CPU over the same numpy inputs."""
    import torch

    outs = []
    for d in (dev, torch.device("cpu")):
        outs.append(fn(*(torch.as_tensor(a).to(d) if isinstance(a, np.ndarray)
                         else a for a in arrays)))
    return outs


def _distinct_sets(rng, n: int, k: int, size: int) -> np.ndarray:
    """(k, size) index sets, distinct within a set: a repeated point makes a
    minimal system rank-deficient, and then any vector of its null space is
    a right answer (LAPACK and cuSOLVER return different ones)."""
    return np.argsort(rng.random((k, n)), axis=1)[:, :size]


def phase_modules(dev) -> dict:
    import torch

    from mav_detection_tpu_torch.ops.flow import lucas_kanade as lk
    from mav_detection_tpu_torch.ops.geometry import boxsearch as bs
    from mav_detection_tpu_torch.ops.geometry import foe as foe_mod
    from mav_detection_tpu_torch.ops.geometry import global_motion as gm
    from mav_detection_tpu_torch.ops.geometry.kmeans import cluster_image, kmeans
    from mav_detection_tpu_torch.ops.geometry import ransac_fits as rf
    from mav_detection_tpu_torch.ops.geometry import warp
    from mav_detection_tpu_torch.ops.image import color, visualize
    from mav_detection_tpu_torch.ops.image.resize import resize

    h, w = 480, 752
    rng = np.random.default_rng(0)
    prev8, curr8, gt = (a[0] for a in scene_batch(1, h, w, hires=False))
    prev, curr = prev8.astype(np.float32), curr8.astype(np.float32)
    unit = prev / 255.0
    ck = Checks("modules")

    def levels(a, b):
        d = np.abs(_np(a).astype(np.float64) - _np(b).astype(np.float64))
        return float(d.max()), float((d == 0).mean())

    # ---- image ops
    for name, fn in (("flow_to_color_device", visualize.flow_to_color_device),
                     ("flow_radial_device", visualize.flow_radial_device)):
        worst, same = levels(*_both(fn, dev, gt))
        ck.add(name, worst, 1.0, "max grey-level difference")
        ck.add(name + " equal share", same, 0.99, "share of equal values", True)
    a, b = _both(lambda x: resize(x, (320, 501)), dev, unit)
    ck.add("resize linear", float(np.abs(_np(a) - _np(b)).max()), 1e-5, "max abs")
    a, b = _both(lambda x: resize(x, (320, 501), "nearest"), dev, unit)
    ck.add("resize nearest", float((_np(a) != _np(b)).sum()), 0, "differing values")
    bgr8 = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    for name, fn in (("bgr_to_gray", color.bgr_to_gray), ("rgb_to_gray", color.rgb_to_gray)):
        worst, same = levels(*_both(fn, dev, bgr8))
        ck.add(name + " uint8", worst, 1.0, "max grey-level difference")
        ck.add(name + " uint8 equal share", same, 0.999, "share equal", True)
        a, b = _both(fn, dev, bgr8.astype(np.float32))
        ck.add(name + " float", float(np.abs(_np(a) - _np(b)).max()), 1e-4, "max abs")

    # ---- warps and motion fields (an fp32 coordinate near 752 has an ulp of
    # 6e-5, and the card contracts a*x + b into one fused multiply-add)
    mx = rng.uniform(-2.5, w + 1.5, (h, w)).astype(np.float32)
    my = rng.uniform(-2.5, h + 1.5, (h, w)).astype(np.float32)
    flow2 = gt + rng.normal(scale=0.05, size=gt.shape).astype(np.float32)
    for name, fn in (("remap_bilinear", warp.remap_bilinear),
                     ("sample_bilinear_replicate", warp.sample_bilinear_replicate)):
        for tag, img in (("hw", unit), ("hwc", flow2)):
            a, b = _both(fn, dev, img, mx, my)
            ck.add(f"{name} {tag}", float(np.abs(_np(a) - _np(b)).max()), 1e-5, "max abs")
    A = np.array([[1.02, 0.03, -1.5], [-0.02, 0.98, 2.25]], np.float32)
    Hm = np.array([[1.01, 0.02, -2.0], [-0.015, 0.99, 1.5], [1e-5, -2e-5, 1.0]], np.float32)
    a, b = _both(warp.warp_affine, dev, unit, A)
    ck.add("warp_affine", float(np.abs(_np(a) - _np(b)).max()), 1e-3, "max abs")
    a, b = _both(warp.warp_perspective, dev, unit, Hm)
    ck.add("warp_perspective", float(np.abs(_np(a) - _np(b)).max()), 1e-3, "max abs")
    a, b = _both(lambda m: gm.affine_motion_field(m, h, w), dev, A)
    ck.add("affine_motion_field", float(np.abs(_np(a) - _np(b)).max()), 2e-4, "max abs px")
    for proj in (False, True):
        a, b = _both(lambda m: gm.homography_motion_field(m, h, w, proj), dev, Hm)
        ck.add(f"homography_motion_field projective={proj}",
               float(np.abs(_np(a) - _np(b)).max()), 2e-4, "max abs px")
    for homog, M in ((False, A), (True, Hm)):
        a, b = _both(lambda f, m: gm.warp_diff_method(f, m, homog)[1], dev, flow2, M)
        ck.add(f"warp_diff_method homography={homog}",
               float(np.abs(_np(a) - _np(b)).max()), 1e-3, "max abs px")

    # ---- RANSAC fits on correspondences of the scene's flow
    n = 2000
    sy = rng.integers(20, h - 20, n)
    sx = rng.integers(20, w - 20, n)
    p0 = np.stack([sx, sy], 1).astype(np.float32)
    p1 = p0 + gt[sy, sx] + rng.normal(scale=0.1, size=(n, 2)).astype(np.float32)
    bad = rng.random(n) < 0.15
    p1[bad] += rng.uniform(-20, 20, (int(bad.sum()), 2)).astype(np.float32)
    a, b = _both(lambda x, y: gm.homography_motion_field(
        rf.fit_homography_lstsq(x, y), h, w), dev, p0, p1)
    ck.add("fit_homography_lstsq field", float(np.abs(_np(a) - _np(b)).max()), 0.02,
           "max abs px")
    for name, fit, size, field in (
            ("fit_affine_ransac", rf.fit_affine_ransac, 3,
             lambda m: gm.affine_motion_field(m, h, w)),
            ("fit_homography_ransac", rf.fit_homography_ransac, 4,
             lambda m: gm.homography_motion_field(m, h, w))):
        idx = _distinct_sets(rng, n, 256, size)
        (Ma, ia), (Mb, ib) = _both(lambda x, y, i: fit(x, y, idx=i), dev, p0, p1, idx)
        ck.add(name + " inliers", float((_np(ia) == _np(ib)).mean()), 0.995,
               "share of equal mask entries", True)
        # points that sit on the threshold may fall either way (a few of
        # 2000), and the refit over the other set moves the far corners
        ck.add(name + " field", float(np.abs(_np(field(Ma)) - _np(field(Mb))).max()),
               0.1, "max abs px")
    # a rigid camera motion for the epipolar fits
    z = rng.uniform(4.0, 12.0, n)
    f = 400.0
    X = np.stack([(p0[:, 0] - w / 2) * z / f, (p0[:, 1] - h / 2) * z / f, z], 1)
    ang = 0.02
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    X1 = X @ R.T + np.array([0.3, -0.1, 0.2])
    q1 = np.stack([X1[:, 0] / X1[:, 2] * f + w / 2, X1[:, 1] / X1[:, 2] * f + h / 2], 1)
    q1 = (q1 + rng.normal(scale=0.1, size=q1.shape)).astype(np.float32)
    q1[bad] += rng.uniform(-20, 20, (int(bad.sum()), 2)).astype(np.float32)
    idx8 = _distinct_sets(rng, n, 256, 8)
    E_card = None
    for name, fit, scale in (
            ("fit_fundamental_ransac", lambda x, y, i: rf.fit_fundamental_ransac(x, y, idx=i), 1.0),
            ("fit_essential_ransac", lambda x, y, i: rf.fit_essential_ransac(
                x, y, idx=i, focal=f), f)):
        (Fa, ia), (Fb, ib) = _both(fit, dev, p0, q1, idx8)
        da = _np(rf._sampson_dist(Fa.cpu(), torch.as_tensor(p0 / scale), torch.as_tensor(q1 / scale)))
        db = _np(rf._sampson_dist(Fb, torch.as_tensor(p0 / scale), torch.as_tensor(q1 / scale)))
        both_in = _np(ia) & _np(ib)
        ck.add(name + " inliers", float((_np(ia) == _np(ib)).mean()), 0.99,
               "share of equal mask entries", True)
        ck.add(name + " Sampson", float(np.abs(da - db)[both_in].max() * scale), 1e-2,
               "max abs px over common inliers")
        sign = np.sign((_np(Fa) * _np(Fb)).sum())
        ck.add(name + " matrix up to sign", float(np.abs(sign * _np(Fa) - _np(Fb)).max()),
               5e-3, "max abs")
        E_card = Fa
    (R1a, R2a, ta), (R1b, R2b, tb) = _both(rf.decompose_essential, dev, _np(E_card))
    rot = max(min(float(np.abs(_np(g) - _np(r)).max()) for r in (R1b, R2b))
              for g in (R1a, R2a))
    ck.add("decompose_essential rotations (as a set)", rot, 1e-4, "max abs")
    ck.add("decompose_essential t up to sign",
           min(float(np.abs(_np(ta) - _np(tb)).max()), float(np.abs(_np(ta) + _np(tb)).max())),
           1e-4, "max abs")
    a, b = _both(rf.rotation_matrix_to_euler, dev, _np(R1b))
    ck.add("rotation_matrix_to_euler", float(np.abs(_np(a) - _np(b)).max()), 1e-4, "max abs deg")

    # ---- k-means on the residual magnitude of the homography path
    Hfit = rf.fit_homography_lstsq(torch.as_tensor(p0), torch.as_tensor(p1))
    mag = _np(gm.subtract_global_motion(torch.as_tensor(flow2),
                                        gm.homography_motion_field(Hfit, h, w))[1])
    init = np.stack([rng.permutation(h * w)[:8] for _ in range(10)])
    (ca, la, cea), (cb, lb, ceb) = _both(lambda x, i: kmeans(x.reshape(-1, 1), i),
                                         dev, mag, init)
    ck.add("kmeans centers", float((np.abs(_np(cea) - _np(ceb)) / np.abs(_np(ceb)).max()).max()),
           1e-3, "max relative")
    ck.add("kmeans labels", float((_np(la) == _np(lb)).mean()), 0.999, "share equal", True)
    (qa, ma), (qb, mb) = _both(cluster_image, dev, mag, init)
    ck.add("cluster_image mask", float((_np(ma) == _np(mb)).mean()), 0.999, "share equal", True)

    # ---- window search. Scores come from fp32 prefix sums, which the card
    # takes in another order: a textured signed image has no two windows or
    # moves that tie to rounding (the clustered images of the homography run
    # do, see that phase)
    tex = (rng.gamma(1.5, 1.0, (h, w)) - 1.2).astype(np.float32)
    tex[150:260, 300:470] += 2.5
    ra, rb_ = _both(bs.analyze_pyramid, dev, tex)
    ck.add("analyze_pyramid box", float(np.abs(_np(ra.box_xywh) - _np(rb_.box_xywh)).max()),
           0, "max abs px")
    ck.add("analyze_pyramid level", abs(int(ra.level) - int(rb_.level)), 0, "difference")
    ck.add("analyze_pyramid score", abs(float(ra.score) / float(rb_.score) - 1), 1e-4, "relative")
    (sa, ba), (sb, bb) = _both(bs.optimize_window, dev, tex, _np(rb_.box_xywh))
    ck.add("optimize_window box", float(np.abs(_np(ba) - _np(bb)).max()), 0, "max abs px")
    ck.add("optimize_window score", abs(float(sa) / float(sb) - 1), 1e-4, "relative")

    def history(d):
        hist = bs.make_flow_history(3, h, w, d)
        for k in range(4):
            hist = bs.push_flow(hist, torch.as_tensor(flow2 * (0.5 + 0.25 * k)).to(d))
        return bs.accumulated_flow(hist)
    ck.add("accumulated_flow", float(np.abs(_np(history(dev)) - _np(history(torch.device("cpu")))).max()),
           1e-3, "max abs px")

    # ---- corners, tracks, dense LK
    ca_, cb_ = _both(lambda x: lk.shi_tomasi_corners(x, quality_level=0.05), dev, prev)

    def corner_set(c):
        return {tuple(p) for p, v in zip(_np(c.points).tolist(), _np(c.valid).tolist()) if v}
    common = len(corner_set(ca_) & corner_set(cb_)) / max(len(corner_set(cb_)), 1)
    # near-equal responses may swap their order in the greedy sweep
    ck.add("shi_tomasi_corners common", common, 0.99, "share of the CPU's corners", True)
    pts = _np(cb_.points)
    ta_, tb_ = _both(lk.lucas_kanade_track, dev, prev, curr, pts)
    held = (_np(tb_.status) & _np(cb_.valid) & (pts[:, 0] >= 10) & (pts[:, 0] <= w - 11)
            & (pts[:, 1] >= 10) & (pts[:, 1] <= h - 11))
    ck.add("lucas_kanade_track points", float(np.abs(_np(ta_.points) - _np(tb_.points))[held].max()),
           1e-2, f"max abs px over {int(held.sum())} inner tracked features")
    ck.add("lucas_kanade_track status", float((_np(ta_.status) == _np(tb_.status)).mean()), 0.995,
           "share equal", True)
    da_, db_ = _both(lk.lk_dense_flow, dev, prev, curr)
    dd = np.abs(_np(da_) - _np(db_)).max(-1)
    # the scatter-add's order is not fixed on the card, and a corner that
    # differs moves the field around it
    ck.add("lk_dense_flow p99", float(np.percentile(dd, 99)), 2e-2, "99th percentile abs px")
    ck.add("lk_dense_flow mean", float(dd.mean()), 2e-2, "mean abs px")
    pool_valid = rng.random(2000) < 0.5
    pa, pb = _both(lambda p, v, x: lk.replenish_features(lk.FeaturePool(p, v), x).valid,
                   dev, pts, pool_valid, prev)
    ck.add("replenish_features valid", float((_np(pa) == _np(pb)).mean()), 0.99, "share equal", True)

    # ---- sparse FoE on those tracks; its line intersections divide a
    # cancelling difference by a small determinant, and the card fuses
    # multiply-adds: 0.05 px as for XLA in tests/test_torch_foe_sparse.py
    ok = _np(tb_.status) & _np(cb_.valid)
    perm = rng.permutation(len(pts))
    for tag, pm in (("rolled", None), ("permuted", perm)):
        a, b = _both(lambda o, nw, v: foe_mod.get_foe_sparse(o, nw, v, perm=pm),
                     dev, pts, _np(tb_.points), ok)
        ck.add(f"get_foe_sparse {tag}", float(np.abs(_np(a) - _np(b)).max()), 0.05, "max abs px")

    def traced(d, pm):
        st = foe_mod.trace_init(len(pts), device=d)
        r2 = np.random.default_rng(1)
        cur = pts.astype(np.float64)
        for k in range(25):
            st = foe_mod.trace_update(
                st, torch.as_tensor(cur.astype(np.float32)).to(d),
                torch.as_tensor(ok).to(d),
                torch.zeros(len(pts), dtype=torch.bool, device=d))
            cur = cur + 0.01 * (cur - np.array([310.0, 190.0])) + r2.normal(scale=0.2, size=cur.shape)
        return foe_mod.get_foe_sparse_traced(st, perm=pm)
    for tag, pm in (("rolled", None), ("permuted", perm)):
        ck.add(f"get_foe_sparse_traced {tag}",
               float(np.abs(_np(traced(dev, pm)) - _np(traced(torch.device("cpu"), pm))).max()),
               0.05, "max abs px")
    n_checks = ck.finish()

    # ---- time per frame at 752x480 (host clock, synchronised)
    prev_d = torch.as_tensor(prev).to(dev)
    curr_d = torch.as_tensor(curr).to(dev)
    pts_d = torch.as_tensor(pts).to(dev)
    mag_d = torch.as_tensor(mag).to(dev)
    init_d = torch.as_tensor(init).to(dev)
    quant_d, mask_d = cluster_image(mag_d, init_d)
    masked = torch.where(mask_d, mag_d, torch.zeros_like(mag_d))
    box0 = bs.analyze_pyramid(quant_d.float()).box_xywh
    sweeps = []
    real_sweep = lk._greedy_min_distance

    def counting_sweep(*a, **k):
        before = torch.cuda.Event(enable_timing=True)
        after = torch.cuda.Event(enable_timing=True)
        before.record()
        out = real_sweep(*a, **k)
        after.record()
        sweeps.append((before, after))
        return out
    timings = {
        "shi_tomasi_corners (2000 of 8000 candidates)": wall_ms(
            lambda: lk.shi_tomasi_corners(prev_d, quality_level=0.05)),
        "lucas_kanade_track (2000 features)": wall_ms(
            lambda: lk.lucas_kanade_track(prev_d, curr_d, pts_d)),
        "lk_dense_flow": wall_ms(lambda: lk.lk_dense_flow(prev_d, curr_d)),
        "cluster_image (k-means 10x10)": wall_ms(lambda: cluster_image(mag_d, init_d)),
        "analyze_pyramid": wall_ms(lambda: bs.analyze_pyramid(quant_d.float())),
        "optimize_window": wall_ms(lambda: bs.optimize_window(masked, box0)),
        "fit_homography_lstsq (1000 points)": wall_ms(
            lambda: rf.fit_homography_lstsq(torch.as_tensor(p0[:1000]).to(dev),
                                            torch.as_tensor(p1[:1000]).to(dev))),
    }
    lk._greedy_min_distance = counting_sweep
    try:
        lk.shi_tomasi_corners(prev_d, quality_level=0.05)
        torch.cuda.synchronize()
    finally:
        lk._greedy_min_distance = real_sweep
    timings["corner sweep alone"] = sweeps[0][0].elapsed_time(sweeps[0][1])
    return {"checks": n_checks, "ms_per_frame": timings,
            "corners": int(_np(ca_.valid).sum())}


def _synthetic_processor(dev, h, w, n_frames, batch, tmp, **cfg_kw):
    """A Processor over the in-repo synthetic sequence, its sequence
    directory pointed at ``tmp`` (nothing is materialised: frames stay in
    memory, results and images go to ``tmp``)."""
    from mav_detection_tpu_torch.core.config import RunConfig
    from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
    from mav_detection_tpu_torch.pipeline.processor import Processor

    cfg = RunConfig(dataset="synthetic", batch_size=batch, headless=True, **cfg_kw)
    sp = SyntheticParams(height=h, width=w, n_frames=n_frames)
    cfg.get_dataset = lambda **_: SyntheticDataset(params=sp)
    proc = Processor(cfg, device=dev)
    if tmp:
        proc.dataset.seq_path = tmp
        proc.dataset.results_path = os.path.join(tmp, "results")
    return proc


def phase_artifacts(dev) -> dict:
    import torch

    from mav_detection_tpu_torch.data.dataset import imread

    h, w, n_frames, batch = 480, 752, 12, 8
    n_pairs = n_frames - 1
    with tempfile.TemporaryDirectory() as tmp:
        proc = _synthetic_processor(dev, h, w, n_frames, batch, tmp,
                                    flow_source="FARNEBACK")
        if not proc.save_images:
            raise AssertionError("save_images must default to True")
        _reset_launches()
        t0 = time.perf_counter()
        results = proc.run_detection_foe()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
        if launches["farneback_iterate_fused"] <= 0:
            raise AssertionError("artifacts: the run launched no kernel")
        _hold_expand("artifacts", launches, proc._farneback, h, w)
        if sorted(results) != list(range(n_pairs)):
            raise AssertionError(f"artifacts: results for {sorted(results)}")
        names = [f"image_{i:05d}.png" for i in range(n_pairs)]
        for kind in ("result-images", "derotated", "phi", "processed"):
            got = sorted(os.listdir(os.path.join(tmp, kind)))
            if got != names:       # padded lanes must not be written
                raise AssertionError(f"artifacts: {kind} holds {got}")
            for name in (names[0], names[-1]):
                img = imread(os.path.join(tmp, kind, name))
                if img.shape != (h, w, 3) or img.dtype != np.uint8:
                    raise AssertionError(f"artifacts: {kind}/{name} is {img.shape}")
        mask = imread(os.path.join(tmp, "result-images", names[0]))
        if not set(np.unique(mask).tolist()) <= {0, 255}:
            raise AssertionError("artifacts: result image is not a 0/255 mask")
        frames = np.load(os.path.join(tmp, "video.npz"))["frames"]
        if frames.shape != (n_pairs, h, w, 3) or frames.dtype != np.uint8:
            raise AssertionError(f"artifacts: video.npz holds {frames.shape}")
        n_json = len(os.listdir(os.path.join(tmp, "results")))
        if n_json != n_pairs:
            raise AssertionError(f"artifacts: {n_json} JSON files")
        png_bytes = sum(os.path.getsize(os.path.join(tmp, kind, n))
                        for kind in ("result-images", "derotated", "phi", "processed")
                        for n in names)
    stages = {k: v["total_s"] * 1e3 for k, v in proc.tracer.as_dict().items()}
    return {"pairs": n_pairs, "wall_s": wall, "launches": launches,
            "stages_ms": stages, "png_bytes": png_bytes,
            "artifacts_ms_per_frame": stages["artifacts"] / n_pairs,
            "encode_ms_per_frame": stages["encode"] / n_pairs}


def phase_homography(dev) -> dict:
    """The homography branch on FARNEBACK flow, on the card and on the CPU
    (same numpy draw of the sampled points, same seeded k-means draw is not
    possible across devices, so each run draws its own centers)."""
    import torch

    from mav_detection_tpu_torch.pipeline import processor as pmod

    h, w, n_frames, batch = 480, 752, 9, 8
    n_pairs = n_frames - 1
    out = {}
    for sparse in (False, True):
        runs = {}
        for d in (dev, torch.device("cpu")):
            with tempfile.TemporaryDirectory() as tmp:
                proc = _synthetic_processor(
                    d, h, w, n_frames, batch, tmp if d == dev else "",
                    algorithm="HOMOGRAPHY", flow_source="FARNEBACK",
                    use_sparse_of=sparse)
                # keep each frame's refined box (the results hold only IoU)
                found = []
                real = pmod.optimize_window

                def keeping(img, box, found=found, real=real):
                    out = real(img, box)
                    found.append(out[1])
                    return out
                pmod.optimize_window = keeping
                try:
                    _reset_launches()
                    t0 = time.perf_counter()
                    results = proc.run_detection()
                    if d == dev:
                        torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                finally:
                    pmod.optimize_window = real
                boxes = {i: tuple(_np(b).tolist()) for i, b in enumerate(found)}
                launches = _launches()
                _hold_expand("homography", launches, proc._farneback, h, w)
                mosaics = (len(os.listdir(os.path.join(tmp, "processed")))
                           if d == dev else 0)
            if sorted(results) != list(range(n_pairs)):
                raise AssertionError(f"homography: results for {sorted(results)}")
            ious = [results[i].tpr for i in range(n_pairs)]
            if not np.isfinite(ious).all():
                raise AssertionError(f"homography: non-finite IoU {ious}")
            for i, (x, y, bw, bh) in boxes.items():
                # the hill climb scores a box by its part inside the frame
                # and may push a corner past the edge: the box must be
                # finite, non-empty and overlap the frame
                if not (np.isfinite([x, y, bw, bh]).all() and bw > 0 and bh > 0
                        and x < w and y < h and x + bw > 0 and y + bh > 0):
                    raise AssertionError(f"homography: frame {i} box {(x, y, bw, bh)}")
            runs[d.type] = {"ious": ious, "boxes": boxes, "wall_s": wall,
                            "launches": launches, "mosaics": mosaics,
                            "stages_ms": {k: v["total_s"] * 1e3 for k, v in
                                          proc.tracer.as_dict().items()}}
        card, cpu = runs["cuda"], runs["cpu"]
        if card["launches"].get("farneback_iterate_fused", 0) <= 0:
            raise AssertionError("homography: the run launched no kernel")
        if cpu["launches"].get("farneback_iterate_fused", 0) != 0:
            raise AssertionError("homography: the CPU run counted a launch")
        if card["mosaics"] != n_pairs:
            raise AssertionError(f"homography: {card['mosaics']} mosaics")
        if np.median(card["ious"]) < np.median(cpu["ious"]) - 0.05:
            raise AssertionError(
                f"homography: median IoU {np.median(card['ious'])} on the card, "
                f"{np.median(cpu['ious'])} on the CPU")

        def box_iou(a, b):
            ix = max(0.0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
            iy = max(0.0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
            return ix * iy / max(a[2] * a[3] + b[2] * b[3] - ix * iy, 1e-9)
        out["sparse" if sparse else "plain"] = {
            "pairs": n_pairs, "ious_card": card["ious"], "ious_cpu": cpu["ious"],
            "median_iou_card": float(np.median(card["ious"])),
            "median_iou_cpu": float(np.median(cpu["ious"])),
            "card_vs_cpu_box_iou": [box_iou(card["boxes"][i], cpu["boxes"][i])
                                    for i in range(n_pairs)],
            "launches": card["launches"], "wall_s_card": card["wall_s"],
            "wall_s_cpu": cpu["wall_s"], "ms_per_frame_card": card["wall_s"] * 1e3 / n_pairs,
            "stages_ms_card": card["stages_ms"], "mosaics": card["mosaics"]}
    return out


def phase_lucas_kanade(dev) -> dict:
    import torch

    from mav_detection_tpu_torch.data.scene import make_scene
    from mav_detection_tpu_torch.ops.flow import lucas_kanade as lk

    h, w, max_corners = 480, 752, 2000
    prev8, curr8, gt = make_scene(0, h=h, w=w)
    g0 = torch.as_tensor(prev8.astype(np.float32)).to(dev)
    g1 = torch.as_tensor(curr8.astype(np.float32)).to(dev)
    corners = lk.shi_tomasi_corners(g0, max_corners=max_corners, quality_level=0.05)
    tracked = lk.lucas_kanade_track(g0, g1, corners.points)
    ok = _np(corners.valid & tracked.status)
    pts = _np(corners.points)[ok]
    disp = _np(tracked.points - corners.points)[ok]
    gt_at = gt[np.clip(pts[:, 1].astype(int), 0, h - 1),
               np.clip(pts[:, 0].astype(int), 0, w - 1)]
    track_epe = float(np.linalg.norm(disp - gt_at, axis=-1).mean())
    dense = _np(lk.lk_dense_flow(g0, g1, max_corners=max_corners))
    dense_epe = float(np.linalg.norm(dense - gt, axis=-1)[16:-16, 16:-16].mean())
    survivors = int(ok.sum())
    if survivors < 0.75 * max_corners:
        raise AssertionError(f"lucas_kanade: {survivors} survivors of {max_corners}")
    if not track_epe < 0.12:
        raise AssertionError(f"lucas_kanade: track EPE {track_epe} px >= 0.12")
    if not dense_epe < 1.6:
        raise AssertionError(f"lucas_kanade: dense interior EPE {dense_epe} px >= 1.6")

    n_frames, batch = 5, 4
    proc = _synthetic_processor(dev, h, w, n_frames, batch, "",
                                flow_source="LUCAS_KANADE")
    _reset_launches()
    t0 = time.perf_counter()
    results = proc.run_detection_foe()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sorted(results) != list(range(n_frames - 1)):
        raise AssertionError(f"lucas_kanade: results for {sorted(results)}")
    foe_err = []
    for i, fr in results.items():
        vals = np.array([*fr.foe_dense, fr.fpr, fr.fpr_fixed, fr.sky_tpr,
                         fr.sky_fpr, fr.center_phi], np.float64)
        if not np.isfinite(vals).all():
            raise AssertionError(f"lucas_kanade frame {i}: non-finite {fr}")
        foe_err.append(float(np.hypot(*np.subtract(fr.foe_dense, fr.foe_gt))))
    if sum(_launches().values()) != 0:
        raise AssertionError("lucas_kanade: the LK source launched a Farneback kernel")
    return {"survivors": survivors, "max_corners": max_corners,
            "track_epe_px": track_epe, "dense_interior_epe_px": dense_epe,
            "foe_loop": {"pairs": n_frames - 1, "wall_s": wall,
                         "ms_per_frame": wall * 1e3 / (n_frames - 1),
                         "foe_err_px": foe_err,
                         "stages_ms": {k: v["total_s"] * 1e3 for k, v in
                                       proc.tracer.as_dict().items()}}}


def phase_solvers(dev, size=(480, 752)) -> dict:
    """The tensor-code Farneback solvers at 752x480, b = 1, on the card
    against the CPU on the same inputs, and their host-clock ms."""
    import torch

    from mav_detection_tpu_torch.ops.flow import farneback as fb

    (h, w), S = size, 8
    prev, curr, gt = scene_batch(1, h, w, hires=False)
    params = fb.FarnebackParams(warp="separable", max_shift=S)
    _, _, levels = level_inputs(torch.device("cpu"), prev, curr, gt, params)
    R0, R1, flow, border, _ = (a.numpy() if hasattr(a, "numpy") else a
                               for a in levels[0])
    peak = float(np.abs(flow).max())
    flows = {"inside": flow * np.float32((S - 3) / peak),
             "beyond": flow * np.float32((S + 4) / peak)}
    ck = Checks("modules")
    timings = {}

    def on_card(*arrays):
        return [torch.as_tensor(a).to(dev) for a in arrays]

    for tag, f in flows.items():
        covered = float(np.abs(f).max()) <= S - 1
        if covered != (tag == "inside"):
            raise AssertionError(f"solvers: flow '{tag}' peaks at {np.abs(f).max()}")
        for warp in ("gather", "separable", "auto"):
            a, b = _both(lambda *x: fb.update_matrices(*x, warp, S), dev,
                         R0, R1, f, border)
            ck.add(f"update_matrices {warp}, flow {tag} +-{S - 1}",
                   float(np.abs(_np(a) - _np(b)).max() / np.abs(_np(b)).max()),
                   1e-4, "max abs over M's scale")
            if warp == "auto":
                branch = "separable" if covered else "gather"
                same = torch.equal(a, fb.update_matrices(*on_card(R0, R1, f, border),
                                                         branch, S))
                ck.add(f"update_matrices auto takes {branch}, flow {tag}",
                       float(not same), 0, "differs from that branch")
            args = on_card(R0, R1, f, border)
            timings[f"update_matrices {warp} ({tag})"] = wall_ms(
                lambda: fb.update_matrices(*args, warp, S))
    M = _np(fb.update_matrices(*(torch.as_tensor(a) for a in (R0, R1, flows["inside"], border)),
                               "separable", S))
    a, b = _both(lambda m: fb.solve_flow(m, 12), dev, M)
    ck.add("solve_flow", float(np.abs(_np(a) - _np(b)).max()), 1e-4, "max abs px")
    M_d = torch.as_tensor(M).to(dev)
    timings["solve_flow"] = wall_ms(lambda: fb.solve_flow(M_d, 12))
    for fast in (False, True):
        p = fb.FarnebackParams(warp="auto", fast=fast, max_shift=S)
        a, b = _both(lambda *x: fb.jacobi_level(*x, p), dev, R0, R1, flows["inside"], border)
        ck.add(f"jacobi_level fast={fast} (10 iterations)",
               float(np.abs(_np(a) - _np(b)).max()), 1e-3, "max abs px")
        args = on_card(R0, R1, flows["inside"], border)
        timings[f"jacobi_level fast={fast}"] = wall_ms(lambda: fb.jacobi_level(*args, p))
    p = fb.FarnebackParams(warp="auto", fast=True, levels=2, pyr_scale=0.5)
    a, b = _both(lambda x, y: fb._farneback_cf(x, y, p), dev, prev, curr)
    ck.add("farneback_flow warp=auto fast levels=2",
           float(np.abs(_np(a) - _np(b)).max()), 1e-3, "max abs px")
    pd, cd = on_card(prev, curr)
    timings["farneback_flow warp=auto fast levels=2"] = wall_ms(
        lambda: fb._farneback_cf(pd, cd, p))
    return {"checks": ck.finish(), "ms": timings}


def _finite_results(tag, results, results_dir):
    """Every field of every FrameResult finite (the rates over an absent
    target apart), and its JSON file equal to it; returns the FoE errors."""
    from mav_detection_tpu_torch.core.frame_result import FrameResult

    foe_err = []
    for i, fr in results.items():
        d = fr.to_dict()
        if d["drone_size_pixels"] == 0:
            for key in NAN_WITHOUT_TARGET:
                d.pop(key)
        vals = np.array([v for x in d.values() for v in np.atleast_1d(x)], np.float64)
        if not np.isfinite(vals).all():
            raise AssertionError(f"{tag} frame {i}: non-finite {fr}")
        if results_dir:
            back = FrameResult.from_json_file(
                os.path.join(results_dir, f"image_{i:05d}.json"))
            if json.dumps(back.to_dict()) != json.dumps(fr.to_dict()):
                raise AssertionError(f"{tag} frame {i}: JSON does not round-trip")
        foe_err.append(float(np.hypot(*np.subtract(fr.foe_dense, fr.foe_gt))))
    return foe_err


def _scan_run(dev, h, w, n_frames, sample_yx, tmp, **cfg_kw):
    """One warm-up and one measured run of the scan engine; the launch
    counter is zeroed just before the measured run and read just after."""
    import torch

    from mav_detection_tpu_torch.utils.tracing import Tracer

    proc = _synthetic_processor(dev, h, w, n_frames, 8, tmp, flow_source="FARNEBACK",
                                engine="scan", **cfg_kw)
    proc.run_detection_foe(sample_yx=sample_yx)          # warm-up
    torch.cuda.synchronize()
    proc.tracer = Tracer()
    proc.detection_results = {}
    _reset_launches()
    t0 = time.perf_counter()
    results = proc.run_detection_foe(sample_yx=sample_yx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    if sorted(results) != list(range(n_frames - 1)):
        raise AssertionError(f"scan {w}x{h}: results for {sorted(results)}")
    _hold_expand(f"scan {w}x{h}", launches, proc._farneback, h, w)
    stages = {k: v["total_s"] * 1e3 for k, v in proc.tracer.as_dict().items()}
    return proc, results, launches, wall, stages


def _scan_device_ms(dev, proc, sample_yx) -> float:
    """Device ms of one transition of the dense scan: a CUDA graph of the
    two-frame scan replayed, so the host's time per launch does not show."""
    import torch

    from mav_detection_tpu_torch.pipeline import temporal as tt

    inp = proc._sequence_inputs()
    two = [torch.as_tensor(inp[k][:2]).to(dev) for k in
           ("frames", "omegas", "dts", "segs", "skys", "depths", "gt_foes")]
    syx = torch.as_tensor(sample_yx[:1]).to(dev)
    step = proc._detection_step()
    return graph_ms(lambda: tt.detect_sequence_scan(
        *two, sample_yx=syx, params=proc._farneback, config=step), 5)


def phase_scan(dev, size=(480, 752), hires_size=(1024, 1920)) -> dict:
    import torch

    from mav_detection_tpu_torch.pipeline import temporal as tt

    (h, w), n_frames, batch = size, 12, 8
    n = n_frames - 1
    rng = np.random.default_rng(0)
    n_samples = 1000
    syx = np.stack([rng.integers(0, h, (n, 2 * n_samples)),
                    rng.integers(0, w, (n, 2 * n_samples))], -1)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        proc, results, launches, wall, stages = _scan_run(dev, h, w, n_frames, syx, tmp)
        per_transition = sum(
            proc._farneback.level_iters[min(k, 2)] for k in range(3))
        if launches["farneback_iterate_fused"] != per_transition * n:
            raise AssertionError(f"scan: {launches} launches, expected "
                                 f"{per_transition} x {n}")
        foe_err = _finite_results("scan", results, os.path.join(tmp, "results"))
        if sorted(os.listdir(tmp)) != ["results"]:
            raise AssertionError(f"scan: wrote {sorted(os.listdir(tmp))}")

        # the same sequence through the batch engine with the same draws
        # (the tail batch padded with the last transition's)
        bproc = _synthetic_processor(dev, h, w, n_frames, batch, "",
                                     flow_source="FARNEBACK")
        bproc.save_images = False
        padded = np.concatenate([syx, np.repeat(syx[-1:], (-n) % batch, axis=0)])
        bres = bproc.run_detection_foe(
            sample_yx=[padded[k:k + batch] for k in range(0, n, batch)])
        worst = {}
        for i in range(n):
            a, b = results[i].to_dict(), bres[i].to_dict()
            for key in a:
                if key == "drone_flow_pixels":
                    continue     # the scan derotates a zero ground-truth flow
                x = np.asarray(a[key], np.float64)
                y = np.asarray(b[key], np.float64)
                both_nan = np.isnan(x) & np.isnan(y)
                d = float(np.where(both_nan, 0.0, np.abs(x - y)).max())
                worst[key] = max(worst.get(key, 0.0), d)
        ck = Checks("scan")
        for key, d in worst.items():
            tol = (0.5 if key == "foe_dense" else 0.02 if key in
                   ("tpr", "fpr", "tpr_fixed", "fpr_fixed", "sky_tpr", "sky_fpr")
                   else 1e-3)
            ck.add(f"scan vs batch engine: {key}", d, tol, "max abs over 11 frames")
        ck.finish()

        # the dense loop with every synchronisation an error: device tensors
        # in, device tensors out, the caches warm from the runs above
        inp = proc._sequence_inputs()
        dev_in = [torch.as_tensor(inp[k]).to(dev) for k in
                  ("frames", "omegas", "dts", "segs", "skys", "depths", "gt_foes")]
        syx_d = torch.as_tensor(syx).to(dev)
        step = proc._detection_step()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            scal, _ = tt.detect_sequence_scan(*dev_in, sample_yx=syx_d,
                                              params=proc._farneback, config=step)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        foe_again = scal.foe.cpu().numpy()
        foe_run = np.array([results[i].foe_dense for i in range(n)])
        if not np.abs(foe_again - foe_run).max() <= 1e-3:
            raise AssertionError("scan: the sync-checked loop gave another FoE")

        device_ms = _scan_device_ms(dev, proc, syx)
        loop_ms = (stages["scan"] + stages["materialize"]) / n
        out[f"{w}x{h}"] = {
            "pairs": n, "launches": launches, "wall_s": wall,
            "wall_ms_per_transition": wall * 1e3 / n,
            "loop_ms_per_transition": loop_ms,
            "device_ms_per_transition": device_ms,
            "device_idle_share": 1.0 - device_ms / loop_ms,
            "stages_ms": stages, "median_foe_err_px": float(np.median(foe_err)),
            "vs_batch_engine_max_abs": worst, "sync_debug_mode": "error: passed"}

    # with the sparse trace FoE, 6 frames
    looks = []
    real_bool = torch.Tensor.__bool__
    with tempfile.TemporaryDirectory() as tmp:
        torch.Tensor.__bool__ = lambda t: looks.append(1) or real_bool(t)
        try:
            proc, results, launches, wall, stages = _scan_run(
                dev, h, w, 6, syx[:5], tmp, use_sparse_of=True)
        finally:
            torch.Tensor.__bool__ = real_bool
        side = np.load(os.path.join(tmp, "results", "foe_sparse.npy"))
        if side.shape != (5, 2) or not np.isfinite(side).all():
            raise AssertionError(f"scan sparse: foe_sparse.npy holds {side}")
        if launches["farneback_iterate_fused"] != 13 * 5:
            raise AssertionError(f"scan sparse: {launches}")
        _finite_results("scan sparse", results, os.path.join(tmp, "results"))
        out[f"{w}x{h} use_sparse_of"] = {
            "pairs": 5, "launches": launches,
            "wall_ms_per_transition": wall * 1e3 / 5, "stages_ms": stages,
            "foe_sparse": side.tolist(),
            # two runs (warm-up and measured), 6 replenishments each
            "host_looks_per_replenishment": len(looks) / 12}

    # 1920x1024, 4 frames, dense
    hh, hw = hires_size
    syx_h = np.stack([rng.integers(0, hh, (3, 2 * n_samples)),
                      rng.integers(0, hw, (3, 2 * n_samples))], -1)
    proc, results, launches, wall, stages = _scan_run(dev, hh, hw, 4, syx_h, "")
    if launches["farneback_iterate_fused"] != 13 * 3:
        raise AssertionError(f"scan 1920x1024: {launches}")
    foe_err = _finite_results("scan 1920x1024", results, "")
    device_ms = _scan_device_ms(dev, proc, syx_h)
    loop_ms = (stages["scan"] + stages["materialize"]) / 3
    out[f"{hw}x{hh}"] = {
        "pairs": 3, "launches": launches, "wall_ms_per_transition": wall * 1e3 / 3,
        "loop_ms_per_transition": loop_ms, "device_ms_per_transition": device_ms,
        "device_idle_share": 1.0 - device_ms / loop_ms, "stages_ms": stages,
        "median_foe_err_px": float(np.median(foe_err))}
    return out


def phase_native(dev, size=(480, 752)) -> dict:
    import shutil
    from pathlib import Path

    import torch

    from mav_detection_tpu_torch import _build
    from mav_detection_tpu_torch.core import flo
    from mav_detection_tpu_torch.core.config import RunConfig
    from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
    from mav_detection_tpu_torch.pipeline.processor import Processor
    from mav_detection_tpu_torch.runtime import native_loader as native

    if not native.available():
        raise AssertionError("native: the loader library did not build")
    (h, w), n_files = size, 16
    rng = np.random.default_rng(0)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # the g++ build alone, into a directory of its own
        _build.SOURCES["loader_timed"] = _build.SOURCES["loader"]._replace(
            out_dir=Path(tmp) / "lib")
        try:
            t0 = time.perf_counter()
            _build.build(["loader_timed"])
            out["gxx_build_s"] = time.perf_counter() - t0
        finally:
            del _build.SOURCES["loader_timed"]

        fields = rng.normal(size=(n_files, h, w, 2)).astype(np.float32)
        by_native = [os.path.join(tmp, f"n{i:06d}.flo") for i in range(n_files)]
        by_numpy = [os.path.join(tmp, f"p{i:06d}.flo") for i in range(n_files)]
        for i in range(n_files):
            native.write_flow(by_native[i], fields[i])
            flo.write_flow(by_numpy[i], fields[i])
        for i in range(n_files):
            if not np.array_equal(flo.read_flow(by_native[i]), fields[i]):
                raise AssertionError(f"native: numpy read of native file {i} differs")
            if not np.array_equal(native.read_flow(by_numpy[i]), fields[i]):
                raise AssertionError(f"native: native read of numpy file {i} differs")
        if not np.array_equal(native.read_flow_batch(by_numpy), fields):
            raise AssertionError("native: batch read differs")

        depth = 4
        pf = native.FloPrefetcher(by_native, depth=depth, n_threads=2)
        try:
            peak = 0
            for i in range(n_files):
                peak = max(peak, pf.inflight())
                if not np.array_equal(next(pf), fields[i]):
                    raise AssertionError(f"native: prefetcher out of order at {i}")
                peak = max(peak, pf.inflight())
            if peak > depth or pf.inflight() != 0:
                raise AssertionError(f"native: {peak} in flight, depth {depth}")
        finally:
            pf.close()
        out["prefetcher_peak_inflight"] = peak

        bad = os.path.join(tmp, "trunc.flo")
        shutil.copy(by_native[0], bad)
        with open(bad, "r+b") as f:
            f.truncate(12 + 1000)
        for read in (lambda: native.read_flow(bad),
                     lambda: native.read_flow_batch([by_native[0], bad]),
                     lambda: list(native.FloPrefetcher([by_native[0], bad]))):
            try:
                read()
            except IOError:
                continue
            raise AssertionError("native: a truncated file was read without error")

        def ms_per_file(fn):
            fn()
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3 / n_files

        def drain():
            p = native.FloPrefetcher(by_native, depth=8, n_threads=2)
            try:
                return list(p)
            finally:
                p.close()
        out["ms_per_file"] = {
            "numpy read_flow": ms_per_file(lambda: [flo.read_flow(p) for p in by_native]),
            "native read_flow": ms_per_file(lambda: [native.read_flow(p) for p in by_native]),
            "native read_flow_batch (4 threads)": ms_per_file(
                lambda: native.read_flow_batch(by_native)),
            "FloPrefetcher drained (2 threads)": ms_per_file(drain)}

        # the main path on PRECOMPUTED flow from files on disk, through the
        # prefetcher and through the numpy reader
        n_frames, batch = 12, 8
        runs = {}
        served = []
        real_pf = native.FloPrefetcher

        class Counted(real_pf):
            def __next__(self):
                got = super().__next__()
                served.append(1)
                return got
        for reader in ("prefetcher", "numpy"):
            cfg = RunConfig(dataset="synthetic", flow_source="PRECOMPUTED",
                            batch_size=batch, headless=True)
            sp = SyntheticParams(height=h, width=w, n_frames=n_frames)
            cfg.get_dataset = lambda **_: SyntheticDataset(
                params=sp, materialize_to=os.path.join(tmp, reader))
            proc = Processor(cfg, device=dev)
            proc.save_images = False
            ds = proc.dataset
            ds.flow_path = os.path.join(ds.seq_path, "flow")
            os.makedirs(ds.flow_path)
            for i in range(n_frames - 1):
                native.write_flow(os.path.join(ds.flow_path, f"{i:06d}.flo"), ds.flows[i])
            ds.get_flow_uv = None          # the files must be what is read
            real_available = native.available
            native.FloPrefetcher = Counted
            if reader == "numpy":
                native.available = lambda: False
            try:
                _reset_launches()
                t0 = time.perf_counter()
                results = proc.run_detection_foe()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                native.FloPrefetcher = real_pf
                native.available = real_available
                proc.release()
            _finite_results(f"native {reader}", results, ds.results_path)
            runs[reader] = {"json": {i: fr.to_json() for i, fr in results.items()},
                            "wall_s": wall, "launches": _launches(),
                            "served": len(served)}
        if runs["prefetcher"]["served"] != n_frames - 1 or \
                runs["numpy"]["served"] != n_frames - 1:
            raise AssertionError(
                f"native: the prefetcher served {runs['prefetcher']['served']} files "
                f"on its run and {runs['numpy']['served'] - runs['prefetcher']['served']} "
                "on the numpy reader's")
        if runs["prefetcher"]["json"] != runs["numpy"]["json"]:
            raise AssertionError("native: the two readers' runs differ")
        out["precomputed"] = {
            "pairs": n_frames - 1,
            "frames_per_s": {k: (n_frames - 1) / r["wall_s"] for k, r in runs.items()},
            "launches": runs["prefetcher"]["launches"]}
    return out


def phase_entry(dev) -> dict:
    import torch

    from mav_detection_tpu_torch.entry import entry
    from mav_detection_tpu_torch.ops.flow import farneback as fb

    fn, args = entry(dev)
    if not all(a.is_cuda for a in args):
        raise AssertionError("entry: example arguments are not on the card")
    fn(*args)                                            # warm-up
    _reset_launches()
    foe, tpr_fixed, fpr_fixed, total_mask = fn(*args)
    torch.cuda.synchronize()
    launches = _launches()
    if launches["farneback_iterate_fused"] != 13:
        raise AssertionError(f"entry: {launches}")
    h, w = args[0].shape
    _hold_expand("entry", launches, fb.tuned_flow_params(h, w), h, w)
    vals = _np(torch.stack([*foe, tpr_fixed, fpr_fixed]))
    if not np.isfinite(vals).all() or total_mask.shape != (h, w):
        raise AssertionError(f"entry: outputs {vals}, mask {tuple(total_mask.shape)}")
    if not (0 <= vals[0] < w and 0 <= vals[1] < h):
        raise AssertionError(f"entry: FoE {vals[:2]} outside the {w}x{h} image")
    cpu_fn, cpu_args = entry("cpu")
    cpu_foe = _np(cpu_fn(*cpu_args)[0])
    err = float(np.abs(vals[:2] - cpu_foe).max())
    if not err <= 0.5:
        raise AssertionError(f"entry: FoE {vals[:2]} on the card, {cpu_foe} on the CPU")
    return {"foe": vals[:2].tolist(), "foe_vs_cpu_px": err, "launches": launches,
            "mask_pixels": int(total_mask.sum()),
            "ms_per_step": wall_ms(lambda: fn(*args), 5)}


def _device_ms(fn, reps: int = 5) -> tuple:
    """Device ms per call from a replayed CUDA graph; CUDA events around
    eager calls where the stage cannot be captured."""
    import torch

    try:
        return graph_ms(fn, reps), "cuda graph"
    except RuntimeError:
        torch.cuda.synchronize()
        return time_ms(fn, reps), "events"


def _raft_stage_times(dev, frames: np.ndarray) -> list:
    """Device ms of each RAFT stage of one video batch (len(frames) - 1
    transitions) in the product config, beside its bound."""
    import torch
    import torch.nn.functional as F

    from mav_detection_tpu_torch.models import pretrained
    from mav_detection_tpu_torch.models import raft as tr

    model, cfg = pretrained.load_raft(dev), tr.INFERENCE_CONFIG
    dt, r = cfg.dtype, cfg.corr_radius
    rows = []
    with torch.no_grad():
        x = tr._images_nchw(frames, dev) / 127.5 - 1.0
        feats = model.fnet(x, dt)
        cout = model.cnet(x[:-1], dt)
        f1, f2 = feats[:-1], feats[1:]
        b, _, h8, w8 = f1.shape
        hidden = torch.tanh(cout[:, :cfg.hidden_dim])
        context = F.relu(cout[:, cfg.hidden_dim:])
        flow = torch.zeros((b, 2, h8, w8), device=dev)
        pyr = tr.build_feature_pyramid(f2, cfg.corr_levels)
        vols = tr.build_local_corr_volumes(f1, pyr, r, cfg.max_flow_lookup)
        shapes = [tuple(p.shape[-2:]) for p in pyr]
        corr = tr.lookup_corr_volumes(vols, shapes, flow, r)
        up = tr.convex_upsample(flow, model.mask_head(
            F.relu(model.mask_hidden(hidden, dt)).float(), torch.float32))
        weights = {k: _nbytes(*getattr(model, k).parameters())
                   for k in ("fnet", "cnet", "update")}
        mask_w = _nbytes(*model.mask_hidden.parameters(), *model.mask_head.parameters())

        def stage(name, fn, nbytes, extra_fp32=0.0):
            fl = _conv_flops(model, fn)
            ms, timer = _device_ms(fn)
            bound, by = bound_ms(nbytes, fl["fp32"] + extra_fp32, fl["bf16"])
            rows.append({"stage": name, "ms": ms, "timer": timer, "bound_ms": bound,
                         "bound_by": by, "bytes": nbytes,
                         "gflop_fp32": (fl["fp32"] + extra_fp32) / 1e9,
                         "gflop_bf16": fl["bf16"] / 1e9})

        stage("fnet", lambda: model.fnet(x, dt),
              _nbytes(x, feats) + weights["fnet"])
        stage("cnet", lambda: model.cnet(x[:-1], dt),
              _nbytes(x[:-1], cout) + weights["cnet"])
        # the dot products the volumes hold: C multiply-adds per entry
        vol_flops = sum(2.0 * v.numel() * f1.shape[1] for v in vols)
        stage("build_local_corr_volumes (with the feature pyramid)",
              lambda: tr.build_local_corr_volumes(
                  f1, tr.build_feature_pyramid(f2, cfg.corr_levels), r,
                  cfg.max_flow_lookup),
              _nbytes(f1, f2, *vols), vol_flops)
        stage("refinement step (lookup + update block)",
              lambda: model.update(hidden, context,
                                   tr.lookup_corr_volumes(vols, shapes, flow, r),
                                   flow, dt),
              _nbytes(*vols, hidden, context, flow, hidden, flow) + weights["update"])
        stage("mask head + convex_upsample",
              lambda: tr.convex_upsample(flow, model.mask_head(
                  F.relu(model.mask_hidden(hidden, dt)).float(), torch.float32)),
              _nbytes(hidden, flow, up) + mask_w,
              2.0 * b * 2 * 64 * 9 * h8 * w8)
    del corr
    return rows


def _raft_loop(dev, h: int, w: int, n_frames: int, batch: int) -> dict:
    """The product loop on FlowSource.RAFT: a warm-up run, then a measured
    one with the iterate kernel's counters zeroed, the saturation checks
    counted and every synchronisation with the host recorded."""
    import warnings

    import torch

    from mav_detection_tpu_torch.core.config import FlowSource
    from mav_detection_tpu_torch.models import pretrained
    from mav_detection_tpu_torch.models import raft as tr
    from mav_detection_tpu_torch.ops.image.resize import resize_frames
    from mav_detection_tpu_torch.pipeline.detector import detect_frame_batch_scalars
    from mav_detection_tpu_torch.utils.tracing import Tracer

    n_pairs = n_frames - 1
    n_batches = -(-n_pairs // batch)
    with tempfile.TemporaryDirectory() as tmp:
        proc = _synthetic_processor(dev, h, w, n_frames, batch, tmp, flow_source="RAFT")
        proc.save_images = False
        proc.run_detection_foe()                               # warm-up
        torch.cuda.synchronize()
        proc.tracer = Tracer()
        proc.detection_results = {}
        checks = []
        real_check = tr.check_flow_saturation

        def counted(*a, **k):
            checks.append(real_check(*a, **k))
            return checks[-1]

        tr.check_flow_saturation = counted
        _reset_launches()
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    t0 = time.perf_counter()
                    results = proc.run_detection_foe()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        finally:
            tr.check_flow_saturation = real_check
        launches = _launches()
        syncs = collections.Counter(
            f"{os.path.relpath(c.filename, os.path.dirname(os.path.abspath(__file__)))}:"
            f"{c.lineno}" for c in caught if "synchroniz" in str(c.message))
        if sorted(results) != list(range(n_pairs)):
            raise AssertionError(f"nets loop {w}x{h}: results for {sorted(results)}")
        foe_err = _finite_results(f"nets loop {w}x{h}", results, proc.dataset.results_path)

        staged = proc._stage_batch(list(range(batch)), FlowSource.RAFT)
        flow = proc._flow_from_staged(staged, FlowSource.RAFT)
        aux = [proc._to_dev(staged[k]) for k in
               ("gt_flow", "omegas", "dts", "segs", "skys", "depths", "gt_foes")]
        gen = torch.Generator(device=dev).manual_seed(0)
        step = proc._detection_step()
        flow_ms = time_ms(lambda: proc._flow_from_staged(staged, FlowSource.RAFT), 5, 1)
        detect_ms = time_ms(lambda: detect_frame_batch_scalars(
            flow, *aux, generator=gen, config=step), 5, 1)
        frames = np.stack([proc.dataset.get_frame(i) for i in range(batch + 1)])
        # the flow's device time alone: the working-scale resize, the net and
        # the upsample of one batch from a replayed CUDA graph (the
        # saturation check's pull cannot be captured)
        t = tr.tuned_raft_config(h, w)
        model = pretrained.load_raft(dev)
        frames_dev = torch.as_tensor(frames).to(dev)
        hw = (h // t.scale, w // t.scale)

        def flow_only():
            fr = resize_frames(frames_dev, hw) if t.scale > 1 else frames_dev
            fl = tr.raft_flow_video(fr, model, t.iters, t.config, dev)
            return resize_frames(fl, (h, w)) * float(t.scale) if t.scale > 1 else fl

        flow_graph_ms, flow_timer = _device_ms(flow_only, 3)
    batch_wall_ms = wall * 1e3 / n_batches
    return {
        "size": f"{w}x{h}", "frames": n_frames, "batch": batch, "pairs": n_pairs,
        "wall_s": wall, "frames_per_s": n_pairs / wall,
        "farneback_launches": launches,
        "saturation_checks": len(checks), "escalation_rungs": int(sum(checks)),
        "host_looks_per_batch": sum(syncs.values()) / n_batches,
        "synchronising_calls": dict(syncs),
        "median_foe_err_px": float(np.median(foe_err)),
        "stages_ms": {k: v["total_s"] * 1e3 for k, v in proc.tracer.as_dict().items()},
        "device_ms_per_batch": {"flow": flow_ms, "detect": detect_ms},
        "flow_device_ms_per_batch": flow_graph_ms, "flow_device_timer": flow_timer,
        "wall_ms_per_batch": batch_wall_ms,
        "device_idle_share": 1.0 - (flow_ms + detect_ms) / batch_wall_ms,
        "device_idle_share_graph": 1.0 - (flow_graph_ms + detect_ms) / batch_wall_ms,
        "_frames": frames,
    }


def phase_nets(dev, sky_hw=(480, 752), card_cpu=("320x240", "752x480"),
               loops=((480, 752, 12, 8), (1024, 1920, 6, 4))) -> dict:
    import torch

    from mav_detection_tpu_torch import convert
    from mav_detection_tpu_torch.data.scene import bench_scene, hires_scene_kwargs, make_scene
    from mav_detection_tpu_torch.models import checkpoint, pretrained
    from mav_detection_tpu_torch.models import raft as tr
    from mav_detection_tpu_torch.models import sky_segmentation as ts

    out = {}
    # ---- load: the shipped files, the port's reader, the migration
    if os.environ.get("MAV_CHECKPOINT_PATH"):
        raise AssertionError("nets: MAV_CHECKPOINT_PATH is set; the shipped "
                             "checkpoints must be read")
    here = os.path.dirname(os.path.abspath(__file__))
    load = {}
    for name in ("raft", "sky"):
        path = pretrained.checkpoint_path(name)
        if os.path.dirname(path) != os.path.join(here, "checkpoints") or not os.path.isfile(path):
            raise AssertionError(f"nets: {name} checkpoint at {path}")
        t0 = time.perf_counter()
        raw = checkpoint.load_msgpack(path)
        t1 = time.perf_counter()
        if name == "raft":
            if "Conv_6" not in raw["params"]["refine"]["update"]:
                raise AssertionError("nets: the shipped RAFT file is not the pre-hoist layout")
            tree = pretrained._migrate_raft_state(raw)
            if "Conv_6" in tree["params"]["refine"]["update"] or "mask_hidden" not in tree["params"]:
                raise AssertionError("nets: RAFT migration did not move the mask head")
            sd = convert.raft_state_dict_from_flax(tree)
        else:
            sd = convert.sky_state_dict_from_flax(raw)
        t2 = time.perf_counter()
        load[name] = {"path": os.path.relpath(path, here), "bytes": os.path.getsize(path),
                      "read_s": t1 - t0, "convert_s": t2 - t1, "tensors": len(sd),
                      "parameters": int(sum(v.numel() for v in sd.values()))}
    pretrained.clear_cache()
    models = {d: (pretrained.load_raft(d), pretrained.load_sky(d)) for d in (dev, "cpu")}
    for d, (m, s) in models.items():
        if m is None or s is None:
            raise AssertionError(f"nets: no shipped model on {d}")
    load["raft"]["migrated"] = True
    out["load"] = load
    checks = Checks("nets")

    # ---- SkyUNet, card against CPU, and its sky band rates
    h, w = sky_hw
    prev, _, _, _ = bench_scene(0, h, w)
    frame = np.repeat(prev[..., None], 3, -1)
    sky = {}
    for kind, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        card = _np(ts.sky_logits(models[dev][1], torch.as_tensor(frame)[None].to(dev), dtype)[0])
        cpu = _np(ts.sky_logits(models["cpu"][1], torch.as_tensor(frame)[None], dtype)[0])
        err = float(np.abs(card - cpu).max())
        agree = float(((card > 0) == (cpu > 0)).mean())
        checks.add(f"sky logits {kind} {w}x{h}", err, SKY_CARD_CPU_TOL[kind],
                   "max |card - cpu|")
        checks.add(f"sky mask {kind} {w}x{h}", agree, SKY_MASK_AGREEMENT, "agreement",
                   at_least=True)
        sky[kind] = {"max_abs_err": err, "mask_agreement": agree}
    est = _np(ts.sky_mask(models[dev][1], frame, dev))
    band = np.zeros((h, w), bool)
    band[:int(0.35 * h)] = True
    tpr = float((est & band).sum() / band.sum())
    fpr = float((est & ~band).sum() / (~band).sum())
    checks.add(f"sky TPR {w}x{h}", tpr, SKY_TPR_MIN, "TPR", at_least=True)
    checks.add(f"sky FPR {w}x{h}", fpr, SKY_FPR_MAX, "FPR")
    sky.update({"tpr": tpr, "fpr": fpr,
                "ms": time_ms(lambda: ts.sky_mask(models[dev][1], frame, dev), 5)})
    out["sky"] = sky

    # ---- RAFT, card against CPU, then EPE against the analytic GT
    raft = {}
    t32 = tr.RAFTConfig(materialize_corr=False, dtype=torch.float32)
    for size in card_cpu:
        h, w, iters, seed, _, _ = RAFT_EPE_GATES[size]
        prev, curr, _, _ = bench_scene(seed, h, w)
        for kind, cfg in (("fp32", t32), ("bf16", tr.INFERENCE_CONFIG)):
            card, cpu = (_np(tr.raft_flow(models[d][0], torch.as_tensor(prev)[None].to(d),
                                          torch.as_tensor(curr)[None].to(d), iters, cfg)[0])
                         for d in (dev, "cpu"))
            err = np.abs(card - cpu)
            checks.add(f"raft flow {kind} {size}", float(err.max()),
                       RAFT_CARD_CPU_TOL_PX[kind], "max |card - cpu| px")
            raft[f"{size} {kind} card vs cpu"] = {"max_abs_err_px": float(err.max()),
                                                  "mean_abs_err_px": float(err.mean())}
    epe = {}
    for size, (h, w, iters, seed, gate, drone_gate) in RAFT_EPE_GATES.items():
        if iters is None:                    # the operating point of large frames
            kw = hires_scene_kwargs(h, w)
            prev, curr, gt = make_scene(seed, h=h, w=w, **kw)
            drone = ((np.arange(w)[None, :] - kw["drone_pos"][0]) ** 2
                     + (np.arange(h)[:, None] - kw["drone_pos"][1]) ** 2
                     <= kw["drone_radius"] ** 2)
            run = lambda: tr.raft_flow_batch_tuned(prev[None], curr[None], device=dev)  # noqa: E731
        else:
            prev, curr, gt, drone = bench_scene(seed, h, w)
            run = lambda: tr.raft_flow_batch(prev[None], curr[None], iters=iters,  # noqa: E731
                                             device=dev)
        flow = _np(run()[0])
        err = np.linalg.norm(flow - gt, axis=-1)
        e_int = float(err[16:-16, 16:-16].mean())
        e_drone = float(err[drone].mean())
        checks.add(f"raft EPE {size}", e_int, gate, "EPE vs GT px")
        checks.add(f"raft drone EPE {size}", e_drone, drone_gate, "drone EPE px")
        epe[size] = {"epe_px": e_int, "drone_epe_px": e_drone, "gate_px": gate,
                     "drone_gate_px": drone_gate, "iters": iters or "tuned",
                     "ms_per_pair": time_ms(run, 3, 1)}
    raft["epe"] = epe
    out["raft"] = raft

    # ---- the product loop, then the stage times at 752x480 b=8
    loops = [_raft_loop(dev, *size) for size in loops]
    frames = loops[0]["_frames"]
    for lp in loops:
        lp.pop("_frames")
        if any(lp["farneback_launches"].values()):
            raise AssertionError(f"nets loop: Farneback launched on RAFT flow {lp}")
    out["loops"] = loops
    out["stages"] = _raft_stage_times(dev, frames)
    out["checks"] = checks.finish()
    return out


MIDGARD_SEQ = "countryside-natural/north-narrow"
# the mock collection of tests/test_sim_loop.py: the target flies at the
# camera, so it stays in frame (its pixels move against the ground's)
SIM_COLLECTION = {
    "orientations": ["north"],
    "locations": {"testfield": {"x": 0.0, "y": 0.0, "z": -2.0}},
    "orbit_speed": [2.0],
    "global_speed": {"default": {"lin_x": 1.2, "sin_y": 0.0, "sin_z": 0.0}},
    "heights": {"low": 3.0},
    "radii": [15.0],
    "modes": ["collision"],
    "collision_angles": [10.0],
}
# GT flow card against CPU: both invert the view-projection matrix in fp32;
# at 1920x1024 that inverse puts either within 0.0224 px of an fp64
# computation (measured on the CPU), so the two within 0.05 px
GT_FLOW_CARD_CPU_TOL_PX = 0.05
CARD_CPU_FOE_TOL_PX, CARD_CPU_RATE_TOL = 0.5, 0.02
RATES = ("tpr", "fpr", "tpr_fixed", "fpr_fixed", "sky_tpr", "sky_fpr")
# FrameResult fields that are NaN by construction on a dataset without a GT
# FoE (MIDGARD, VisDrone, experiment)
NAN_WITHOUT_GT_FOE = ("foe_gt", "center_phi")


def _png_paeth(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG with the Paeth filter on every row, encoded with
    numpy: Paeth predicts from unfiltered bytes, so it is array code."""
    import struct
    import zlib

    from mav_detection_tpu_torch.data.dataset import _PNG_MAGIC, _png_chunk

    h, w = img.shape[:2]
    x = img.reshape(h, -1).astype(np.int32)
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 3:] = x[:-1, :-3]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.empty((h, x.shape[1] + 1), np.uint8)
    rows[:, 0] = 4
    rows[:, 1:] = (x - pred) & 0xFF
    return (_PNG_MAGIC
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 3))
            + _png_chunk(b"IEND", b""))


def _read_results(tag, results_dir, n_pairs, skip=()):
    """The FrameResult JSON files of a run: ``n_pairs`` of them, every field
    finite but those in ``skip`` (and the rates over an absent target)."""
    from mav_detection_tpu_torch.core.frame_result import FrameResult

    paths = sorted(glob.glob(os.path.join(results_dir, "image_*.json")))
    if len(paths) != n_pairs:
        raise AssertionError(f"{tag}: {len(paths)} FrameResult files, expected {n_pairs}")
    out = {}
    for i, p in enumerate(paths):
        fr = FrameResult.from_json_file(p)
        d = fr.to_dict()
        drop = set(skip) | (set(NAN_WITHOUT_TARGET) if d["drone_size_pixels"] == 0 else set())
        vals = np.array([v for k, x in d.items() if k not in drop
                         for v in np.atleast_1d(x)], np.float64)
        if not np.isfinite(vals).all():
            raise AssertionError(f"{tag} frame {i}: non-finite {d}")
        out[i] = fr
    return out


def _per_batch_launches(params, h, w) -> int:
    from mav_detection_tpu_torch.ops.flow import farneback as fb

    return sum(fb._level_iter_count(params, k)
               for k in range(len(fb._pyramid_scales(h, w, params))))


def _reset_launches() -> None:
    """Zero the launch counters of the main path's two kernels: the
    iterate's and the polynomial expansion's band kernel's."""
    from mav_detection_tpu_torch.ops.flow import farneback_expand as fe
    from mav_detection_tpu_torch.ops.flow import farneback_iter as fi

    fi.reset_launch_counts()
    fe.reset_launch_counts()


def _launches() -> dict:
    """Both kernels' launches, per kernel, since ``_reset_launches``."""
    from mav_detection_tpu_torch.ops.flow import farneback_expand as fe
    from mav_detection_tpu_torch.ops.flow import farneback_iter as fi

    return {**fi.LAUNCHES, **fe.LAUNCHES}


def _expand_per_call(params, h, w) -> int:
    """Band-kernel launches of one flow call at (h, w): its plan's, summed
    over the pyramid's layers."""
    from mav_detection_tpu_torch.ops.flow import farneback as fb

    n = 0
    for scale in fb._pyramid_scales(h, w, params):
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth = fb._gaussian_kernel(max(int(round(sigma * 5)) | 1, 3), sigma)
        args = (h, w, int(round(h * scale)), int(round(w * scale)), smooth,
                params.poly_n, params.poly_sigma)
        n += len(fb._expand_plan(args, 2))
    return n


def _hold_expand(tag: str, launches: dict, params, h: int, w: int) -> int:
    """The band kernel's launches in ``launches`` (``_launches`` of a run at
    (h, w)) against the flow calls that the iterate's launches count: the
    plan's launches per call. Returns the band kernel's total."""
    from mav_detection_tpu_torch.ops.flow import farneback_expand as fe

    calls, rest = divmod(launches["farneback_iterate_fused"],
                         _per_batch_launches(params, h, w))
    got = sum(launches[k] for k in fe.KERNELS)
    want = calls * _expand_per_call(params, h, w)
    if rest or got != want:
        raise AssertionError(f"{tag}: band kernel launches {launches}, expected {want} "
                             f"({calls} flow calls at {w}x{h})")
    return got


def phase_datasets(dev, midgard=(480, 752, 12, 8), card_cpu_frames=4,
                   sim=(1024, 1920, 7, 4)) -> dict:
    import shutil

    import torch

    from mav_detection_tpu_torch.cli.main import main as cli_main
    from mav_detection_tpu_torch.core.config import RunConfig
    from mav_detection_tpu_torch.data import airsim_flow as af
    from mav_detection_tpu_torch.data import dataset as dsmod
    from mav_detection_tpu_torch.data.scene import bench_scene
    from mav_detection_tpu_torch.data.sim_data import SimDataset
    from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
    from mav_detection_tpu_torch.ops.flow import farneback as fb
    from mav_detection_tpu_torch.pipeline.processor import Processor
    from mav_detection_tpu_torch.runtime import native_loader as native
    from mav_detection_tpu_torch.sim import MockSimClient, SimDataCollector

    k = "farneback_iterate_fused"
    out = {"launches": {}}
    checks = Checks("datasets")
    env_before = {v: os.environ.get(v) for v in ("MIDGARD_PATH", "SIMDATA_PATH")}
    sky_calls = []
    real_infer = dsmod.Dataset._infer_sky_segmentation

    def counted_infer(self, i):
        sky_calls.append(i)
        return real_infer(self, i)

    def cli(tag, argv, n_pairs):
        """One CLI run, launch counter zeroed just before; the detection's
        wall time and launches are read when the Validator starts (which
        the CLI runs after it, in mode FLOW_UV with TinyYOLO), the
        validation's after it. Returns (frames/s, launches, wall s) of the
        detection."""
        sky_calls.clear()
        _reset_launches()
        t0 = time.perf_counter()
        with _ValidationSplit() as split:
            cli_main(argv)
        val = split.runs[-1]
        wall = val["started"] - t0
        launches = val["launches_before"]
        out["launches"][tag] = launches
        out["launches"][f"{tag} validation"] = val["launches"]
        mh, mw = midgard[:2]
        params = fb.tuned_flow_params(mh, mw)
        out.setdefault("expand_launches", {})[tag] = _hold_expand(
            f"datasets {tag}", val["counts_before"], params, mh, mw)
        out["expand_launches"][f"{tag} validation"] = _hold_expand(
            f"datasets {tag} validation", val["counts"], params, mh, mw)
        out.setdefault("validation_s", {})[tag] = val["s"]
        return n_pairs / wall, launches, wall

    try:
        dsmod.Dataset._infer_sky_segmentation = counted_infer
        with tempfile.TemporaryDirectory() as tmp:
            # ---- MIDGARD layout: the CLI with its defaults
            h, w, n_frames, batch = midgard
            n_pairs = n_frames - 1
            root = os.path.join(tmp, "midgard")
            src = SyntheticDataset(sequence=MIDGARD_SEQ, params=SyntheticParams(
                height=h, width=w, n_frames=n_frames), materialize_to=root)
            seq = os.path.join(root, MIDGARD_SEQ)
            shutil.rmtree(os.path.join(seq, "results"))
            os.environ["MIDGARD_PATH"] = root
            per_batch = _per_batch_launches(fb.tuned_flow_params(h, w), h, w)
            mg = {}
            fps, n, _ = cli("midgard", ["--headless"], n_pairs)
            expected = per_batch * -(-n_pairs // batch)
            if n != expected:
                raise AssertionError(f"datasets midgard: {n} launches, expected {expected}")
            if len(sky_calls) != n_pairs:
                raise AssertionError(f"datasets midgard: SkyUNet ran {len(sky_calls)} times")
            res = _read_results("midgard", os.path.join(seq, "results"), n_pairs,
                                NAN_WITHOUT_GT_FOE)
            hrnet = glob.glob(os.path.join(seq, "half-res-images", "hrnet", "*.png"))
            mg["skyunet_in_loop_frames_per_s"] = fps
            fps, n, _ = cli("midgard cached masks", ["--headless"], n_pairs)
            if sky_calls or n != expected:
                raise AssertionError(f"datasets midgard rerun: SkyUNet {len(sky_calls)} "
                                     f"calls, {n} launches")
            res2 = _read_results("midgard cached masks", os.path.join(seq, "results"),
                                 n_pairs, NAN_WITHOUT_GT_FOE)
            for i in res:
                if res2[i].to_json() != res[i].to_json():
                    raise AssertionError(f"datasets midgard: frame {i} differs on the "
                                         "cached masks")
            mg["cached_masks_frames_per_s"] = fps
            mg["hrnet_pngs"] = len(hrnet)

            # PRECOMPUTED through the prefetcher: .flo files in the flow dir
            flow_dir = os.path.join(seq, "images", "output", "inference",
                                    "run.epoch-0-flow-field")
            os.makedirs(flow_dir)
            for i in range(n_pairs):
                native.write_flow(os.path.join(flow_dir, f"{i:06d}.flo"), src.flows[i])
            served = []
            real_pf = native.FloPrefetcher

            class Counted(real_pf):
                def __next__(self):
                    got = super().__next__()
                    served.append(1)
                    return got
            native.FloPrefetcher = Counted
            try:
                fps, n, _ = cli("midgard precomputed", ["--headless"], n_pairs)
            finally:
                native.FloPrefetcher = real_pf
            if n != 0 or len(served) != n_pairs:
                raise AssertionError(f"datasets midgard precomputed: {n} launches, "
                                     f"{len(served)} files from the prefetcher")
            _read_results("midgard precomputed", os.path.join(seq, "results"), n_pairs,
                          NAN_WITHOUT_GT_FOE)
            mg["precomputed_frames_per_s"] = fps
            mg["prefetcher_files"] = len(served)
            shutil.rmtree(flow_dir)

            fps, n, wall = cli("midgard scan", ["--headless", "--engine", "scan"], n_pairs)
            if n != per_batch * n_pairs:
                raise AssertionError(f"datasets midgard scan: {n} launches")
            _read_results("midgard scan", os.path.join(seq, "results"), n_pairs,
                          NAN_WITHOUT_GT_FOE)
            mg["scan_ms_per_transition"] = wall * 1e3 / n_pairs
            out["midgard"] = mg

            # ---- card against CPU on a short MIDGARD sequence, same draws
            root4 = os.path.join(tmp, "midgard4")
            SyntheticDataset(sequence=MIDGARD_SEQ, params=SyntheticParams(
                height=h, width=w, n_frames=card_cpu_frames), materialize_to=root4)
            os.environ["MIDGARD_PATH"] = root4
            rng = np.random.default_rng(0)
            n4 = card_cpu_frames - 1
            draws = [np.stack([rng.integers(0, h, (n4, 2000)),
                               rng.integers(0, w, (n4, 2000))], -1)]
            runs = []
            for d in (dev, torch.device("cpu")):          # the card caches the masks
                proc = Processor(RunConfig(dataset="midgard", flow_source="FARNEBACK",
                                           batch_size=n4), device=d)
                proc.save_images = False
                runs.append(proc.run_detection_foe(sample_yx=draws))
            cc = {}
            for key in ("foe_dense",) + RATES:
                a = np.array([getattr(runs[0][i], key) for i in range(n4)], np.float64)
                b = np.array([getattr(runs[1][i], key) for i in range(n4)], np.float64)
                if not np.array_equal(np.isnan(a), np.isnan(b)):
                    raise AssertionError(f"datasets card vs cpu {key}: {a} against {b}")
                diff = float(np.nanmax(np.abs(a - b), initial=0.0))
                tol = CARD_CPU_FOE_TOL_PX if key == "foe_dense" else CARD_CPU_RATE_TOL
                checks.add(f"midgard card vs cpu {key}", diff, tol, "max |card - cpu|")
                cc[key] = diff
            out["midgard_card_vs_cpu"] = cc

            # ---- depth-less MIDGARD: both engines keep the ones plane
            shutil.rmtree(os.path.join(root4, MIDGARD_SEQ, "depths"))
            sky = {}
            for engine in ("batch", "scan"):
                proc = Processor(RunConfig(dataset="midgard", flow_source="FARNEBACK",
                                           engine=engine, batch_size=batch), device=dev)
                proc.save_images = False
                r = proc.run_detection_foe()
                for i, fr in r.items():
                    share = float(np.mean(proc.dataset.get_sky_segmentation(i)))
                    if not (np.isfinite(fr.sky_tpr) and abs(fr.sky_tpr - share) < 1e-6
                            and np.isnan(fr.sky_fpr)):
                        raise AssertionError(
                            f"datasets depth-less {engine} frame {i}: sky_tpr "
                            f"{fr.sky_tpr} (mask share {share}), sky_fpr {fr.sky_fpr}")
                sky[engine] = [r[i].sky_tpr for i in sorted(r)]
            if not np.allclose(sky["batch"], sky["scan"]):
                raise AssertionError(f"datasets depth-less: engines differ {sky}")
            out["depthless_sky_tpr"] = sky["batch"]

            # ---- PNG decode: a Paeth-filtered 752x480 RGB frame
            gray = np.clip(bench_scene(0, h, w)[0], 0, 255).astype(np.uint8)
            rgb = np.stack([gray, gray[::-1], gray[:, ::-1]], -1)
            data = _png_paeth(rgb)
            before = dict(dsmod.DECODES)
            native_img = dsmod.png_decode(data)
            t0 = time.perf_counter()
            reps = 10
            for _ in range(reps):
                dsmod.png_decode(data)
            native_ms = (time.perf_counter() - t0) * 1e3 / reps
            saved, dsmod._UNFILTER = dsmod._UNFILTER, False
            try:
                t0 = time.perf_counter()
                plain_img = dsmod.png_decode(data)
                plain_ms = (time.perf_counter() - t0) * 1e3
            finally:
                dsmod._UNFILTER = saved
            if not (np.array_equal(native_img, plain_img) and np.array_equal(native_img, rgb)):
                raise AssertionError("datasets png: native and plain decodes differ")
            out["png"] = {"size": f"{w}x{h}", "native_ms": native_ms, "plain_ms": plain_ms,
                          "native_decodes": dsmod.DECODES["native"] - before["native"],
                          "plain_decodes": dsmod.DECODES["plain"] - before["plain"],
                          "native_decodes_total": dsmod.DECODES["native"]}

            # ---- AirSim layout: collect, GT flow on the card, the FoE loop
            sh, sw, n_cap, sbatch = sim
            sroot = os.path.join(tmp, "sim")
            t0 = time.perf_counter()
            col = SimDataCollector(MockSimClient(image_hw=(sh, sw), fov_deg=100),
                                   SIM_COLLECTION, root_data_dir=sroot,
                                   max_iterations=n_cap)
            col.run()
            render_s = time.perf_counter() - t0
            sseq = os.path.relpath(col.get_base_dir(col.configs[0]), sroot)
            os.environ["SIMDATA_PATH"] = sroot
            t0 = time.perf_counter()
            ds = SimDataset(sequence=sseq, device=dev)
            open_s = time.perf_counter() - t0
            if ds.N != n_cap or len(glob.glob(f"{ds.gt_of_path}/*.flo")) != n_cap - 1:
                raise AssertionError(f"datasets sim: {ds.N} frames")
            t0 = time.perf_counter()
            ds.create_ground_truth_optical_flow()
            gt_ms = (time.perf_counter() - t0) * 1e3 / (n_cap - 1)
            states = ds.get_state_filenames()
            gt_err = 0.0
            dev_ms = []
            for i in range(n_cap - 1):
                packed = torch.from_numpy(af.pack_pair(*af.pair_inputs(ds, i, states)))
                on_card = packed.to(dev)
                card = _np(af.calculate_flow_packed(on_card, ds.capture_size))
                cpu = _np(af.calculate_flow_packed(packed, ds.capture_size))
                if not np.isfinite(card).all():
                    raise AssertionError(f"datasets sim: non-finite GT flow, pair {i}")
                gt_err = max(gt_err, float(np.abs(card - cpu).max()))
                dev_ms.append(time_ms(lambda: af.calculate_flow_packed(
                    on_card, ds.capture_size), 5, 1))
            checks.add(f"sim GT flow card vs cpu {sw}x{sh}", gt_err,
                       GT_FLOW_CARD_CPU_TOL_PX, "max |card - cpu| px")
            loops = {}
            for src_name in ("GROUND_TRUTH", "FARNEBACK"):
                proc = Processor(RunConfig(dataset="simulation", sequence=sseq,
                                           flow_source=src_name, batch_size=sbatch),
                                 device=dev)
                proc.save_images = False
                proc.run_detection_foe()                 # warm-up
                torch.cuda.synchronize()
                _reset_launches()
                t0 = time.perf_counter()
                r = proc.run_detection_foe()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = _launches()
                n = counts[k]
                out["launches"][f"simulation {src_name}"] = n
                out.setdefault("expand_launches", {})[f"simulation {src_name}"] = \
                    _hold_expand(f"datasets sim {src_name}", counts, proc._farneback, sh, sw)
                pairs = n_cap - 1
                want = 0 if src_name == "GROUND_TRUTH" else \
                    _per_batch_launches(proc._farneback, sh, sw) * -(-pairs // sbatch)
                if n != want:
                    raise AssertionError(f"datasets sim {src_name}: {n} launches, "
                                         f"expected {want}")
                foes = np.array([r[i].foe_dense for i in sorted(r)])
                gts = np.array([r[i].foe_gt for i in sorted(r)])
                if not np.isfinite(foes).all():
                    raise AssertionError(f"datasets sim {src_name}: FoE {foes}")
                inside = (foes[:, 0] >= 0) & (foes[:, 0] < sw) & (foes[:, 1] >= 0) & \
                    (foes[:, 1] < sh)
                med = np.median(foes, axis=0)
                if src_name == "GROUND_TRUTH" and not inside.all():
                    raise AssertionError(f"datasets sim GT: FoE outside the frame {foes}")
                if not (0 <= med[0] < sw and 0 <= med[1] < sh):
                    raise AssertionError(f"datasets sim {src_name}: median FoE {med}")
                _read_results(f"sim {src_name}", ds.results_path, pairs)
                loops[src_name] = {
                    "frames_per_s": pairs / wall, "launches": n,
                    "median_foe_err_px": float(np.median(np.hypot(*(foes - gts).T))),
                    "foe_in_frame": int(inside.sum()), "pairs": pairs}
            out["sim"] = {"size": f"{sw}x{sh}", "frames": n_cap, "render_s": render_s,
                          "render_s_per_frame": render_s / n_cap, "open_s": open_s,
                          "gt_flow_ms_per_pair": gt_ms,
                          "gt_flow_device_ms_per_pair": float(np.median(dev_ms)),
                          "gt_flow_card_vs_cpu_px": gt_err, "loops": loops}
    finally:
        dsmod.Dataset._infer_sky_segmentation = real_infer
        for v, val in env_before.items():
            if val is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = val
    out["checks"] = checks.finish()
    return out


class _ValidationSplit:
    """Patches ``Validator.run_validation`` to note the fused kernel's launch
    count when validation starts (so a CLI run's launches split into
    detection and validation), its seconds and the stats it returns."""

    def __enter__(self):
        from mav_detection_tpu_torch.eval import validator as tv

        self.runs = []
        self._real = real = tv.Validator.run_validation
        runs = self.runs
        k = "farneback_iterate_fused"

        def run(v):
            import torch

            torch.cuda.synchronize()
            start = _launches()
            t0 = time.perf_counter()
            stats = real(v)
            torch.cuda.synchronize()
            end = _launches()
            runs.append({"launches_before": start[k], "stats": stats, "started": t0,
                         "s": time.perf_counter() - t0,
                         "launches": end[k] - start[k],
                         "counts_before": start,
                         "counts": {key: end[key] - start[key] for key in end},
                         "figures_skipped": v._plots_skipped})
            return stats

        tv.Validator.run_validation = run
        return self

    def __exit__(self, *exc):
        from mav_detection_tpu_torch.eval import validator as tv

        tv.Validator.run_validation = self._real
        return False


def _yolo_score(dev, model_of, fixture, mode):
    """(mean best IoU, detection rate) of TinyYOLO on ``dev`` over a
    fixture's mode imagery (GT flow), as the JAX numbers were scored."""
    from mav_detection_tpu_torch.core.rectangle import Rectangle
    from mav_detection_tpu_torch.models.yolo import boxes_to_host, detect_boxes
    from mav_detection_tpu_torch.pipeline.mode_imagery import mode_image_host

    ious = []
    for i in range(fixture.N):
        j = min(i, fixture.N - 2)
        img = mode_image_host(fixture.get_frame(i), np.asarray(fixture.flows[j], np.float32),
                              mode, seed=i, device=dev)
        b = boxes_to_host(detect_boxes(model_of(mode), img))
        gt = fixture.get_annotation(i)[0]
        best = 0.0
        for k in range(len(b.valid)):
            if b.valid[k]:
                x, y, bw, bh = (float(v) for v in b.xywh[k])
                best = max(best, Rectangle.calculate_iou_safe(
                    Rectangle((x - bw / 2, y - bh / 2), (bw, bh)), gt))
        ious.append(best)
    ious = np.asarray(ious)
    return float(ious.mean()), float((ious > 0.25).mean())


def _box_iou(a, b) -> float:
    """IoU of two center-format boxes."""
    ax1, ay1, ax2, ay2 = a[0] - a[2] / 2, a[1] - a[3] / 2, a[0] + a[2] / 2, a[1] + a[3] / 2
    bx1, by1, bx2, by2 = b[0] - b[2] / 2, b[1] - b[3] / 2, b[0] + b[2] / 2, b[1] + b[3] / 2
    inter = max(0.0, min(ax2, bx2) - max(ax1, bx1)) * max(0.0, min(ay2, by2) - max(ay1, by1))
    return float(inter / max(a[2] * a[3] + b[2] * b[3] - inter, 1e-9))


def _count_launches(fn) -> int:
    """Device activities (kernels, copies, fills) of one call of ``fn``
    from torch.profiler's CUDA events; None where the profiler cannot trace
    the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages() if "CUDA" in str(e.device_type))
    except Exception as e:  # CUPTI may be unavailable to the profiler
        say(f"[yolo]   torch.profiler could not count launches: {e!r}")
        return None
    return n or None


def _host_looks(fn) -> int:
    """Synchronising calls ``fn`` makes (set_sync_debug_mode warnings)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(c.message) for c in caught)


def _post_npz(url: str, data: bytes):
    import urllib.error
    import urllib.request

    from mav_detection_tpu_torch.eval.validator import multipart_body

    body, ctype = multipart_body("video", "frames.npz", data)
    req = urllib.request.Request(f"{url}/predict_video", data=body, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def phase_yolo(dev, sizes=((240, 320), (480, 752)), time_size=(480, 752, 8),
               server=(480, 752, 12), cli=(480, 752, 12)) -> dict:
    """TinyYOLO and what stands on it: load, card against CPU, quality
    against the JAX numbers, device times beside their bounds, the REST
    server, and the CLI's defaults ending in validation."""
    import hashlib
    import io
    import shutil
    import threading
    import urllib.request

    import torch

    from mav_detection_tpu_torch import convert
    from mav_detection_tpu_torch.cli.main import main as cli_main
    from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
    from mav_detection_tpu_torch.models import checkpoint, pretrained
    from mav_detection_tpu_torch.models import yolo as ty
    from mav_detection_tpu_torch.ops.flow import farneback as fb
    from mav_detection_tpu_torch.ops.image.visualize import flow_to_color
    from mav_detection_tpu_torch.serve import _decode_media, _encode_annotated, create_server

    k = "farneback_iterate_fused"
    out = {"launches": {}}
    checks = Checks("yolo")
    here = os.path.dirname(os.path.abspath(__file__))
    if os.environ.get("MAV_CHECKPOINT_PATH"):
        raise AssertionError("yolo: MAV_CHECKPOINT_PATH is set; the shipped "
                             "checkpoints must be read")

    # ---- load: the four shipped files through the port's reader
    load = {}
    for name in YOLO_NAMES:
        path = pretrained.checkpoint_path(name)
        if os.path.dirname(path) != os.path.join(here, "checkpoints") or not os.path.isfile(path):
            raise AssertionError(f"yolo: {name} checkpoint at {path}")
        t0 = time.perf_counter()
        raw = checkpoint.load_msgpack(path)
        t1 = time.perf_counter()
        sd = convert.yolo_state_dict_from_flax(raw)
        t2 = time.perf_counter()
        load[name] = {"bytes": os.path.getsize(path), "read_s": t1 - t0,
                      "convert_s": t2 - t1, "tensors": len(sd),
                      "parameters": int(sum(v.numel() for v in sd.values()))}
    out["load"] = load
    pretrained.clear_cache()

    def model_of(mode, d=dev):
        m = pretrained.load_yolo(mode, d)
        if m is None:
            raise AssertionError(f"yolo: no model for {mode} on {d}")
        return m

    # ---- card against CPU: FLOW_UV imagery and the raw frame, batch of 2
    card_cpu = {}
    for h, w in sizes:
        fx = SyntheticDataset(params=SyntheticParams(height=h, width=w, n_frames=2))
        imgs = np.stack([flow_to_color(fx.flows[0]), fx.get_frame(0)])
        for kind, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            raws, boxes = [], []
            for d in (dev, "cpu"):
                with torch.no_grad():
                    r = model_of("FLOW_UV", d)(ty.pad_to_stride(torch.as_tensor(imgs).to(d)),
                                               dtype)
                raws.append(_np(r))
                boxes.append(ty.boxes_to_host(ty.decode_predictions(r)))
            err = float(np.abs(raws[0] - raws[1]).max())
            checks.add(f"raw predictions {kind} {w}x{h}", err, YOLO_CARD_CPU_TOL[kind],
                       "max |card - cpu| logits")
            kept_diff, matched = 0, 1.0
            for j in range(len(imgs)):
                bc, bp = (b.xywh[j][b.valid[j]] for b in boxes)
                kept_diff = max(kept_diff, abs(len(bc) - len(bp)))
                for box in bc:
                    matched = min(matched, max((_box_iou(box, q) for q in bp), default=0.0))
            checks.add(f"kept boxes {kind} {w}x{h}", kept_diff, YOLO_KEPT_DIFF[kind],
                       "max |card - cpu| per frame")
            checks.add(f"matched box IoU {kind} {w}x{h}", matched, YOLO_MATCHED_IOU[kind],
                       "min IoU", at_least=True)
            card_cpu[f"{w}x{h} {kind}"] = {
                "max_abs_err_logits": err, "kept_diff": kept_diff, "min_matched_iou": matched,
                "kept": [int(b.valid.sum()) for b in boxes]}
    out["card_vs_cpu"] = card_cpu

    # ---- quality against the JAX package's numbers
    quality = {}
    for fx_name, kw in YOLO_FIXTURES.items():
        fixture = SyntheticDataset(params=SyntheticParams(**kw))
        for mode in ("FLOW_UV", "FLOW_RADIAL", "FLOW_FOE_YOLO"):
            key = f"{fx_name} {mode}"
            iou, rate = _yolo_score(dev, model_of, fixture, mode)
            j_iou, j_rate = YOLO_JAX[key]
            checks.add(f"IoU {key}", abs(iou - j_iou), YOLO_IOU_TOL, f"|card {iou:.5f} - jax|")
            checks.add(f"detection rate {key}", abs(rate - j_rate), 1.0 / fixture.N + 1e-9,
                       f"|card {rate:.4f} - jax|")
            quality[key] = {"iou": iou, "rate": rate, "jax_iou": j_iou, "jax_rate": j_rate}
    out["quality"] = quality

    # ---- device time at 752x480 b=8, beside the bounds
    h, w, b = time_size
    fx = SyntheticDataset(params=SyntheticParams(height=h, width=w, n_frames=b + 1))
    imgs = np.stack([flow_to_color(fx.flows[i]) for i in range(b)])
    x = torch.as_tensor(imgs).to(dev)
    model = model_of("FLOW_UV")
    dt = torch.bfloat16
    with torch.no_grad():
        fwd = lambda: model(x, dt)  # noqa: E731
        raw = fwd()
        dec = lambda: ty.decode_predictions(raw)  # noqa: E731
        boxes = dec()
        fl = _conv_flops(model, fwd)
        weights = _nbytes(*model.parameters())
        fwd_bound, fwd_by = bound_ms(_nbytes(x, raw) + weights, fl["fp32"], fl["bf16"])
        gh, gw = raw.shape[1:3]
        kk = min(64, gh * gw * 3)
        # decode: ~12 fp32 operations per raw value, the k x k IoU matrix
        # (~20 each) and the k masked steps over (b, k)
        dec_ops = 12.0 * raw.numel() + 20.0 * b * kk * kk + 6.0 * b * kk * kk
        dec_bound, dec_by = bound_ms(_nbytes(raw, *boxes), dec_ops)
        fwd_graph, fwd_timer = _device_ms(fwd, 5)
        dec_graph, dec_timer = _device_ms(dec, 5)
        timing = {
            "size": f"{w}x{h}", "batch": b,
            "forward": {"ms": fwd_graph, "timer": fwd_timer, "events_ms": time_ms(fwd, 10),
                        "bound_ms": fwd_bound, "bound_by": fwd_by,
                        "gflop_bf16": fl["bf16"] / 1e9, "gflop_fp32": fl["fp32"] / 1e9,
                        "launches": _count_launches(fwd)},
            "decode_nms": {"ms": dec_graph, "timer": dec_timer, "events_ms": time_ms(dec, 10),
                           "bound_ms": dec_bound, "bound_by": dec_by,
                           "launches": _count_launches(dec)},
            "detect_batch_wall_ms": wall_ms(lambda: ty.batch_box_strings(model, imgs, b), 5),
            "host_looks_per_batch": _host_looks(lambda: ty.batch_box_strings(model, imgs, b)),
        }
    out["timing"] = timing

    # ---- the REST server, in-process
    sh, sw, sn = server
    fx = SyntheticDataset(params=SyntheticParams(height=sh, width=sw, n_frames=sn))
    frames = np.stack(fx.frames[:sn])
    buf = io.BytesIO()
    np.savez(buf, frames=frames)
    media = buf.getvalue()
    srv = create_server(port=0, device=dev)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://{srv.server_address[0]}:{srv.server_address[1]}"
    try:
        engine = srv.engine
        direct = engine.predict(frames)
        status, _ = _post_npz(url, media)
        with urllib.request.urlopen(
                f"{url}/predict_video_boxes?hash={hashlib.sha1(media).hexdigest()}") as r:
            served = json.loads(r.read())
        if status != 200 or served != direct:
            raise AssertionError(f"yolo server: HTTP {status}, boxes equal {served == direct}")
        results = [None] * 4
        ts = [threading.Thread(target=lambda i=i: results.__setitem__(i, _post_npz(url, media)))
              for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        if [r[0] for r in results] != [200] * 4 or len({r[1] for r in results}) != 1:
            raise AssertionError(f"yolo server: concurrent posts {[r and r[0] for r in results]}")
        bad, _ = _post_npz(url, b"\x00\x00\x00\x18ftypmp42" + bytes(64))
        if bad != 400:
            raise AssertionError(f"yolo server: non-npz media answered {bad}")
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            _post_npz(url, media)
        req_s = (time.perf_counter() - t0) / reps
        t0 = time.perf_counter()
        got, _ = _decode_media(media)
        t1 = time.perf_counter()
        boxes_s = engine.predict(got)
        t2 = time.perf_counter()
        _encode_annotated(got, boxes_s)
        t3 = time.perf_counter()
        out["server"] = {
            "size": f"{sw}x{sh}", "frames": sn, "media_bytes": len(media),
            "requests_per_s": 1.0 / req_s, "ms_per_frame": req_s * 1e3 / sn,
            "decode_ms": (t1 - t0) * 1e3, "infer_ms": (t2 - t1) * 1e3,
            "annotate_ms": (t3 - t2) * 1e3,
            "boxes": sum(len(v) for v in direct.values())}
    finally:
        srv.shutdown()
        srv.server_close()

    # ---- the CLI's defaults: detection then validation, on the card
    ch, cw, cn = cli
    cwd = os.getcwd()
    env_keys = ("MIDGARD_PATH", "YOLO_INFERENCE_HOST", "YOLOv4_PATH", "MAVTPU_NN_MEDIA")
    env_before = {v: os.environ.get(v) for v in env_keys}
    per_batch = _per_batch_launches(fb.tuned_flow_params(ch, cw), ch, cw)
    n_pairs = cn - 1
    want = per_batch * -(-n_pairs // 8)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "midgard")
            SyntheticDataset(sequence=MIDGARD_SEQ, params=SyntheticParams(
                height=ch, width=cw, n_frames=cn), materialize_to=root)
            seq = os.path.join(root, MIDGARD_SEQ)
            # a MIDGARD recording has neither GT flow nor results yet
            shutil.rmtree(os.path.join(seq, "optical-flow"))
            shutil.rmtree(os.path.join(seq, "results"))
            with open(os.path.join(tmp, "settings.json"), "w") as f:
                json.dump({"train_sequences": [MIDGARD_SEQ], "validation_sequences": []}, f)
            os.chdir(tmp)
            os.environ["MIDGARD_PATH"] = root
            for v in env_keys[1:]:
                os.environ.pop(v, None)
            cli_out = {}
            params = fb.tuned_flow_params(ch, cw)
            with _ValidationSplit() as split:
                _reset_launches()
                t0 = time.perf_counter()
                cli_main(["--headless"])
                torch.cuda.synchronize()
                cli_out["wall_s"] = time.perf_counter() - t0
                val = split.runs[-1]
                cli_out["detection_launches"] = val["launches_before"]
                cli_out["validation_launches"] = val["launches"]
                cli_out["expand_launches"] = {
                    "detection": _hold_expand("yolo cli", val["counts_before"], params,
                                              ch, cw),
                    "validation": _hold_expand("yolo cli validation", val["counts"],
                                               params, ch, cw)}
                cli_out["validation_s"] = val["s"]
                cli_out["figures"] = "skipped (no matplotlib)" if val["figures_skipped"] \
                    else "written"
                local = val["stats"]
                if (val["launches_before"], val["launches"]) != (want, want):
                    raise AssertionError(
                        f"yolo cli: launches {val['launches_before']} in detection, "
                        f"{val['launches']} in validation, expected {want} each")
                for key in ("iou_mean", "iou_std", "detection_rate"):
                    if local.get(key) is None or not np.isfinite(local[key]):
                        raise AssertionError(f"yolo cli: {key} {local.get(key)}")
                if not os.path.isfile(os.path.join(seq, "validation.npy")):
                    raise AssertionError("yolo cli: no validation.npy")
                cache = glob.glob(os.path.join(seq, "bounding-boxes", "*-FLOW_UV.json"))
                if len(cache) != 1:
                    raise AssertionError(f"yolo cli: box cache {cache}")
                _read_results("yolo cli", os.path.join(seq, "results"), n_pairs,
                              NAN_WITHOUT_GT_FOE)
                cli_out["stats"] = local

                # the remote branch against the in-process port server
                srv = create_server(port=0, mode="FLOW_UV", device=dev)
                thread = threading.Thread(target=srv.serve_forever, daemon=True)
                thread.start()
                try:
                    os.environ["YOLO_INFERENCE_HOST"] = \
                        f"http://{srv.server_address[0]}:{srv.server_address[1]}"
                    _reset_launches()
                    cli_main(["--headless", "--validate"])
                    torch.cuda.synchronize()
                finally:
                    os.environ.pop("YOLO_INFERENCE_HOST", None)
                    srv.shutdown()
                    srv.server_close()
                remote = split.runs[-1]
                for key in ("iou_mean", "iou_std", "detection_rate"):
                    if remote["stats"][key] != local[key]:
                        raise AssertionError(f"yolo remote: {key} {remote['stats'][key]} "
                                             f"against local {local[key]}")
                if not os.path.isfile(os.path.join(seq, "nn-input-flow_uv.npz")):
                    raise AssertionError("yolo remote: no nn-input npz")
                cli_out["remote_validation_s"] = remote["s"]
                cli_out["remote_validation_launches"] = remote["launches"]
                cli_out["expand_launches"]["remote_validation"] = _hold_expand(
                    "yolo remote validation", remote["counts"], params, ch, cw)

            # --prepare-dataset in FLOW_FOE_YOLO mode
            os.environ["YOLOv4_PATH"] = os.path.join(tmp, "yolo")
            _reset_launches()
            t0 = time.perf_counter()
            cli_main(["--headless", "--prepare-dataset", "--mode", "FLOW_FOE_YOLO"])
            torch.cuda.synchronize()
            cli_out["convert_s"] = time.perf_counter() - t0
            counts = _launches()
            cli_out["convert_launches"] = counts[k]
            cli_out["expand_launches"]["convert"] = _hold_expand(
                "yolo convert", counts, params, ch, cw)
            imgs_out = sorted(glob.glob(os.path.join(tmp, "yolo", "dataset", "images", "*.png")))
            anns_out = glob.glob(os.path.join(tmp, "yolo", "dataset", "labels", "yolo", "*.txt"))
            if len(imgs_out) != cn - 2 or len(anns_out) != cn - 2:
                raise AssertionError(f"yolo convert: {len(imgs_out)} images, "
                                     f"{len(anns_out)} labels")
            if cli_out["convert_launches"] != per_batch * (cn - 2):
                raise AssertionError(f"yolo convert: {cli_out['convert_launches']} launches")
            from mav_detection_tpu_torch.data.dataset import imread

            if imread(imgs_out[0]).shape != (ch, cw, 3):
                raise AssertionError("yolo convert: image shape")
    finally:
        os.chdir(cwd)
        for v, val in env_before.items():
            if val is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = val
    out["cli"] = cli_out
    out["launches"] = {"detection": cli_out["detection_launches"],
                       "validation": cli_out["validation_launches"],
                       "remote_validation": cli_out["remote_validation_launches"],
                       "convert": cli_out["convert_launches"]}
    out["expand_launches"] = cli_out["expand_launches"]
    out["checks"] = checks.finish()
    return out


# ---------------------------------------------------------------- training
# phase train gates. The JAX package's evals of the shipped checkpoints on
# the CPU, tests/train_reference_numbers.py (NUMBERS): the card's must lie
# within these distances of them
TRAIN_EVAL_TOL = {"eval_raft": (0.01, 0.05),          # EPE, drone EPE (px)
                  "eval_raft_detection": (0.02, 0.02),  # TPR with RAFT, GT flow
                  "eval_sky": (0.005, 0.005),          # net TPR, FPR
                  "eval_yolo": 0.005,                  # mean IoU per mode
                  "shift_ladder_epe": 0.02}            # px
# one update card against CPU from the shipped weights on the same draws,
# at the peak learning rate (the trainers' first update runs at 0): the
# loss, relative; the parameters, as the median and largest difference in
# units of one step of the learning rate. Adam divides each gradient by its
# own magnitude, so where a gradient is rounding noise (a conv bias followed
# by GroupNorm has a gradient of exactly 0) the update is noise of up to a
# step either way; fp32 (TF32 off) rounds at 1e-7, the product bf16 at 8
# bits of mantissa in cuDNN and oneDNN at other points
# (bf16: TinyYOLO's logits differ by up to 0.63 between cuDNN and oneDNN
# (phase yolo), and its loss is 100x a mean BCE over them: measured 0.023)
TRAIN_CARD_CPU_LOSS_RTOL = {"fp32": 1e-4, "bf16": 5e-2}
TRAIN_CARD_CPU_MEDIAN_STEPS = {"fp32": 1e-3, "bf16": 0.2}
TRAIN_CARD_CPU_MAX_STEPS = 2.5
TRAIN_SIZES = {"raft": (128, 160), "sky": (240, 320), "yolo": (240, 320)}
TRAIN_PEAK_LR = {"raft": 2.5e-4, "sky": 1e-3, "yolo": 1e-3}


def _flat_tree(tree, prefix=()):
    """(key path, leaf) pairs of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_tree(v, prefix + (k,))
    else:
        yield prefix, tree


def _sha256_dir(d: str) -> dict:
    import hashlib

    out = {}
    for p in sorted(glob.glob(os.path.join(d, "*"))):
        with open(p, "rb") as f:
            out[os.path.basename(p)] = hashlib.sha256(f.read()).hexdigest()
    return out


def _train_model(net: str, dev, params):
    """A port net of ``net`` holding ``params`` (a state_dict), on ``dev``."""
    from mav_detection_tpu_torch.models.raft import RAFT
    from mav_detection_tpu_torch.models.sky_segmentation import SkyUNet
    from mav_detection_tpu_torch.models.yolo import TinyYOLO

    model = {"raft": RAFT, "sky": SkyUNet, "yolo": TinyYOLO}[net]()
    model.load_state_dict(params)
    return model.to(dev)


def _batch_loss(net: str, model, sc, dtype, mode="APPEARANCE_RGB"):
    """The trainer's loss of one batch (cli/train.py), in ``dtype``."""
    from mav_detection_tpu_torch.cli import train as tt
    from mav_detection_tpu_torch.models.raft import RAFTConfig

    if net == "raft":
        return tt.raft_batch_loss(model, sc, 8, config=RAFTConfig(dtype=dtype))
    if net == "sky":
        return tt.sky_batch_loss(model, sc, dtype)
    return tt.yolo_batch_loss(model, sc, mode, dtype)


def _one_update(net: str, dev, params, draws, dtype):
    """One update of the trainer's loss and optimizer chain at the peak
    learning rate -> (loss, parameters after it on the CPU)."""
    import torch

    from mav_detection_tpu_torch.data.synthgen import generate_batch
    from mav_detection_tpu_torch.models import optim

    model = _train_model(net, dev, params)
    lr = TRAIN_PEAK_LR[net]
    opt = optim.TrainOptimizer(model.parameters(), lambda c: lr,
                               weight_decay=1e-5 if net == "raft" else None)
    b, h, w = draws.ground_noise.shape
    sc = generate_batch(b, h, w, draws=draws, device=dev)
    opt.zero_grad()
    loss = _batch_loss(net, model, sc, dtype)
    loss.backward()
    opt.step()
    return float(loss), {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _train_flops(net: str, dev, params, draws, dtype) -> dict:
    """Convolution FLOPs of one forward of the trainer's loss (fp32 and
    bf16 by layer dtype); a step is counted as 3x them."""
    import torch

    from mav_detection_tpu_torch.data.synthgen import generate_batch

    model = _train_model(net, dev, params)
    b, h, w = draws.ground_noise.shape
    sc = generate_batch(b, h, w, draws=draws, device=dev)
    with torch.no_grad():
        return _conv_flops(model, lambda: _batch_loss(net, model, sc, dtype))


class _ChunkMeter:
    """Patches ``cli.train._scan_chunks`` for one trainer call: each chunk
    is timed on the host clock between synchronisations, the synchronising
    calls inside it are counted, and those of the whole chunk loop outside the
    selector and the checkpoint writer (the one pull of each chunk's
    losses) are counted apart."""

    def __enter__(self):
        import traceback
        import warnings

        import torch

        from mav_detection_tpu_torch.cli import train as tt

        self.chunks, self.selector_calls, self.outer_looks = [], 0, None
        self._real = real = tt._scan_chunks
        meter = self

        def syncs(caught):
            return [f"{os.path.basename(c.filename)}:{c.lineno}" for c in caught
                    if "synchroniz" in str(c.message)]

        def inner_looks(fn):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = fn()
            return out, len(syncs(caught))

        def scan(run_chunk, params, opt_state, key, steps, chunk, label, selector=None,
                 select_every=1, save_best_to="", to_tree=None):
            def timed(*a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, looks = inner_looks(lambda: run_chunk(*a))
                torch.cuda.synchronize()
                meter.chunks.append({"steps": a[3], "ms": (time.perf_counter() - t0) * 1e3,
                                     "looks": looks})
                return out

            def sel(p):
                meter.selector_calls += 1
                return inner_looks(lambda: selector(p))[0]

            def tree(sd):
                return inner_looks(lambda: to_tree(sd))[0]

            result = [None]

            def drive():
                result[0] = real(timed, params, opt_state, key, steps, chunk, label,
                                 selector=sel if selector is not None else None,
                                 select_every=select_every, save_best_to=save_best_to,
                                 to_tree=tree if to_tree is not None else None)

            sites = []

            def record(message, category, filename, lineno, *a, **k):
                if "synchroniz" in str(message):
                    # the innermost frames that made the call; the first
                    # set_sync_debug_mode("warn") of a process warns once
                    # itself, which is no call of the trainer's
                    stack = traceback.extract_stack()[:-2]
                    if stack and stack[-1].name == "set_sync_debug_mode":
                        return
                    sites.append(" < ".join(
                        f"{os.path.basename(f.filename)}:{f.lineno}:{f.name}"
                        for f in stack[::-1][:4]))

            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = record
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    drive()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            meter.outer_sites = sites
            meter.outer_looks = len(sites)
            return result[0]

        tt._scan_chunks = scan
        return self

    def __exit__(self, *exc):
        from mav_detection_tpu_torch.cli import train as tt

        tt._scan_chunks = self._real
        return False


def _device_ops(prof, n: int = 10):
    """(device ms, activities, the ``n`` device activities that take the
    most time) of a torch.profiler capture: kernels, copies and fills on the
    card, by name, their own time. User annotations on the device timeline
    (``Optimizer.step#AdamW.step``) span kernels counted already and are
    left out."""
    avgs = [e for e in prof.key_averages() if "CUDA" in str(e.device_type)
            and not getattr(e, "is_user_annotation", False) and "#" not in e.key]
    total = sum(e.self_device_time_total for e in avgs)
    top = sorted(avgs, key=lambda e: e.self_device_time_total, reverse=True)[:n]
    return total / 1e3, sum(e.count for e in avgs), [{"name": e.key[:90], "device_ms": e.self_device_time_total / 1e3,
                          "share": e.self_device_time_total / max(total, 1e-9),
                          "calls": e.count} for e in top]


def _train_reference_numbers() -> dict:
    """``NUMBERS`` of tests/train_reference_numbers.py (the JAX package's
    evals of the shipped checkpoints; the module imports no JAX)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_reference_numbers", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                "tests", "train_reference_numbers.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.NUMBERS


def phase_train(dev, sizes=None, batch: int = 8, steps: int = 20, chunk: int = 10,
                cli_steps: int = 20) -> dict:
    """Training on the card: one update card against CPU per net; a short
    resumed run of each trainer with its selector (ms per step, share of
    bound, peak memory, host looks per chunk); the evals of the shipped
    checkpoints against the JAX package's numbers; the CLI in a subprocess
    into a temporary MAV_CHECKPOINT_PATH, with checkpoints/ unchanged."""
    import torch

    from mav_detection_tpu_torch import convert
    from mav_detection_tpu_torch.cli import train as tt
    from mav_detection_tpu_torch.data.synthgen import draw_scenes, generate_batch
    from mav_detection_tpu_torch.models import checkpoint, optim, pretrained
    from mav_detection_tpu_torch.ops.flow import farneback_iter as fi
    from mav_detection_tpu_torch.utils.tracing import trace_to

    sizes = sizes or TRAIN_SIZES
    here = os.path.dirname(os.path.abspath(__file__))
    if os.environ.get("MAV_CHECKPOINT_PATH"):
        raise AssertionError("train: MAV_CHECKPOINT_PATH is set; the shipped "
                             "checkpoints must be read")
    REF = _train_reference_numbers()
    ckpt_dir = os.path.join(here, "checkpoints")
    sha_before = _sha256_dir(ckpt_dir)
    checks = Checks("train")
    out = {"card_vs_cpu": {}, "runs": {}, "evals": {}}
    shipped = {"raft": pretrained.load_raft_params(), "sky": pretrained.load_sky_params(),
               "yolo": pretrained.load_yolo_params(),
               "yolo FLOW_UV": pretrained.load_yolo_params("FLOW_UV")}

    # ---- 1. one update card against CPU on the same draws
    for net, dts in (("raft", ("fp32", "bf16")), ("sky", ("bf16",)), ("yolo", ("bf16",))):
        h, w = sizes[net]
        draws = draw_scenes(batch, h, w, generator=torch.Generator().manual_seed(11))
        for dt in dts:
            dtype = torch.float32 if dt == "fp32" else torch.bfloat16
            lc, pc = _one_update(net, dev, shipped[net], draws, dtype)
            lh, ph = _one_update(net, torch.device("cpu"), shipped[net], draws, dtype)
            diff = torch.cat([(pc[k] - ph[k]).abs().flatten() for k in ph])
            steps_of = diff / TRAIN_PEAK_LR[net]
            r = {"loss_card": lc, "loss_cpu": lh, "loss_rel_diff": abs(lc - lh) / abs(lh),
                 "max_param_diff": float(diff.max()),
                 "median_param_diff_steps": float(steps_of.median()),
                 "max_param_diff_steps": float(steps_of.max())}
            out["card_vs_cpu"][f"{net} {dt} {w}x{h} b={batch}"] = r
            say(f"[train]   one update {net} {dt}: {json.dumps(r)}")
            checks.add(f"{net} {dt} loss", r["loss_rel_diff"], TRAIN_CARD_CPU_LOSS_RTOL[dt],
                       "relative difference")
            checks.add(f"{net} {dt} parameters", r["median_param_diff_steps"],
                       TRAIN_CARD_CPU_MEDIAN_STEPS[dt], "median difference in lr steps")
            checks.add(f"{net} {dt} parameters", r["max_param_diff_steps"],
                       TRAIN_CARD_CPU_MAX_STEPS, "largest difference in lr steps")

    # ---- 2. a short resumed run of each trainer with its selector
    tmp = tempfile.mkdtemp(prefix="mav_train_")
    os.environ["MAV_CHECKPOINT_PATH"] = tmp
    pretrained.clear_cache()
    fi.reset_launch_counts()
    try:
        for tag, fn, kw, net, name in (
                ("raft", tt.train_raft, {}, "raft", "raft"),
                ("sky", tt.train_sky, {}, "sky", "sky"),
                ("yolo APPEARANCE_RGB", tt.train_yolo, {"mode": "APPEARANCE_RGB"}, "yolo",
                 "yolo"),
                ("yolo FLOW_UV", tt.train_yolo, {"mode": "FLOW_UV"}, "yolo",
                 "yolo_flow_uv")):
            h, w = sizes[net]
            init = shipped[tag if tag == "yolo FLOW_UV" else net]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with _ChunkMeter() as meter:
                model, losses = fn(steps=steps, batch=batch, hw=(h, w), chunk=chunk,
                                   init_params=init, device=dev,
                                   save_best_to=pretrained.checkpoint_path(name), **kw)
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            # the trained weights written as the CLI writes them, read back
            # through the port's reader: the same outputs as in memory
            to_tree = {"raft": convert.flax_from_raft_state_dict,
                       "sky": convert.flax_from_sky_state_dict,
                       "yolo": convert.flax_from_yolo_state_dict}[net]
            path = os.path.join(tmp, f"{name}.final.msgpack")
            checkpoint.save_msgpack(path, to_tree(model.state_dict()))
            back = _train_model(net, dev, {
                "raft": convert.raft_state_dict_from_flax, "sky": convert.sky_state_dict_from_flax,
                "yolo": convert.yolo_state_dict_from_flax}[net](checkpoint.load_msgpack(path)))
            probe = draw_scenes(2, h, w, generator=torch.Generator().manual_seed(5))
            sc = generate_batch(2, h, w, draws=probe, device=dev)
            mode = kw.get("mode", "APPEARANCE_RGB")
            with torch.no_grad():
                same = float((_batch_loss(net, model, sc, torch.float32, mode)
                              - _batch_loss(net, back, sc, torch.float32, mode)).abs())
            checks.add(f"{tag} written and read back", same, 0.0,
                       "loss difference from the in-memory net")
            if not np.isfinite(losses).all() or len(losses) != steps:
                raise AssertionError(f"train {tag}: losses {losses}")
            timed = meter.chunks[1:] or meter.chunks
            ms_step = sum(c["ms"] for c in timed) / sum(c["steps"] for c in timed)
            fl = _train_flops(net, dev, init,
                              draw_scenes(batch, h, w, generator=torch.Generator().manual_seed(1)),
                              torch.bfloat16)
            params_bytes = sum(p.numel() * 4 for p in model.parameters())
            # a step reads and writes the parameters, both Adam moments and
            # the gradients once each, and reads the scene draws
            nbytes = 8 * params_bytes + 4 * batch * (4 * h * w + 40)
            step_bound, bound_by = bound_ms(nbytes, 3 * fl["fp32"], 3 * fl["bf16"])
            n_chunks = len(meter.chunks)
            r = {"size": f"{w}x{h}", "batch": batch, "steps": steps, "chunk": chunk,
                 "ms_per_step": ms_step, "steps_per_s": 1e3 / ms_step,
                 "chunk_ms": [c["ms"] for c in meter.chunks],
                 "wall_s_with_selection": wall, "selector_calls": meter.selector_calls,
                 "bound_ms_per_step": step_bound, "bound_by": bound_by,
                 "share_of_bound": step_bound / ms_step,
                 "gflop_per_step_bf16": 3 * fl["bf16"] / 1e9,
                 "gflop_per_step_fp32": 3 * fl["fp32"] / 1e9,
                 "max_memory_allocated_bytes": peak,
                 "host_looks_in_chunks": [c["looks"] for c in meter.chunks],
                 "host_looks_per_chunk": meter.outer_looks / n_chunks,
                 "host_look_sites": meter.outer_sites,
                 "first_loss": float(losses[0]), "last_loss": float(losses[-1])}
            # one more step of the trained net under the profiler: the
            # device ops that take the most time, and the idle share
            opt = optim.TrainOptimizer(model.parameters(), lambda c: TRAIN_PEAK_LR[net],
                                       weight_decay=1e-5 if net == "raft" else None)
            sc1 = generate_batch(batch, h, w, draws=draw_scenes(
                batch, h, w, generator=torch.Generator().manual_seed(2)), device=dev)

            def one_step():
                opt.zero_grad()
                _batch_loss(net, model, sc1, torch.bfloat16, mode).backward()
                opt.step()

            one_step()
            torch.cuda.synchronize()
            with trace_to(os.path.join(tmp, "trace_" + name)) as prof:
                t1 = time.perf_counter()
                one_step()
                torch.cuda.synchronize()
                step_wall = (time.perf_counter() - t1) * 1e3
            dms, activities, top = _device_ops(prof, 6)
            r["traced_step"] = {"wall_ms": step_wall, "device_ms": dms,
                                "device_idle_share": 1.0 - dms / step_wall,
                                "device_activities": activities, "top_device_ops": top}
            out["runs"][tag] = r
            say(f"[train]   {tag}: {json.dumps(r)}")
            checks.add(f"{tag} host looks inside each chunk after the first",
                       float(max(r["host_looks_in_chunks"][1:] or [0])), 0.0, "looks")
            checks.add(f"{tag} host looks per chunk outside the selector",
                       r["host_looks_per_chunk"], 1.0, "looks")
        out["launches_train"] = dict(fi.LAUNCHES)
    finally:
        os.environ.pop("MAV_CHECKPOINT_PATH", None)
        pretrained.clear_cache()

    # ---- 3. the evals of the shipped checkpoints on the card
    raft = pretrained.load_raft(dev)
    ev = {"eval_raft": list(tt.eval_raft(raft)),
          "eval_raft_detection": list(tt.eval_raft_detection(raft)),
          "shift_ladder_epe": tt.shift_ladder_epe(raft),
          "eval_sky": list(tt.eval_sky(pretrained.load_sky(dev))),
          "eval_yolo": {m: list(tt.eval_yolo(pretrained.load_yolo(m, dev), mode=m))
                        for m in ("APPEARANCE_RGB", "FLOW_UV", "FLOW_RADIAL",
                                  "FLOW_FOE_YOLO")}}
    out["evals"] = {"card": ev, "jax_cpu": REF}
    for key in ("eval_raft", "eval_raft_detection"):
        for i, tol in enumerate(TRAIN_EVAL_TOL[key]):
            checks.add(f"{key}[{i}]", abs(ev[key][i] - REF[key][i]), tol,
                       f"|card - JAX| (card {ev[key][i]:.5f}, JAX {REF[key][i]:.5f})")
    for i, tol in enumerate(TRAIN_EVAL_TOL["eval_sky"]):
        checks.add(f"eval_sky[{i}]", abs(ev["eval_sky"][i] - REF["eval_sky"][i]), tol,
                   f"|card - JAX| (card {ev['eval_sky'][i]:.5f})")
    for m, (iou, _) in ev["eval_yolo"].items():
        checks.add(f"eval_yolo {m} IoU", abs(iou - REF["eval_yolo"][m][0]),
                   TRAIN_EVAL_TOL["eval_yolo"],
                   f"|card - JAX| (card {iou:.5f}, JAX {REF['eval_yolo'][m][0]:.5f})")
    checks.add("shift_ladder_epe", abs(ev["shift_ladder_epe"] - REF["shift_ladder_epe"]),
               TRAIN_EVAL_TOL["shift_ladder_epe"],
               f"|card - JAX| px (card {ev['shift_ladder_epe']:.5f})")

    # ---- 4. the CLI in a subprocess into a temporary checkpoint root
    with tempfile.TemporaryDirectory(prefix="mav_cli_train_") as root:
        env = dict(os.environ, MAV_CHECKPOINT_PATH=root)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mav_detection_tpu_torch.cli.train", "--model", "all",
             "--steps", str(cli_steps), "--chunk", str(chunk)],
            cwd=here, env=env, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"train CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
        written = sorted(os.listdir(root))
        if written != ["raft.msgpack", "sky.msgpack", "yolo.msgpack"]:
            raise AssertionError(f"train CLI wrote {written}")
        os.environ["MAV_CHECKPOINT_PATH"] = root
        pretrained.clear_cache()
        try:
            sc_probe = draw_scenes(2, 128, 160, generator=torch.Generator().manual_seed(9))
            sc = generate_batch(2, 128, 160, draws=sc_probe, device=dev)
            finite = []
            for net, model in (("raft", pretrained.load_raft(dev)),
                               ("sky", pretrained.load_sky(dev)),
                               ("yolo", pretrained.load_yolo(None, dev))):
                with torch.no_grad():
                    finite.append(bool(torch.isfinite(_batch_loss(net, model, sc,
                                                                  torch.float32))))
        finally:
            os.environ.pop("MAV_CHECKPOINT_PATH", None)
            pretrained.clear_cache()
        if not all(finite):
            raise AssertionError(f"train CLI: non-finite losses of the written nets {finite}")
        logs = [ln for ln in proc.stderr.splitlines() if "[raft]" in ln or "[sky]" in ln
                or "[yolo" in ln]
        out["cli"] = {"s": cli_s, "written": written, "log": logs[-8:]}
    sha_after = _sha256_dir(ckpt_dir)
    if sha_after != sha_before:
        raise AssertionError("train: checkpoints/ changed during the phase")
    out["checkpoints_sha256_unchanged"] = len(sha_after)
    out["checks"] = checks.finish()
    return out


def phase_tools(dev, size=(480, 752), batch: int = 8) -> dict:
    """trace_to around one main-path batch (the ten device ops that take
    the most time), foe_angular_error_map card against CPU, run_demo on the
    mock client, and the figures' numbers with matplotlib absent."""
    import builtins

    import torch

    from mav_detection_tpu_torch.cli.demo import run_demo
    from mav_detection_tpu_torch.core.config import FlowSource, RunConfig
    from mav_detection_tpu_torch.data.dataset import png_decode
    from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
    from mav_detection_tpu_torch.eval import figures
    from mav_detection_tpu_torch.pipeline.processor import Processor
    from mav_detection_tpu_torch.sim.client import MockSimClient, Vector3
    from mav_detection_tpu_torch.utils.tracing import trace_to

    out = {}
    checks = Checks("tools")
    h, w = size
    cfg = RunConfig(dataset="synthetic", flow_source="FARNEBACK", batch_size=batch,
                    headless=True)
    sp = SyntheticParams(height=h, width=w, n_frames=batch + 1)
    cfg.get_dataset = lambda **_: SyntheticDataset(params=sp)
    proc = Processor(cfg, device=dev)
    proc.save_images = False
    with tempfile.TemporaryDirectory() as tmp:
        ds = proc.dataset
        ds.seq_path = tmp
        ds.results_path = os.path.join(tmp, "results")
        proc.run_detection_foe()                       # warm-up
        torch.cuda.synchronize()
        proc.detection_results = {}
        _reset_launches()
        with trace_to(os.path.join(tmp, "trace")) as prof:
            proc.run_detection_foe()
        launches = _launches()
        _hold_expand("tools trace", launches, proc._farneback, h, w)
        traces = glob.glob(os.path.join(tmp, "trace", "trace_*.json"))
        trace_bytes = os.path.getsize(traces[0]) if len(traces) == 1 else 0
    if trace_bytes == 0:
        raise AssertionError(f"tools: trace files {traces}")

    device_ms, activities, top = _device_ops(prof)
    out["trace"] = {"size": f"{w}x{h}", "batch": batch, "trace_bytes": trace_bytes,
                    "launches": launches, "device_ms": device_ms,
                    "device_activities": activities, "top_device_ops": top}
    checks.add("fused kernel launches in the traced batch", float(
        launches["farneback_iterate_fused"]), 1.0, "launches", at_least=True)

    # foe_angular_error_map card against CPU
    fds = SyntheticDataset(params=SyntheticParams(height=240, width=320, n_frames=9,
                                                  expansion=0.035, foe=(190.0, 110.0)))
    card = figures.foe_angular_error_map(fds, n_frames=8, device=dev)
    cpu = figures.foe_angular_error_map(fds, n_frames=8, device="cpu")
    err = float(np.abs(card - cpu).max())
    out["foe_angular_error_map"] = {"max_abs_diff_deg": err,
                                    "median_deg": float(np.median(card)),
                                    "ms": wall_ms(lambda: figures.foe_angular_error_map(
                                        fds, n_frames=8, device=dev), 3)}
    checks.add("foe_angular_error_map card vs CPU", err, 0.02, "max |card - CPU| deg")

    # run_demo on the mock client
    with tempfile.TemporaryDirectory() as tmp:
        client = MockSimClient(image_hw=(256, 384))
        client.set_pose("Drone1", Vector3(0.0, 0.0, -30.0), 0.0)
        t0 = time.perf_counter()
        vis = run_demo(client, out_path=os.path.join(tmp, "test.png"))
        demo_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "test.png"), "rb") as f:
            back = png_decode(f.read())[..., ::-1]
    if not np.array_equal(back, vis) or vis.std() <= 1.0:
        raise AssertionError("tools: the demo PNG does not decode to its image")
    out["demo"] = {"size": "384x256", "s": demo_s, "std": float(vis.std())}

    # the figures' numbers with matplotlib absent
    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("matplotlib barred for this check")
        return real_import(name, *a, **kw)

    builtins.__import__ = no_matplotlib
    try:
        with tempfile.TemporaryDirectory() as tmp:
            rcfg = RunConfig(dataset="synthetic", mode="FLOW_FOE_CLUSTERING",
                             flow_source="GROUND_TRUTH", headless=True)
            fp = SyntheticParams(height=120, width=160, n_frames=8, expansion=0.035,
                                 foe=(95.0, 55.0))
            rcfg.get_dataset = lambda **_: SyntheticDataset(params=fp, materialize_to=tmp)
            rproc = Processor(rcfg, device=dev)
            rproc.run_detection()
            res = rproc.dataset.results_path
            odir = os.path.join(tmp, "figs")
            nums = {"tpr_fpr_vs_flow": {k: v.tolist() for k, v in figures.tpr_fpr_vs_flow(
                        {"v1": res}, out_dir=odir).items()},
                    "foe_error_histograms": figures.foe_error_histograms(
                        {"run": res}, out_dir=odir),
                    "tpr_surface_3d_shape": list(figures.tpr_surface_3d(
                        {1.0: res, 3.0: res}, out_dir=odir)["tpr"].shape),
                    "published": figures.foe_error_published_comparison(
                        {"center": res}, out_dir=odir)}
            rad = figures.radial_error_histogram(SyntheticDataset(params=fp), n_frames=3,
                                                 out_path=os.path.join(odir, "r.png"))
            nums["radial_error_pairs"] = int(rad["mag"].size)
            figs_written = sorted(os.listdir(odir)) if os.path.isdir(odir) else []
    finally:
        builtins.__import__ = real_import
    if figs_written:
        raise AssertionError(f"tools: figures written without matplotlib: {figs_written}")
    out["figures"] = nums
    out["checks"] = checks.finish()
    if not top:
        raise AssertionError("tools: the trace holds no device time")
    return out


# ------------------------------------------------------------------- multi
# phase tools_flow: the frame sizes the flow tools run at, the phase's own
# cuts (the schedules: the control, the identity and the product; the AirSim
# loop over the 7 captures phase datasets renders, not the tool's 25, and
# without the debug images, which take ~6.7 s of every 1920x1024 batch on an
# H100 80GB HBM3 at 700 W, PERF.md §5: phase artifacts times them at 752x480)
TOOLS_FLOW_SIZES = {"bench": (480, 752), "hires": (1024, 1920)}
TOOLS_FLOW_SCHEDULES = "flat;6,6,6;2,3,8"
TOOLS_FLOW_SIM_FRAMES = 7
RESULTS_DIR = os.path.join("build", "chip_smoke")   # the phases' whole results
BENCH_EPE_GT_GATE_PX = 0.40      # bench.py:415 at 752x480
RAFT_BATCH_TOL_PX = RAFT_CARD_CPU_TOL_PX   # batch against loop / single pair


def _tool(mod, argv, dev, **kw):
    """``mod.main(argv, dev, **kw)`` with the tool's printing kept out of
    this script's output (its full text is in the result's ``"stdout"``),
    the fused kernel's counter zeroed just before: (result, launches, s)."""
    import contextlib
    import io

    from mav_detection_tpu_torch.ops.flow import farneback_iter as fi

    buf = io.StringIO()
    _sync(dev)
    fi.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = mod.main(argv, dev, **kw)
    _sync(dev)
    res["stdout"] = buf.getvalue()
    return res, fi.LAUNCHES["farneback_iterate_fused"], time.perf_counter() - t0


def phase_tools_flow(dev, sizes=TOOLS_FLOW_SIZES, sim_frames=TOOLS_FLOW_SIM_FRAMES,
                     lk_batches="1,8", raft_batches="1,2,4") -> dict:
    """Every flow tool of ``mav_detection_tpu_torch/tools`` through its
    ``main`` at the tool's frame size, the fused kernel's counter zeroed
    just before each, and each tool's own checks as gates: the stages of the
    flow compose to ``farneback_flow_batch``'s flow; the identity schedule
    equals the control; the product schedule within the cv2 (< 0.1 px) and
    GT (< 0.40 px) gates at 752x480; the product's hires point (levels 2,
    S 16) within the 0.55 px GT gate; the link canary's bytes equal to its
    numerator; RAFT's batch paths finite and within the card's bf16
    tolerance of the loop / single pair; LK's tracks and field finite; the
    spatial flow within 1e-3 px of the unsharded flow. The cv2 oracle of
    the sweeps is computed here (the package runs no cv2)."""
    import cv2

    from mav_detection_tpu_torch.tools import (
        hires_flow_sweep,
        hires_lk_probe,
        hires_pipeline_probe,
        hires_raft_probe,
        iter_schedule_sweep,
        pipeline_stage_probe,
        raft_stage_probe,
        spatial_probe,
    )
    from mav_detection_tpu_torch.tools.common import scene

    def oracle(h, w, hires):
        prev, curr, _ = scene(h, w, hires)
        return cv2.calcOpticalFlowFarneback(prev, curr, None, *CV2_ORACLE_ARGS)

    (h, w), (H, W) = sizes["bench"], sizes["hires"]
    runs = {
        "pipeline_stage_probe": (pipeline_stage_probe, [str(h), str(w)], {}),
        "iter_schedule_sweep": (iter_schedule_sweep, [
            "--schedules", TOOLS_FLOW_SCHEDULES, "--size", f"{h}x{w}"],
            {"oracle": oracle(h, w, False)}),
        "hires_flow_sweep": (hires_flow_sweep, ["--size", f"{H}x{W}"],
                             {"oracle": oracle(H, W, True)}),
        "hires_pipeline_probe": (hires_pipeline_probe, [
            "--size", f"{H}x{W}", "--frames", str(sim_frames), "--no-images"], {}),
        "raft_stage_probe": (raft_stage_probe, [str(h), str(w)], {}),
        "hires_raft_probe": (hires_raft_probe, [
            "--size", f"{H}x{W}", "--batches", raft_batches], {}),
        "hires_lk_probe": (hires_lk_probe, ["--size", f"{H}x{W}", "--batches", lk_batches],
                           {}),
        "spatial_probe": (spatial_probe, [str(H), str(W), "--meshes", ""], {}),
    }
    out, launches, secs = {}, {}, {}
    for tag, (mod, argv, kw) in runs.items():
        out[tag], launches[tag], secs[tag] = _tool(mod, argv, dev, **kw)

    def gate(ok, what):
        if not ok:
            raise AssertionError(f"[tools_flow] {what}")

    ps = out["pipeline_stage_probe"]
    gate(ps["composed_equal"], "pipeline_stage_probe: the stages do not compose to "
         "farneback_flow_batch's flow")
    sw = out["iter_schedule_sweep"]
    gate(sw["identity_equal"], "iter_schedule_sweep: (6, 6, 6) differs from the control")
    prod = [r for r in sw["rows"] if r["level_iters"] == [2, 3, 8]][0]
    gate(prod["epe_cv2"] < CV2_GATE_PX and prod["epe_gt"] < BENCH_EPE_GT_GATE_PX,
         f"iter_schedule_sweep: the product schedule's EPE {prod}")
    hs = out["hires_flow_sweep"]
    point = [p for p in hs["points"] if (p["levels"], p["max_shift"]) == (2, 16)][0]
    gate(point["gate_pass"], f"hires_flow_sweep: levels 2, S 16 outside the GT gate {point}")
    hp = out["hires_pipeline_probe"]
    gate(hp["frames"] == sim_frames - 1, f"hires_pipeline_probe: {hp['frames']} results")
    gate(hp["link"]["h2d_bytes"] == hp["link"]["numerator_bytes"],
         f"hires_pipeline_probe: canary {hp['link']}")
    rs = out["raft_stage_probe"]["batch_paths"]
    gate(rs["batch"]["finite"] and rs["loop"]["finite"]
         and rs["max_batch_vs_loop_px"] <= RAFT_BATCH_TOL_PX["bf16"],
         f"raft_stage_probe: batch paths {rs}")
    for row in out["hires_raft_probe"]["batches"]:
        gate("error" in row or (row["finite"] and row["max_vs_single_px"]
                                <= RAFT_BATCH_TOL_PX["bf16"]),
             f"hires_raft_probe: batch {row}")
    lk = out["hires_lk_probe"]
    gate(lk["tracks"] > 0 and np.isfinite([lk["track_epe_mean"], lk["dense_epe_gt"]]).all(),
         f"hires_lk_probe: {lk}")
    for row in out["spatial_probe"]["meshes"]:
        gate(row["within_tol"], f"spatial_probe: P={row['P']} {row['max_abs_err_px']} px")
    if dev.type == "cuda":
        for tag in ("pipeline_stage_probe", "iter_schedule_sweep", "hires_flow_sweep",
                    "hires_pipeline_probe"):
            gate(launches[tag] > 0, f"{tag}: the fused kernel never launched")
        gate(launches["spatial_probe"] == 0, "spatial_probe: the fused kernel launched")
    return {"results": out, "launches": launches, "seconds": secs}


def _keep(name: str, result: dict) -> None:
    """The whole of a phase's result as strict JSON under build/chip_smoke/
    (git-ignored; the standard output keeps the summary)."""
    from mav_detection_tpu_torch.tools.common import dumps

    os.makedirs(RESULTS_DIR, exist_ok=True)
    with open(os.path.join(RESULTS_DIR, name), "w") as f:
        f.write(dumps(result) + "\n")


def _tools_summary(tf: dict) -> dict:
    """The numbers of a tools phase without the tools' printed text."""
    return {"launches": tf["launches"], "seconds": tf["seconds"],
            **{tag: ({k: v for k, v in r.items() if k != "stdout"}
                     if isinstance(r, dict) else r)
               for tag, r in tf["results"].items()}}


def _say_tools_flow(tf: dict, smi: str, seconds: float) -> None:
    r, n = tf["results"], tf["launches"]
    for b in r["pipeline_stage_probe"]["batches"]:
        layers = ", ".join(f"{lv['layer']} {lv['shape']} {lv['ms']:.4f} (device "
                           f"{lv['device_ms']:.4f}, bound {lv['bound_ms']:.4f})"
                           for lv in b["layers"])
        say(f"[tools_flow] pipeline_stage_probe {r['pipeline_stage_probe']['W']}x"
            f"{r['pipeline_stage_probe']['H']} b={b['b']} on {smi}, ms per frame, events "
            f"(device): pipeline {b['pipeline_ms']:.4f} ({b['pipeline_device_ms']:.4f}); "
            f"iterate {b['iterate_ms']:.4f} ({b['iterate_device_ms']:.4f}: {layers}); "
            f"preproc matmuls {b['preproc_ms']:.4f} ({b['preproc_device_ms']:.4f}, bound "
            f"{b['preproc_bound_ms']:.4f} {b['preproc_bound_by']}); residual "
            f"{b['residual_ms']:.4f} ({b['residual_device_ms']:.4f})")
    for row in r["iter_schedule_sweep"]["rows"]:
        say(f"[tools_flow] iter_schedule_sweep {row['level_iters']}: "
            f"{json.dumps({k: row[k] for k in ('ms_per_frame', 'flow_ms_per_frame', 'flow_device_ms_per_frame', 'fps', 'epe_gt', 'epe_cv2', 'launches_per_pair')})}")
    for p in r["hires_flow_sweep"]["points"]:
        say(f"[tools_flow] hires_flow_sweep {json.dumps(p)}")
    hp = r["hires_pipeline_probe"]
    say(f"[tools_flow] hires_pipeline_probe {hp['size']} {hp['frames']} pairs b={hp['batch']} "
        f"on {smi}: {hp['wall_fps']:.2f} frames/s, host staging {hp['host_stage_s']:.2f} s of "
        f"{hp['wall_s']:.2f} s, overlap {hp['overlap_proven']}, stages ms per call "
        f"{json.dumps(hp['stages_ms_per_call'])}; link {json.dumps(hp['link'])}")
    rs = r["raft_stage_probe"]
    for tag, t in rs["stages"].items():
        say(f"[tools_flow] raft_stage_probe {rs['size']} {tag}: {json.dumps(t)}")
    say(f"[tools_flow] raft_stage_probe slope {rs['slope_ms_per_iter']:.4f} ms/iter "
        f"(device {rs['slope_device_ms_per_iter']}); batch paths "
        f"{json.dumps(rs['batch_paths'])}")
    hr = r["hires_raft_probe"]
    say(f"[tools_flow] hires_raft_probe {hr['size']} EPE vs GT {hr['epe_gt']:.4f} px: "
        f"{json.dumps(hr['batches'])}; first batch not fitting {hr['first_batch_not_fitting']}")
    lk = r["hires_lk_probe"]
    say(f"[tools_flow] hires_lk_probe {lk['size']}: {lk['tracks']} tracks, EPE mean "
        f"{lk['track_epe_mean']:.4f} / p90 {lk['track_epe_p90']:.4f} px, dense "
        f"{lk['dense_epe_gt']:.4f} px; {json.dumps(lk['batches'])}")
    sp = r["spatial_probe"]
    say(f"[tools_flow] spatial_probe {sp['size']} on {smi}: unsharded "
        f"{sp['unsharded_ms']:.2f} ms; {json.dumps(sp['meshes'])}")
    say(f"[tools_flow] farneback_iterate_fused launches {json.dumps(n)}; seconds "
        f"{json.dumps({k: round(v, 2) for k, v in tf['seconds'].items()})} ({seconds:.1f} s)")



# phase tools_eval: the rails of the JAX package's own tests
# (tests/test_cross_domain.py, tests/test_hires.py), as (bound, "max" or
# "min") per key
CROSS_DOMAIN_RAILS = {
    "bench": {"fb_epe": (0.25, "max"), "lk_epe": (0.35, "max"), "raft_epe": (0.4, "max"),
              "raft_drone_epe": (2.0, "max"), "sky_tpr": (0.9, "min"),
              "sky_fpr": (0.05, "max"), "yolo_iou": (0.4, "min")},
    "sim": {"fb_epe": (0.6, "max"), "raft_epe": (1.2, "max"), "raft_drone_epe": (2.0, "max"),
            "sky_tpr": (0.9, "min"), "sky_fpr": (0.05, "max"), "yolo_iou": (0.4, "min")},
}
HIRES_RAILS = {"half_sky_tpr": 0.95, "half_sky_fpr": 0.05, "yolo_iou": 0.3}
# card against CPU, per number: Farneback's auto warp 1e-3 px (phase
# solvers' farneback_flow bound) and the fused kernel's flow 1e-3 px (phase
# accuracy); LK dense 2e-2 px (phase modules); RAFT's product bf16 0.05 px
# (this phase's own readings on the H100: at most 0.0086 px over the bench
# drone, the mock captures and the four families, against EPEs of
# 0.2-6 px); the sky rates 0.015 (99.5 % mask agreement over classes of a
# third of the frame or more); TinyYOLO's IoU 0.05 (phase yolo); the FoE
# statistics on GT flow 0.05 px (the FoE vote at fp32,
# tests/test_torch_airsim.py)
TOOLS_EVAL_CARD_CPU_TOL = {"fb_epe": 1e-3, "lk_epe": 2e-2, "raft_epe": 0.05,
                           "raft_drone_epe": 0.05, "sky_tpr": 0.015, "sky_fpr": 0.015,
                           "yolo_iou": 0.05, "farneback_epe": 1e-3, "foe_px": 0.05}
# foe_reference_scale's cut (tests/test_torch_eval_tools.py's): 70 frames,
# the mock flight's length, so the validator's frames >= 56 rule keeps 13
# of the 69 flows, at 160x120, where the FoE statistics on GT flow are
# 2.4-5 px (at 128x96 and below, or at 480x256, some are under 0.03 px and
# a card-vs-CPU bound of 0.05 px could not tell a wrong result). Card and
# CPU take the same FoE draws, from numpy's generator at seed 1. The full
# run (90 frames at 1920x1024) is made by hand; PERF.md.
TOOLS_EVAL_FOE_CUT = {"frames": 70, "hw": (120, 160), "batch": 2, "samples": 1000,
                      "seed": 1}
TOOLS_EVAL_TRAIN = {"steps": 20, "chunk": 10, "curriculum_steps": 2}
# soup_raft's --ladder-gate in the phase: after 2 steps a phase no soup
# comes near the tool's 0.5 px, so the gate is opened here (and only here)
# to drive the ship path into the temporary copy; every other gate is the
# tool's own. The short curriculum's phase 3 reads eval EPE 0.59 against
# the gate's 0.5 (the shipped weights 0.496; alpha 0.5 0.539 on an H100),
# so the small alphas are the soups that can pass and ship.
SOUP_LOOSE_LADDER_GATE = 100.0
SOUP_ALPHAS = (0.0, 0.01, 0.03, 0.5, 1.0)


def phase_tools_eval(dev, hires=(1024, 1920), foe_cut=TOOLS_EVAL_FOE_CUT,
                     train=TOOLS_EVAL_TRAIN, cd_hw=(240, 320), cd_seeds=3) -> dict:
    """The evaluation and RAFT-retraining tools of ``tools/``, ported
    (``mav_detection_tpu_torch/tools``), each through its ``main`` with the
    fused kernel's counter zeroed just before: cross_domain_eval at its
    defaults against the JAX package's rails and card against CPU on one
    seed; raft_advantage_probe at 240x320 card against CPU (the fused
    kernel must launch); hires_eval at 1920x1024 against tests/test_hires.py's
    rails; foe_reference_scale at its cut, card against CPU on the same
    draws; finetune_raft (20 steps) into a temporary MAV_CHECKPOINT_PATH,
    its shipped baseline against the JAX package's evals, the candidate read
    back; pan_curriculum with 2 steps per phase (three sentinels), then
    again (every phase skipped); soup_raft between the shipped weights and
    the curriculum's phase 3 at ``SOUP_ALPHAS`` (alpha 0's and 1's evals
    equal their weights', 0.5's neither), then with ``--ship`` at the best
    passing alpha above 0: the temporary copy's RAFT file becomes that soup,
    its weights move, and nothing else there changes. checkpoints/ must be
    byte-unchanged."""
    import shutil

    import torch

    from mav_detection_tpu_torch.data.scene import make_scene
    from mav_detection_tpu_torch.models import checkpoint, pretrained
    from mav_detection_tpu_torch.models.raft import raft_flow
    from mav_detection_tpu_torch.tools import (
        cross_domain_eval,
        finetune_raft,
        foe_reference_scale,
        hires_eval,
        pan_curriculum,
        raft_advantage_probe,
        soup_raft,
    )

    here = os.path.dirname(os.path.abspath(__file__))
    if os.environ.get("MAV_CHECKPOINT_PATH"):
        raise AssertionError("tools_eval: MAV_CHECKPOINT_PATH is set; the shipped "
                             "checkpoints must be read")
    REF = _train_reference_numbers()
    ckpt_dir = os.path.join(here, "checkpoints")
    sha_before = _sha256_dir(ckpt_dir)
    checks = Checks("tools_eval")
    cpu = torch.device("cpu")
    out, launches, secs = {}, {}, {}

    def run(tag, mod, argv, **kw):
        out[tag], launches[tag], secs[tag] = _tool(mod, argv, dev, **kw)
        return out[tag]

    def rails(tag, got, table):
        for k, (bound, kind) in table.items():
            v = got[k]
            if v is None:
                raise AssertionError(f"[tools_eval] {tag} {k}: not taken")
            checks.add(f"{tag} {k}", v, bound, f"{kind} rail", at_least=kind == "min")

    def card_cpu(tag, card, host):
        for k, v in host.items():
            if v is None or card[k] is None:
                if (v is None) != (card[k] is None):
                    raise AssertionError(f"[tools_eval] {tag} {k}: card {card[k]}, CPU {v}")
                continue
            checks.add(f"{tag} {k} card vs CPU", abs(card[k] - v),
                       TOOLS_EVAL_CARD_CPU_TOL[k], f"|card {card[k]:.5f} - CPU {v:.5f}|")

    # ---- cross_domain_eval at its defaults, then card against CPU
    h, w = cd_hw
    cd = run("cross_domain_eval", cross_domain_eval,
             ["--hw", f"{h}x{w}", "--seeds", str(cd_seeds)])
    rails("cross_domain bench", cd["bench"], CROSS_DOMAIN_RAILS["bench"])
    rails("cross_domain sim", cd["sim"], CROSS_DOMAIN_RAILS["sim"])
    t0 = time.perf_counter()
    one = {"card": cross_domain_eval.bench_scene_metrics(h, w, [1], device=dev),
           "cpu": cross_domain_eval.bench_scene_metrics(h, w, [1], device=cpu),
           "sim_cpu": cross_domain_eval.mock_sim_metrics(device=cpu)}
    secs["cross_domain card vs cpu"] = time.perf_counter() - t0
    card_cpu("cross_domain bench seed 1", one["card"], one["cpu"])
    card_cpu("cross_domain sim", cd["sim"], one["sim_cpu"])
    out["cross_domain_card_vs_cpu"] = one

    # ---- raft_advantage_probe: the fused kernel's path
    ra = run("raft_advantage_probe", raft_advantage_probe, ["--size", f"{h}x{w}"])
    if dev.type == "cuda" and launches["raft_advantage_probe"] <= 0:
        raise AssertionError("[tools_eval] raft_advantage_probe: the fused kernel never "
                             "launched")
    t0 = time.perf_counter()
    ra_cpu = raft_advantage_probe.main(["--size", f"{h}x{w}"], cpu)
    secs["raft_advantage card vs cpu"] = time.perf_counter() - t0
    for row, host in zip(ra["rows"], ra_cpu["rows"]):
        card_cpu(f"raft_advantage {row['family']}",
                 {"farneback_epe": row["farneback_epe"], "raft_epe": row["raft_epe"]},
                 {"farneback_epe": host["farneback_epe"], "raft_epe": host["raft_epe"]})
    out["raft_advantage_cpu"] = ra_cpu

    # ---- hires_eval at the reference resolution
    H, W = hires
    he = run("hires_eval", hires_eval, ["--size", f"{H}x{W}"])
    half = he["sky"][1]
    checks.add("hires half-res sky TPR", half["tpr"], HIRES_RAILS["half_sky_tpr"],
               f"{half['size']} rail", at_least=True)
    checks.add("hires half-res sky FPR", half["fpr"], HIRES_RAILS["half_sky_fpr"],
               f"{half['size']} rail")
    checks.add("hires yolo IoU", he["yolo"]["iou"], HIRES_RAILS["yolo_iou"],
               f"{he['yolo']['size']} rail", at_least=True)

    # ---- foe_reference_scale at its cut, card against CPU on the same draws
    fh, fw = foe_cut["hw"]
    fn, fb, fs = foe_cut["frames"], foe_cut["batch"], foe_cut["samples"]
    draws_rng = np.random.default_rng(foe_cut["seed"])
    draws = [np.stack([draws_rng.integers(0, fh, (fb, 2 * fs)),
                       draws_rng.integers(0, fw, (fb, 2 * fs))], -1)
             for _ in range(0, fn - 1, fb)]
    foe_argv = ["--frames", str(fn), "--hw", f"{fh}x{fw}", "--batch", str(fb),
                "--foe-samples", str(fs)]
    fr = run("foe_reference_scale", foe_reference_scale, foe_argv, sample_yx=draws)
    t0 = time.perf_counter()
    fr_cpu = foe_reference_scale.main(foe_argv, cpu, sample_yx=draws)
    secs["foe card vs cpu"] = time.perf_counter() - t0
    out["foe_reference_scale_cpu"] = fr_cpu
    for r in (fr, fr_cpu):
        if r["frames"] != fn or r["scoring_frames"] != fn - 1 - 56:
            raise AssertionError(f"[tools_eval] foe_reference_scale on {r['device']}: "
                                 f"{r['frames']} frames, {r['scoring_frames']} scoring")
        if r["ours_mean"] is None or not np.isfinite(r["ours_mean"] + r["ours_std"]).all():
            raise AssertionError(f"[tools_eval] foe_reference_scale on {r['device']}: "
                                 f"stats {r}")
    for k in ("ours_mean", "ours_std"):
        for i, axis in enumerate("xy"):
            checks.add(f"foe {k[5:]} {axis} card vs CPU", abs(fr[k][i] - fr_cpu[k][i]),
                       TOOLS_EVAL_CARD_CPU_TOL["foe_px"],
                       f"|card {fr[k][i]:.5f} - CPU {fr_cpu[k][i]:.5f}| px")

    # ---- retraining, into a temporary copy of checkpoints/
    work = os.path.join(here, RESULTS_DIR, "tools_eval")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with tempfile.TemporaryDirectory(prefix="mav_tools_eval_ck_") as ck:
        for p in glob.glob(os.path.join(ckpt_dir, "*.msgpack")):
            shutil.copy(p, ck)
        os.environ["MAV_CHECKPOINT_PATH"] = ck
        pretrained.clear_cache()
        try:
            cand = os.path.join(work, "raft_candidate.msgpack")
            ft = run("finetune_raft", finetune_raft,
                     ["--steps", str(train["steps"]), "--chunk", str(train["chunk"]),
                      "--candidate", cand])
            base = ft["baseline"]
            for key, i, name in (("eval_raft", 0, "eval_epe"), ("eval_raft", 1, "drone_epe")):
                checks.add(f"finetune baseline {name}", abs(base[name] - REF[key][i]),
                           TRAIN_EVAL_TOL[key][i], f"|card {base[name]:.5f} - JAX|")
            checks.add("finetune baseline shift_ladder",
                       abs(base["shift_ladder"] - REF["shift_ladder_epe"]),
                       TRAIN_EVAL_TOL["shift_ladder_epe"], f"|card {base['shift_ladder']:.5f} - JAX|")
            model = finetune_raft.model_from_tree(checkpoint.load_msgpack(cand), dev)
            prev8, curr8, _ = make_scene(1, h=64, w=96)
            flow = raft_flow(model, prev8[None], curr8[None])
            if not bool(torch.isfinite(flow).all()):
                raise AssertionError("[tools_eval] the candidate read back gives non-finite flow")
            cur = os.path.join(work, "curriculum")
            pc = run("pan_curriculum", pan_curriculum,
                     ["--dir", cur, "--steps", str(train["curriculum_steps"])])
            done = sorted(os.path.basename(p) for p in glob.glob(os.path.join(cur, "*.done")))
            if done != ["phase1.done", "phase2.done", "phase3.done"] or \
                    any(p["skipped"] for p in pc["phases"]):
                raise AssertionError(f"[tools_eval] pan_curriculum sentinels {done}")
            again = run("pan_curriculum again", pan_curriculum,
                        ["--dir", cur, "--steps", str(train["curriculum_steps"])])
            if not all(p["skipped"] for p in again["phases"]):
                raise AssertionError("[tools_eval] pan_curriculum ran a finished phase again")
            # the soups run between the weights in the temporary copy and the
            # curriculum's phase 3, which the short curriculum moved away
            # from them (the fine-tune's candidate may be the shipped weights
            # themselves, when no chunk beat the holdout)
            p3 = os.path.join(cur, "phase3.msgpack")
            shipped_path = pretrained.checkpoint_path("raft")
            ends = [soup_raft.read_tree(shipped_path), soup_raft.read_tree(p3)]
            sp = run("soup_raft", soup_raft,
                     ["--candidate", p3, "--alphas", *(f"{a:g}" for a in SOUP_ALPHAS),
                      "--ladder-gate", str(SOUP_LOOSE_LADDER_GATE),
                      "--out", os.path.join(work, "raft_soup.msgpack")])
            rows = {row["alpha"]: row for row in sp["alphas"]}
            a0, ah, a1 = (rows[a]["evals"] for a in (0.0, 0.5, 1.0))
            for k, v in sp["baseline"].items():
                checks.add(f"soup alpha 0 {k}", abs(a0[k] - v), 0.0, "|soup - shipped|")
            for k, v in pc["phases"][2]["evals"].items():
                checks.add(f"soup alpha 1 {k}", abs(a1[k] - v), 0.0, "|soup - phase 3|")
            keys = sorted(sp["baseline"])
            if all(a0[k] == a1[k] for k in keys):
                raise AssertionError("[tools_eval] the curriculum's phase 3 evaluates as the "
                                     "shipped weights: the soup's endpoints cannot be told "
                                     "apart")
            if all(ah[k] == a0[k] for k in keys) or all(ah[k] == a1[k] for k in keys):
                raise AssertionError(f"[tools_eval] soup alpha 0.5 evaluates as an endpoint: "
                                     f"{ah}")
            # ship the best passing alpha above 0, by the tool's own rule
            passing = [row for row in sp["alphas"] if row["all_pass"] and row["alpha"] > 0]
            if not passing:
                raise AssertionError("[tools_eval] no soup above alpha 0 passes the gates: "
                                     + json.dumps({a: r["gates"] for a, r in rows.items()}))
            alpha = min(passing, key=lambda row: max(
                row["evals"][k] for k in ("drone_epe", "bench_drone_epe", "sim_drone_epe"))
            )["alpha"]
            before = _sha256_dir(ck)
            ss = run("soup_raft ship", soup_raft,
                     ["--candidate", p3, "--alphas", f"{alpha:g}",
                      "--ladder-gate", str(SOUP_LOOSE_LADDER_GATE), "--ship",
                      "--out", os.path.join(work, "raft_soup_shipped.msgpack")])
            if ss["best_alpha"] != alpha or ss["shipped_to"] != shipped_path:
                raise AssertionError(f"[tools_eval] soup ship: alpha {ss['best_alpha']}, "
                                     f"shipped to {ss['shipped_to']}")
            after = _sha256_dir(ck)
            changed = sorted(k for k in after if after[k] != before.get(k))
            with open(shipped_path, "rb") as f, open(ss["soup_path"], "rb") as g:
                copied = f.read() == g.read()
            if not copied or set(changed) - {os.path.basename(shipped_path)}:
                raise AssertionError(f"[tools_eval] soup ship: {changed} changed in the "
                                     f"temporary copy")
            got = dict(_flat_tree(soup_raft.read_tree(shipped_path)))
            want = dict(_flat_tree(soup_raft.soup_tree(*ends, alpha)))
            was = dict(_flat_tree(ends[0]))
            if sorted(got) != sorted(want) or any(
                    not np.array_equal(got[k], want[k]) for k in want):
                raise AssertionError("[tools_eval] the shipped file is not the soup")
            moved = sum(not np.array_equal(got[k], was[k]) for k in got)
            if moved == 0:
                raise AssertionError("[tools_eval] the shipped soup left every weight as it was")
            out["ship"] = {"alpha": alpha, "passing_alphas": [r["alpha"] for r in passing],
                           "shipped_to": ss["shipped_to"], "changed_in_copy": changed,
                           "leaves_changed": moved, "leaves": len(got),
                           "curriculum_shipped_to": pc["shipped_to"]}
        finally:
            os.environ.pop("MAV_CHECKPOINT_PATH", None)
            pretrained.clear_cache()
    if _sha256_dir(ckpt_dir) != sha_before:
        raise AssertionError("tools_eval: checkpoints/ changed during the phase")
    out["checkpoints_sha256_unchanged"] = len(sha_before)
    out["checks"] = checks.finish()
    return {"results": out, "launches": launches, "seconds": secs}


def _say_tools_eval(te: dict, smi: str, seconds: float) -> None:
    r, n = te["results"], te["launches"]
    cd = r["cross_domain_eval"]
    say(f"[tools_eval] cross_domain_eval {cd['hw']} {cd['seeds']} seeds on {smi}: bench "
        f"{json.dumps(cd['bench'])}; mock sim {json.dumps(cd['sim'])}")
    ra = r["raft_advantage_probe"]
    for row, host in zip(ra["rows"], r["raft_advantage_cpu"]["rows"]):
        say(f"[tools_eval] raft_advantage_probe {ra['size']} {row['family']}: Farneback "
            f"{row['farneback_epe']:.5f} px (CPU {host['farneback_epe']:.5f}), RAFT "
            f"{row['raft_epe']:.5f} px (CPU {host['raft_epe']:.5f}), RAFT wins "
            f"{row['raft_wins']}")
    say(f"[tools_eval] raft_advantage_probe verdict: {ra['verdict']}")
    he = r["hires_eval"]
    for row in he["sky"] + [he["yolo"]]:
        say(f"[tools_eval] hires_eval {he['size']} on {smi}: {json.dumps(row)}")
    fr, fc = r["foe_reference_scale"], r["foe_reference_scale_cpu"]
    say(f"[tools_eval] foe_reference_scale {fr['resolution']} {fr['frames']} frames on {smi}: "
        f"mean {fr['ours_mean']} px, std {fr['ours_std']} px over {fr['scoring_frames']} "
        f"scoring frames ({fr['outliers']} outliers); collect {fr['collect_s']:.1f} s, "
        f"detect {fr['detect_s']:.1f} s; CPU on the same draws mean {fc['ours_mean']} px, "
        f"std {fc['ours_std']} px")
    ft = r["finetune_raft"]
    say(f"[tools_eval] finetune_raft {ft['steps']} steps (chunk {ft['chunk']}) on {smi}: "
        f"{ft['ms_per_step_with_selection']:.2f} ms per step with selection, train "
        f"{ft['train_s']:.2f} s, loss {ft['first_loss']:.4f} -> {ft['last_loss']:.4f}; "
        f"baseline {json.dumps(ft['baseline'])}; candidate {json.dumps(ft['candidate'])}; "
        f"gates {json.dumps(ft['gates'])}")
    for p in r["pan_curriculum"]["phases"]:
        say(f"[tools_eval] pan_curriculum {p['phase']} ({p['steps']} steps): "
            f"{p['seconds']:.1f} s, gates pass {p['all_pass']}, shipped {p['shipped_to']}")
    say(f"[tools_eval] soup_raft between the shipped weights and {r['soup_raft']['candidate']}")
    for row in r["soup_raft"]["alphas"]:
        say(f"[tools_eval] soup_raft alpha {row['alpha']}: {json.dumps(row['evals'])}, all "
            f"gates {row['all_pass']}")
    say(f"[tools_eval] shipping {json.dumps(r['ship'])}; checkpoints/ unchanged "
        f"({r['checkpoints_sha256_unchanged']} files, sha256); {r['checks']} checks")
    say(f"[tools_eval] farneback_iterate_fused launches {json.dumps(n)}; seconds "
        f"{json.dumps({k: round(v, 2) for k, v in te['seconds'].items()})} ({seconds:.1f} s)")


MULTI_SIZES = {
    "loop": (480, 752, 12, 8),          # h, w, frames, batch
    "spatial": (1024, 1920),
    "chunked": (480, 752, 12),          # h, w, frames
    "train": (128, 160, 8, 5),          # h, w, batch, steps in the chunk
}
MULTI_FOE_TOL_PX = 1e-3          # data parallel / chunked against one card
MULTI_RATE_TOL = 1e-5
SPATIAL_TOL_PX = 1e-3            # the reference's gate against unsharded
TRAIN_DP_RTOL, TRAIN_DP_ATOL = 2e-2, 1e-3   # the reference's data-parallel gate
# The chunk's warmup runs step 0 at rate 0, so 5 steps move a weight by about
# 6e-4 in all, below TRAIN_DP_ATOL. So the parameter change (final minus
# initial) is held too, as the norm of its difference from the one-card
# change over that change's norm, and the losses from step 2 on (the first
# taken after a real update) within a relative limit. The limits are set from
# sound runs on the card and a planted control run in every call: one card
# trained on the first half of each step's draws, what rank 0 of two trains
# on when the gradients are not all-reduced, which must fail the change gate.
TRAIN_DP_CHANGE_TOL = 0.1
TRAIN_DP_LOSS_RTOL = 3e-3


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _multi_processor(dev, ds, mesh=None, **cfg_kw):
    """A Processor over the synthetic sequence ``ds``, throughput run (JSON
    only, into no directory), as ``mesh``'s rank when given."""
    import logging

    from mav_detection_tpu_torch.core.config import RunConfig
    from mav_detection_tpu_torch.pipeline.processor import Processor

    cfg = RunConfig(logger=logging.getLogger("chip_smoke.multi"), dataset="synthetic",
                    flow_source="FARNEBACK", headless=True, **cfg_kw)
    proc = Processor(cfg, device=dev, mesh=mesh, dataset=ds)
    proc.save_images = False
    return proc


def _run(fn, dev):
    """(what ``fn`` returns, host-clock s, launches of the iterate and of
    the band kernel) of one synchronised call, the launch counters zeroed
    just before it."""
    _sync(dev)
    _reset_launches()
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0, _launches()


def _turns(mesh, one, sharded) -> dict:
    """One card against the sharded path in one process, in turns: each
    warmed up once, then one card, sharded, sharded, one card (rank 0 alone
    runs the one-card calls; the other ranks wait at the next collective).
    The last sharded call's result and launches, each path's mean seconds,
    and (rank 0) the one-card result, and that of its first timed call."""
    dev, lead = mesh.device, mesh.rank == 0
    if lead:
        one()
    sharded()
    runs = {"one": [], "sharded": []}
    for tag in ("one", "sharded", "sharded", "one"):
        if tag == "sharded" or lead:
            runs[tag].append(_run(one if tag == "one" else sharded, dev))
    got, _, launches = runs["sharded"][-1]
    out = {"result": got, "s": float(np.mean([r[1] for r in runs["sharded"]])),
           "launches": launches}
    if lead:
        out.update(one_result=runs["one"][-1][0], one_launches=runs["one"][-1][2],
                   one_s=float(np.mean([r[1] for r in runs["one"]])),
                   one_first_result=runs["one"][0][0])
    return out


def _frame_dicts(proc):
    """A fresh run of ``proc``'s FoE loop: FrameResults as dicts, and the
    batches' all-reduced rates."""
    proc.detection_results, proc._psum_metrics = {}, []
    results = proc.run_detection_foe()
    return {i: fr.to_dict() for i, fr in results.items()}, list(proc._psum_metrics)


def _multi_train_kw(dev, sizes):
    h, w, batch, steps = sizes["train"]
    return dict(steps=steps, batch=batch, hw=(h, w), chunk=steps, seed=0,
                use_selector=False, device=dev)


def _half_batch_kw(dev, kw) -> dict:
    """The planted control of the data-parallel training gate: ``kw``'s run
    on the first half of each step's draws of the whole batch, the update
    rank 0 of two makes when the gradients are not all-reduced."""
    from mav_detection_tpu_torch.cli.train import _draws_fn
    from mav_detection_tpu_torch.data.synthgen import SceneDraws

    h, w = kw["hw"]
    half = kw["batch"] // 2
    full = _draws_fn(None, kw["batch"], h, w, 0.0, kw["seed"], dev)
    return dict(kw, batch=half,
                draws=lambda step: SceneDraws(*(t[:half] for t in full(step))))


def _change_err(got, ref, init) -> float:
    """|(got - init) - (ref - init)| / |ref - init| over every parameter."""
    num = den = 0.0
    for k, v in init.items():
        want = ref[k].double() - v.double()
        num += float(((got[k].double() - v.double()) - want).square().sum())
        den += float(want.square().sum())
    return (num / den) ** 0.5


def _nccl_times(mesh, sizes) -> dict:
    """Host-clock ms per collective (20 after 3 warm-up, synchronised): the
    all-reduce of the 4 metric counts, of the RAFT gradient (the product
    ``RAFTConfig``'s parameters, fp32) and one halo hop of spatial
    Farneback's refit at its finest level (``max_shift + winsize // 2 + 2``
    flow rows each way)."""
    import torch

    from mav_detection_tpu_torch.models.raft import RAFT
    from mav_detection_tpu_torch.ops.flow.farneback import tuned_flow_params
    from mav_detection_tpu_torch.parallel.halo import exchange_rows
    from mav_detection_tpu_torch.parallel.mesh import all_reduce_sum_

    dev = mesh.device
    with torch.device("meta"):
        n_grad = sum(p.numel() for p in RAFT().parameters())
    sh, sw = sizes["spatial"]
    params = tuned_flow_params(sh, sw)
    fh_r = params.max_shift + params.winsize // 2 + 2
    band = torch.zeros((1, 2, sh // mesh.size, sw), device=dev)
    small, grad = torch.zeros(4, device=dev), torch.zeros(n_grad, device=dev)

    def ms(fn, reps=20):
        for _ in range(3):
            fn()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(dev)
        return (time.perf_counter() - t0) * 1e3 / reps

    return {"all_reduce_counts_ms": ms(lambda: all_reduce_sum_(small, mesh)),
            "all_reduce_grad_ms": ms(lambda: all_reduce_sum_(grad, mesh)),
            "grad_bytes": 4 * n_grad,
            "halo_hop_ms": ms(lambda: exchange_rows(band, fh_r, fh_r, mesh)),
            "halo_bytes_each_way": 4 * 2 * fh_r * sw}


def _multi_rank(mesh, sizes):
    """Phase ``multi`` as one rank of a process group: the data-parallel FoE
    loop, spatial Farneback, the chunked engine and a data-parallel RAFT
    training chunk, each through the entry point a user calls under a
    group, each in turns with its one-card counterpart in this process
    (``_turns``). Rank 0 returns what it measured."""
    from dataclasses import replace

    import torch

    from mav_detection_tpu_torch.cli.train import train_raft
    from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
    from mav_detection_tpu_torch.ops.flow.farneback import _farneback_cf, tuned_flow_params
    from mav_detection_tpu_torch.parallel.spatial import farneback_flow_spatial

    def sequence(h, w, n_frames):
        # read-only in every run: the processors of a size share it
        return SyntheticDataset(params=SyntheticParams(height=h, width=w,
                                                       n_frames=n_frames))

    dev, out = mesh.device, {}
    h, w, n_frames, batch = sizes["loop"]
    ds = sequence(h, w, n_frames)
    dp = _multi_processor(dev, ds, mesh, batch_size=batch, devices=mesh.size)
    # the batch a mesh runs (raised to its size where smaller): the same
    # batches draw the same FoE samples
    one = _multi_processor(dev, ds, batch_size=dp.batch_size)
    out["loop"] = _turns(mesh, lambda: _frame_dicts(one), lambda: _frame_dicts(dp))

    sh, sw = sizes["spatial"]
    prev, curr, _ = scene_batch(1, sh, sw, hires=True)
    params = tuned_flow_params(sh, sw)
    p_t, c_t = torch.from_numpy(prev).to(dev), torch.from_numpy(curr).to(dev)
    sep = replace(params, warp="separable")
    out["spatial"] = _turns(
        mesh, lambda: _farneback_cf(p_t, c_t, sep)[0].cpu(),
        lambda: farneback_flow_spatial(p_t[0], c_t[0], params, mesh).cpu())
    if mesh.rank == 0:
        _run(lambda: _farneback_cf(p_t, c_t, params), dev)          # warm-up
        _, fused_s, fused_launches = _run(lambda: _farneback_cf(p_t, c_t, params), dev)
        out["spatial"].update(fused_s=fused_s, fused_launches=fused_launches)

    if sizes["chunked"] != (h, w, n_frames):
        ds = sequence(*sizes["chunked"])
    scan = _multi_processor(dev, ds, engine="scan")
    chunked = _multi_processor(dev, ds, mesh, engine="chunked", devices=mesh.size)
    out["chunked"] = _turns(mesh, lambda: _frame_dicts(scan)[0],
                            lambda: _frame_dicts(chunked)[0])

    kw = _multi_train_kw(dev, sizes)

    def state(model_losses):
        model, losses = model_losses
        return {k: v.cpu() for k, v in model.state_dict().items()}, np.asarray(losses)

    out["train"] = _turns(mesh, lambda: state(train_raft(**kw)),
                          lambda: state(train_raft(**kw, devices=mesh.size, mesh=mesh)))
    if mesh.rank == 0:
        out["train"]["half_batch_result"] = state(train_raft(**_half_batch_kw(dev, kw)))
    out["nccl"] = _nccl_times(mesh, sizes)
    return out if mesh.rank == 0 else None


def _results_diff(tag, got, ref):
    """Largest FoE and rate differences of two runs' FrameResult dicts;
    raises where they do not cover the same pairs or miss the tolerances."""
    if sorted(got) != sorted(ref):
        raise AssertionError(f"[multi] {tag}: pairs {sorted(got)} against {sorted(ref)}")
    foe = rate = 0.0
    for i in ref:
        foe = max(foe, float(np.abs(np.subtract(got[i]["foe_dense"],
                                                ref[i]["foe_dense"])).max()))
        for k in RATES:
            a, b = got[i][k], ref[i][k]
            if np.isnan(a) != np.isnan(b):
                raise AssertionError(f"[multi] {tag} pair {i} {k}: {a} against {b}")
            if not np.isnan(a):
                rate = max(rate, abs(a - b))
    if foe > MULTI_FOE_TOL_PX or rate > MULTI_RATE_TOL:
        raise AssertionError(f"[multi] {tag}: FoE {foe} px (tol {MULTI_FOE_TOL_PX}), "
                             f"rates {rate} (tol {MULTI_RATE_TOL})")
    return foe, rate


def _expected_psum(results, batch: int, hw: int):
    """The batches' pooled fixed-threshold TPR / FPR from one-card
    FrameResults: tp = tpr * pos and fp = fpr * neg per frame, pos the
    target's pixels and neg the rest."""
    out = []
    n = len(results)
    for b0 in range(0, n, batch):
        frames = [results[i] for i in range(b0, min(b0 + batch, n))]
        pos = np.array([fr["drone_size_pixels"] for fr in frames], np.float64)
        tp = sum(fr["tpr_fixed"] * p for fr, p in zip(frames, pos) if p > 0)
        fp = sum(fr["fpr_fixed"] * (hw - p) for fr, p in zip(frames, pos))
        with np.errstate(invalid="ignore"):     # no target pixel: 0/0, as pooled
            out.append((tp / pos.sum(), fp / (hw - pos).sum(), len(frames)))
    return out


def phase_multi(dev, sizes=MULTI_SIZES, ranks: int = 1) -> dict:
    """The multi-device paths on ``ranks`` spawned ranks (world size 1 by
    default; NCCL on the cards, gloo on the CPU), each held to its one-card
    counterpart, which rank 0 runs in turns with it in the same process."""
    from mav_detection_tpu_torch.ops.flow import farneback as fb
    from mav_detection_tpu_torch.parallel.mesh import backend_for, launch

    t0 = time.perf_counter()
    got = launch(_multi_rank, ranks, dev, sizes, timeout_s=600.0)
    out = {"backend": backend_for(dev), "world_size": ranks,
           "rank_s": time.perf_counter() - t0, "nccl": got["nccl"]}

    h, w, n_frames, batch = sizes["loop"]
    batch = max(batch, ranks)
    loop = got["loop"]
    (results, psum), (one, _) = loop["result"], loop["one_result"]
    foe, rate = _results_diff("data parallel", results, one)
    want = _expected_psum(one, batch, h * w)
    pairs = [(a, b) for g, e in zip(psum, want) for a, b in zip(g, e)]
    psum_err = max((abs(a - b) for a, b in pairs if not np.isnan(b)), default=0.0)
    if (len(psum) != len(want) or psum_err > MULTI_RATE_TOL
            or any(np.isnan(a) != np.isnan(b) for a, b in pairs)):
        raise AssertionError(f"[multi] psum {psum} against {want}")
    out["data_parallel"] = {
        "size": f"{w}x{h}", "batch": batch, "pairs": n_frames - 1,
        "frames_per_s": (n_frames - 1) / loop["s"],
        "one_card_frames_per_s": (n_frames - 1) / loop["one_s"],
        "launches": loop["launches"], "one_card_launches": loop["one_launches"],
        "max_foe_diff_px": foe, "max_rate_diff": rate, "psum": psum,
        "max_psum_diff": psum_err}

    sh, sw = sizes["spatial"]
    sp = got["spatial"]
    err = float((sp["result"] - sp["one_result"]).abs().max())
    if err > SPATIAL_TOL_PX:
        raise AssertionError(f"[multi] spatial Farneback {err} px from unsharded")
    out["spatial"] = {"size": f"{sw}x{sh}", "max_abs_err_px": err,
                      "ms_per_pair": sp["s"] * 1e3,
                      "unsharded_separable_ms": sp["one_s"] * 1e3,
                      "batched_fused_b1_ms": sp["fused_s"] * 1e3,
                      "launches": sp["launches"], "fused_b1_launches": sp["fused_launches"]}

    ch, cw, c_frames = sizes["chunked"]
    chk = got["chunked"]
    foe, rate = _results_diff("chunked", chk["result"], chk["one_result"])
    out["chunked"] = {"size": f"{cw}x{ch}", "transitions": c_frames - 1,
                      "ms_per_transition": chk["s"] * 1e3 / (c_frames - 1),
                      "scan_ms_per_transition": chk["one_s"] * 1e3 / (c_frames - 1),
                      "launches": chk["launches"], "scan_launches": chk["one_launches"],
                      "max_foe_diff_px": foe, "max_rate_diff": rate}

    import torch

    from mav_detection_tpu_torch.models.raft import create_raft

    kw = _multi_train_kw(dev, sizes)
    tr = got["train"]
    (state, losses), (one_state, one_losses) = tr["result"], tr["one_result"]
    worst = 0.0
    for k, v in one_state.items():
        a, b = state[k].float().numpy(), v.float().numpy()
        worst = max(worst, float(np.abs(a - b).max()))
        if (np.abs(a - b) > TRAIN_DP_ATOL + TRAIN_DP_RTOL * np.abs(b)).any():
            raise AssertionError(f"[multi] data-parallel RAFT {k}: {np.abs(a - b).max()}")
    init = create_raft(torch.Generator().manual_seed(kw["seed"])).state_dict()
    change = _change_err(state, one_state, init)
    one_again = _change_err(tr["one_first_result"][0], one_state, init)
    control = _change_err(tr["half_batch_result"][0], one_state, init)
    loss_err = float(np.max(np.abs(losses[2:] - one_losses[2:]) / np.abs(one_losses[2:])))
    if change > TRAIN_DP_CHANGE_TOL or loss_err > TRAIN_DP_LOSS_RTOL:
        raise AssertionError(f"[multi] data-parallel RAFT: parameter change {change} from "
                             f"the one-card change (tol {TRAIN_DP_CHANGE_TOL}), losses "
                             f"{losses} against {one_losses} (rtol {TRAIN_DP_LOSS_RTOL})")
    if control <= TRAIN_DP_CHANGE_TOL:
        raise AssertionError(f"[multi] data-parallel RAFT: the half-batch control's change "
                             f"reads {control}, inside the gate {TRAIN_DP_CHANGE_TOL}")
    out["train"] = {"size": f"{kw['hw'][1]}x{kw['hw'][0]}", "batch": kw["batch"],
                    "steps": kw["steps"], "ms_per_step": tr["s"] * 1e3 / kw["steps"],
                    "one_card_ms_per_step": tr["one_s"] * 1e3 / kw["steps"],
                    "max_param_diff": worst, "change_err": change,
                    "one_card_again_change_err": one_again,
                    "half_batch_control_change_err": control, "loss_rel_err": loss_err,
                    "losses": [float(v) for v in losses],
                    "one_card_losses": [float(v) for v in one_losses]}
    if dev.type == "cuda":
        fused = "farneback_iterate_fused"
        for tag, (th, tw) in (("data_parallel", (h, w)), ("chunked", (ch, cw))):
            if out[tag]["launches"][fused] == 0:
                raise AssertionError(f"[multi] {tag}: the fused kernel never launched")
            _hold_expand(f"[multi] {tag}", out[tag]["launches"],
                         fb.tuned_flow_params(th, tw), th, tw)
        if out["spatial"]["launches"][fused]:
            raise AssertionError("[multi] spatial: the fused kernel launched")
    return out


def _strict_json(text: str) -> dict:
    def refuse(token):
        raise AssertionError(f"not strict JSON: {token}")
    return json.loads(text, parse_constant=refuse)


def phase_bench(dev) -> dict:
    """``python -m mav_detection_tpu_torch.bench`` (its ``main``) on the card
    at bench.py's sizes, with bench.py's cv2 oracle and baseline call given
    as ``cv2_flow``, the launch counters zeroed just before: one line
    of strict JSON with the keys bench.py's line has; the headline (752x480,
    b=8) and the 1920x1024 figure non-null, from a replayed CUDA graph; EPE
    vs cv2 < CV2_GATE_PX at 752x480 and vs GT < 0.55 px at 1920x1024 (the
    bench raises on either itself); both kernels launched."""
    import contextlib
    import io

    import cv2

    from mav_detection_tpu_torch import bench
    from mav_detection_tpu_torch.ops.flow import farneback_expand as fe

    def cv2_flow(prev8, curr8):
        return cv2.calcOpticalFlowFarneback(prev8, curr8, None, *CV2_ORACLE_ARGS)

    buf = io.StringIO()
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = bench.main([], device=dev, cv2_flow=cv2_flow)
    seconds = time.perf_counter() - t0
    counts = _launches()
    launches = counts["farneback_iterate_fused"]
    expand_launches = sum(counts[k] for k in fe.KERNELS)
    lines = buf.getvalue().strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench: {len(lines)} lines printed, expected one")
    line = _strict_json(lines[0])
    missing = {"metric", "value", "unit", "vs_baseline", "fps_batch8", "fps_single",
               "config", "canary_matmul_tflops", "kernel_ms_per_iter", "chip_health",
               "host", "hires", "eager", "device"} ^ set(line)
    if missing or line != _strict_json(json.dumps(res)):
        raise AssertionError(f"bench: keys {sorted(missing)} off bench.py's line")
    for tag, fps in (("headline", line["value"]), ("single", line["fps_single"]),
                     ("hires", (line["hires"] or {}).get("fps_batch8")),
                     ("vs_baseline", line["vs_baseline"])):
        if fps is None or not fps > 0:
            raise AssertionError(f"bench: {tag} {fps}")
    if line["config"]["timer"] != "cuda graph":
        raise AssertionError(f"bench: headline timed by {line['config']['timer']}")
    found = re.search(r"EPE vs cv2 ([0-9.]+)px", line["metric"])
    epe_cv2 = float(found.group(1)) if found else None
    if epe_cv2 is None or not epe_cv2 < CV2_GATE_PX:
        raise AssertionError(f"bench: EPE vs cv2 {epe_cv2} (gate {CV2_GATE_PX} px)")
    if not line["hires"]["epe_gt"] < bench.HIRES_GATE_PX:
        raise AssertionError(f"bench: hires EPE vs GT {line['hires']['epe_gt']}")
    if launches == 0 or expand_launches == 0:
        raise AssertionError(f"bench: launches {counts}")
    return {"line": lines[0], "result": line, "seconds": seconds, "launches": launches,
            "expand_launches": expand_launches, "epe_cv2_px": epe_cv2}


def main_multi(dev, ranks: int, smi: str) -> int:
    """``--multi N``: phase ``multi`` on N cards, then ``dryrun_multichip``
    on N cards."""
    import torch

    from mav_detection_tpu_torch.entry import dryrun_multichip

    from mav_detection_tpu_torch.tools import spatial_probe

    t0 = time.perf_counter()
    multi = phase_multi(dev, ranks=ranks)
    _say_multi(multi, smi, time.perf_counter() - t0)
    t0 = time.perf_counter()
    H, W = TOOLS_FLOW_SIZES["hires"]
    sp, launches, _ = _tool(spatial_probe, [str(H), str(W)], dev)
    meshes = [row["P"] for row in sp["meshes"]]
    bad = [row for row in sp["meshes"] if not row["within_tol"]]
    if bad or launches or meshes != [1] + [p for p in (2, 4, 8) if p <= ranks]:
        raise AssertionError(f"[multi] spatial_probe: meshes {meshes}, launches {launches}, "
                             f"beyond {spatial_probe.TOL_PX} px: {bad}")
    sp.pop("stdout")
    say(f"[multi] spatial_probe {sp['size']} on {smi}: unsharded {sp['unsharded_ms']:.2f} "
        f"ms; {json.dumps(sp['meshes'])} ({time.perf_counter() - t0:.1f} s)")
    _keep("spatial_probe.json", sp)
    lines = dryrun_multichip(ranks)
    if len(lines) != 6:
        raise AssertionError(f"dryrun_multichip({ranks}): {len(lines)} stages")
    say(json.dumps({"multi": {key: multi[key] for key in (
        "backend", "world_size", "nccl", "data_parallel", "spatial", "chunked",
        "train")}, "spatial_probe": sp}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _say_multi(multi: dict, smi: str, seconds: float) -> None:
    dp, sp, chk, trn = (multi[k] for k in ("data_parallel", "spatial", "chunked", "train"))
    say(f"[multi] world size {multi['world_size']}, {multi['backend']}, in spawned ranks "
        f"({multi['rank_s']:.1f} s with their start-up) on {smi}:")
    say(f"[multi] data-parallel FoE loop {dp['size']} b={dp['batch']}, {dp['pairs']} pairs: "
        f"{dp['frames_per_s']:.2f} frames/s (one card here {dp['one_card_frames_per_s']:.2f}), "
        f"FrameResults within {dp['max_foe_diff_px']:.3g} px / {dp['max_rate_diff']:.3g} of the "
        f"one-card loop's, psum TPR/FPR {json.dumps(dp['psum'])} within "
        f"{dp['max_psum_diff']:.3g} of the pooled one-card rates; fused launches on rank 0 "
        f"{json.dumps(dp['launches'])} (one card {json.dumps(dp['one_card_launches'])}); one "
        f"card and sharded in turns in the rank's process")
    say(f"[multi] spatial Farneback {sp['size']}: {sp['ms_per_pair']:.2f} ms per pair (host "
        f"clock), unsharded separable {sp['unsharded_separable_ms']:.2f} ms, batched fused b=1 "
        f"{sp['batched_fused_b1_ms']:.2f} ms; max |flow - unsharded| {sp['max_abs_err_px']:.3g} "
        f"px (tol {SPATIAL_TOL_PX}); fused launches {json.dumps(sp['launches'])} (batched "
        f"fused {json.dumps(sp['fused_b1_launches'])})")
    say(f"[multi] chunked engine {chk['size']}, {chk['transitions']} transitions: "
        f"{chk['ms_per_transition']:.3f} ms per transition (scan engine here "
        f"{chk['scan_ms_per_transition']:.3f}), within {chk['max_foe_diff_px']:.3g} px / "
        f"{chk['max_rate_diff']:.3g} of the scan engine's; fused launches on rank 0 "
        f"{json.dumps(chk['launches'])} (scan {json.dumps(chk['scan_launches'])})")
    say(f"[multi] data-parallel RAFT chunk {trn['size']} b={trn['batch']}, {trn['steps']} "
        f"steps: {trn['ms_per_step']:.2f} ms per step (one card here "
        f"{trn['one_card_ms_per_step']:.2f}), parameters within {trn['max_param_diff']:.3g} "
        f"(gate rtol {TRAIN_DP_RTOL}, atol {TRAIN_DP_ATOL}); parameter change "
        f"{trn['change_err']:.4g} from the one card's (gate {TRAIN_DP_CHANGE_TOL}; one card "
        f"run again {trn['one_card_again_change_err']:.4g}, half-batch control "
        f"{trn['half_batch_control_change_err']:.4g}), losses from step 2 within "
        f"{trn['loss_rel_err']:.3g} (gate {TRAIN_DP_LOSS_RTOL}): {json.dumps(trn['losses'])} "
        f"against {json.dumps(trn['one_card_losses'])}")
    say(f"[multi] NCCL, host clock per collective: {json.dumps(multi['nccl'])} "
        f"({seconds:.1f} s)")


def _probe_rows(pr: dict) -> list:
    """The kernels JSON rows of the probe kernels: the finest layer's
    numbers (shift axis 0; the y stage's 160 bands with sy per cell), the
    other sizes' beside."""
    from mav_detection_tpu_torch.ops.flow import shift_probes as sp

    runs = pr["runs"]
    rows = []
    for k in sp.KERNELS:
        if k.startswith("y_stage_"):
            v = k[len("y_stage_"):]
            cf, ct = runs["chain_fine"], runs["chain_tile"]
            fine = cf["variants"][v]
            shape = f"bands={cf['bands']} th={cf['th']} tw={cf['tw']} m={cf['m']} S={cf['S']}"
            extra = {"ms_tool_default": runs["chain_default"]["variants"][v]["us"] / 1e3,
                     "share_of_fused_launch": pr["shares"]["fused"].get(f"{v} chain_fine"),
                     "share_of_tiled_launch": pr["shares"].get("tiled", {}).get(
                         f"{v} chain_fine"),
                     "ms_sy_in_runs_of_32": runs["chain_fine_runs"]["variants"][v]["us"] / 1e3,
                     "ms_tile_geometry": ct["variants"][v]["us"] / 1e3,
                     "bound_ms_tile_geometry": ct["variants"][v]["bound_us"] / 1e3,
                     "tile_geometry": f"bands={ct['bands']} th={ct['th']} tw={ct['tw']} "
                                      f"sy-run {ct['sy_run']}",
                     "bytes": cf["bytes"], "fused_y_bytes": cf["fused_y_bytes"],
                     "library_note": "no one PyTorch call: five planes and their sum"}
            lib = None
        else:
            gf = runs["gather_fine"]
            fine = gf["axes"][0][k]
            shape = f"{gf['rows']}x{gf['cols']} S={gf['S']} axis 0"
            extra = {"ms_tool_default": runs["gather_default"]["axes"][0][k]["us"] / 1e3,
                     "ms_axis1": gf["axes"][1][k]["us"] / 1e3,
                     "bound_ms_axis1": gf["axes"][1][k]["bound_us"] / 1e3,
                     "plain_ms_axis1": gf["axes"][1][k]["plain_ms"],
                     "library_ms_axis1": pr["library_ms"][1],
                     "library": "torch.nn.functional.grid_sample (bilinear)",
                     "library_max_abs_diff": pr["library_max_abs_diff"],
                     "exact_vs_chain": all(a["exact_vs_chain"] for a in gf["axes"])}
            lib = pr["library_ms"][0]
        rows.append({"name": k, **KERNEL_ROWS[k], "launches": pr["launches"][k],
                     "max_abs_err": pr["max_abs_err"][k], "ms": fine["us"] / 1e3,
                     "plain_ms": fine["plain_ms"], "bound_ms": fine["bound_us"] / 1e3,
                     "bound_by": fine["bound_by"], "library_ms": lib,
                     "shape": shape, "tolerance": 0.0, "check": "pass",
                     "path": "probes", **pr["resources"][k], **extra})
    return rows


def _say_probes(pr: dict, smi: str, seconds: float) -> None:
    runs = pr["runs"]
    say(f"[probes] {pr['checks']} checks, every kernel and variant equal to its "
        f"plain version (torch.equal) at every size the probes time and at S = "
        f"1, 8, 16 on both axes and off the block: max_abs_err "
        f"{json.dumps(pr['max_abs_err'])}")
    for row in _probe_rows(pr):
        lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
        say(f"[probes]   {row['name']} {row['shape']} on {smi}: {row['ms'] * 1e3:.2f} "
            f"us/launch, bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}), "
            f"share of bound {row['bound_ms'] / row['ms']:.3f}; tool default "
            f"{row['ms_tool_default'] * 1e3:.2f} us; plain {row['plain_ms']:.4f} ms; "
            f"grid_sample {lib}; blocks of {row['threads']} threads, "
            f"{row['registers']} registers, {row['dyn_smem_bytes']} B dynamic shared "
            f"memory, {row['blocks_per_sm']} blocks per SM; launches {row['launches']}")
    hw = f"{runs['batch_overhead']['H']}x{runs['batch_overhead']['W']}"
    for d, ms in pr["launch_ms_b8"].items():
        say(f"[probes] at b=8 {hw} on {smi}: farneback_iterate_{d} {ms:.5f} ms per "
            f"launch; the y stage alone as shares of it: {json.dumps(pr['shares'][d])}")
    sh = pr["shares"].get("tiled", pr["shares"]["fused"])
    for name in ("chain_fine", "chain_fine_runs", "chain_tile"):
        r = runs[name]
        say(f"[probes]   {name}: {r['bands']} bands of {r['th']}x{r['tw']}, sy-run "
            f"{r['sy_run']}: T {r['variants']['T']['us'] / 1e3:.5f} ms (share of "
            f"bound {fmt_share(r['variants']['T']['share'])}), A "
            f"{r['variants']['A']['us'] / 1e3:.5f} ms; the slab moves {r['bytes']} B, "
            f"the fused kernel's y stage must read {r['fused_y_bytes']} B")
    lo, hi = Y_STAGE_SHARE_PREDICTED
    t = sh["T chain_tile"]
    say(f"[probes] the y stage's share of a launch of the tile design (T on its "
        f"tile geometry, sy in runs of 32; the staged y-stage kernel): {t:.3f}; "
        f"predicted {lo}-{hi}: {'held' if lo <= t <= hi else 'missed'}")
    for row in runs["batch_overhead"]["batches"]:
        say(f"[probes] batch_overhead b={row['b']} {hw} on {smi}: full "
            f"{row['full_ms']:.5f} ms/frame/iter, kernel {row['kernel_ms']:.5f}, "
            f"glue {row['glue_ms']:.5f} ({row['glue_ms'] / row['full_ms']:.3f} of "
            f"full); bound {row['bound_ms_per_launch']:.5f} ms per launch "
            f"({row['bound_by']}, {row['geometry']})")
    say(f"[probes] launches on the probe paths {json.dumps(pr['launches'])}, "
        f"farneback_iterate_fused {pr['fused_launches']}; grid_sample against "
        f"shift_gather max {json.dumps(pr['library_max_abs_diff'])} "
        f"({seconds:.1f} s)")


def _say_kernels(shapes, smi: str) -> None:
    main_shape, hires_shape, scan_shape, _ = shapes

    def way(name, d, lv, place):
        return (f"{name} {d['ms']:.5f} ms, share {d['share']:.3f}, {place}, "
                f"{d['registers']} registers, spills {d.get('spill_stores')}/"
                f"{d.get('spill_loads')} B, {d['smem_bytes']} B shared, "
                f"{d['blocks_per_sm']} blocks per SM, "
                f"{d['ops_with_halo'] / lv['ops']:.2f}x the operations with its halo")

    for r in shapes:
        say(f"[kernels] {r['shape']}: one iteration equal to the plain version "
            f"(torch.equal) at every layer, as scheduled, on strips and on "
            f"tiles, max_abs_err {json.dumps([e['max_abs_err'] for e in r['exact']])}; "
            f"the whole schedule {r['schedule_err_px']} px (tol {SCHEDULE_TOL_PX})")
        for tb, t in r["timings"].items():
            for lv in t["layers"]:
                st, tl = lv["strips"], lv["tiled"]
                say(f"[kernels]   {lv['shape']} x{lv['iterations']} on {smi}: "
                    f"farneback_iterate_fused on {lv['schedule']} "
                    f"{lv['fused']['ms']:.5f} ms against the bound "
                    f"{lv['fused']['bound_ms']:.5f} ms ({lv['fused']['bound_by']}, "
                    f"{lv['ops']} fp32 operations); "
                    f"{way('strips', st, lv, st['geometry'])}; "
                    f"{way('tiles', tl, lv, 'tile ' + tl['tile'])}; in turns "
                    f"{json.dumps([[d, round(x, 5)] for d, x in lv['turns']])}; "
                    f"plain {lv['plain_ms']:.4f} ms")
            say(f"[kernels]   b={tb} per batch of {sum(lv['iterations'] for lv in t['layers'])} "
                f"launches: farneback_iterate_fused {t['fused_ms_per_batch']:.5f} ms "
                f"(strips everywhere {t['strips_ms_per_batch']:.5f}), tile design "
                f"{t['tiled_ms_per_batch']:.5f} ms (bound "
                f"{t['fused_bound_ms_per_batch']:.5f}, plain {t['plain_ms_per_batch']:.4f})")
    for r, tb in ((main_shape, 8), (hires_shape, 2), (scan_shape, 1)):
        lv = r["timings"][tb]["layers"][0]
        say(f"[kernels] farneback_iterate_fused at the finest layer, {lv['shape']}, "
            f"on {lv['schedule']}: share of the byte bound {lv['fused']['share']:.3f} "
            f"against the 0.5 target: "
            f"{'met' if lv['fused']['share'] >= 0.5 else 'missed'} on {smi}")


def _fused_row(shape: dict, tb: int, launches: int, extra: dict) -> dict:
    """The kernels-line row of farneback_iterate_fused at one phase-3 shape
    and batch size: the finest layer's numbers, every layer as scheduled,
    on strips and on tiles beside, and the ms per batch of each; the tile
    design at the finest layer under ``yardstick_tiled``."""
    k = "farneback_iterate_fused"
    t = shape["timings"][tb]
    fine = t["layers"][0]
    f = fine["fused"]
    return {"name": k, **KERNEL_ROWS[k], "launches": launches,
            "max_abs_err": shape["max_abs_err"], "ms": f["ms"],
            "plain_ms": fine["plain_ms"], "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"], "library_ms": None,
            "library_note": "no one PyTorch call: warp, normal equations, box "
                            "mean and 2x2 solve",
            "shape": fine["shape"], "tolerance": 0.0, "check": "pass",
            "schedule_err_px": shape["schedule_err_px"], "schedule": fine["schedule"],
            **{key: f.get(key) for key in ("geometry", "tile", "registers", "smem_bytes",
                                           "blocks_per_sm", "local_bytes")},
            "yardstick_tiled": {key: fine["tiled"][key] for key in (
                "ms", "bound_ms", "tile", "registers", "smem_bytes", "blocks_per_sm")},
            "per_batch": {key: t[key] for key in (
                "fused_ms_per_batch", "strips_ms_per_batch", "tiled_ms_per_batch",
                "fused_bound_ms_per_batch", "plain_ms_per_batch")},
            "layers": [{"shape": lv["shape"], "iterations": lv["iterations"],
                        "plain_ms": lv["plain_ms"], "schedule": lv["schedule"],
                        **{d: {key: lv[d][key] for key in ("ms", "bound_ms", "share")}
                           for d in ("fused", "strips", "tiled")}} for lv in t["layers"]],
            **extra}


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    ranks = int(argv[argv.index("--multi") + 1]) if "--multi" in argv else 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    from mav_detection_tpu_torch import _build
    from mav_detection_tpu_torch.ops.flow import farneback_expand as fe
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
    ptxas = kernel_ptxas(_build.BUILD_LOGS["farneback_iter"])
    probe_regs = [int(n) for n in re.findall(r"Used (\d+) registers",
                                             _build.BUILD_LOGS["shift_probes"])]
    times["build"] = build_s
    expand_regs = [int(n) for n in re.findall(r"Used (\d+) registers",
                                              _build.BUILD_LOGS["farneback_expand"])]
    say(f"[build] csrc/farneback_iter.cu, csrc/farneback_expand.cu and "
        f"csrc/shift_probes.cu (nvcc), runtime/native/loader.cpp and "
        f"runtime/native/png.cpp (g++), started together, built and loaded in "
        f"{build_s:.2f} s; ptxas farneback_iter: {json.dumps(ptxas)}; ptxas "
        f"shift_probes, registers of its {len(probe_regs)} instances: {probe_regs}; "
        f"ptxas farneback_expand, registers of its {len(expand_regs)} kernels: "
        f"{expand_regs}")

    if ranks:
        return main_multi(dev, ranks, smi)

    t0 = time.perf_counter()
    main_shape = phase_kernels(dev, 8, 480, 752, hires=False, ptxas=ptxas)
    hires_shape = phase_kernels(dev, 2, 1024, 1920, hires=True,
                                time_batches=(2, 4), ptxas=ptxas)
    # the scan engine's and entry()'s shape: one frame pair per launch
    scan_shape = phase_kernels(dev, 1, 480, 752, hires=False, ptxas=ptxas)
    scan_hires_shape = phase_kernels(dev, 1, 1024, 1920, hires=True, ptxas=ptxas)
    times["kernels"] = time.perf_counter() - t0
    _say_kernels((main_shape, hires_shape, scan_shape, scan_hires_shape), smi)
    say(f"[kernels] ({times['kernels']:.1f} s)")

    t0 = time.perf_counter()
    expand = phase_expand(dev)
    times["expand"] = time.perf_counter() - t0
    _say_expand(expand, smi, times["expand"])

    t0 = time.perf_counter()
    say("[probes] the TPU probe kernels of tools/, ported (csrc/shift_probes.cu), "
        "through their probe entry points:")
    probes = phase_probes(dev, tiled_ms_b8=main_shape["timings"][8]["layers"][0]
                          ["tiled"]["ms"])
    times["probes"] = time.perf_counter() - t0
    _say_probes(probes, smi, times["probes"])

    t0 = time.perf_counter()
    acc = phase_accuracy(dev)
    times["accuracy"] = time.perf_counter() - t0
    say(f"[accuracy] EPE vs GT (16-px interior): {json.dumps(acc)} "
        f"({times['accuracy']:.1f} s)")

    t0 = time.perf_counter()
    runs = [phase_main_path(dev, 480, 752, 12, 8),
            phase_main_path(dev, 1024, 1920, 6, 4)]
    times["main_path"] = time.perf_counter() - t0
    for r in runs:
        say(f"[main path] {r['size']} {r['pairs']} pairs batch {r['batch']}: "
            f"{r['frames_per_s']:.2f} frames/s on {smi}, median FoE err "
            f"{r['median_foe_err_px']:.3f} px, launches {r['launches']}, "
            f"stages ms {json.dumps(r['stages_ms'])}, device ms per batch "
            f"{json.dumps(r['device_ms_per_batch'])} of {r['wall_ms_per_batch']:.3f} "
            f"ms wall (device idle share {r['device_idle_share']:.3f})")

    t0 = time.perf_counter()
    say("[modules] card against CPU at 752x480, same explicit draws:")
    mods = phase_modules(dev)
    times["modules"] = time.perf_counter() - t0
    say(f"[modules] {mods['checks']} comparisons within tolerance; "
        f"{mods['corners']} corners; host-clock ms per frame at 752x480 on "
        f"{smi}: {json.dumps(mods['ms_per_frame'])} ({times['modules']:.1f} s)")
    t0 = time.perf_counter()
    solv = phase_solvers(dev)
    times["solvers"] = time.perf_counter() - t0
    say(f"[modules] tensor-code Farneback solvers, b=1 at 752x480: "
        f"{solv['checks']} comparisons within tolerance; host-clock ms per call "
        f"on {smi}: {json.dumps(solv['ms'])} ({times['solvers']:.1f} s)")

    t0 = time.perf_counter()
    art = phase_artifacts(dev)
    times["artifacts"] = time.perf_counter() - t0
    say(f"[artifacts] FoE loop, FARNEBACK, batch 8, {art['pairs']} pairs at "
        f"752x480 with save_images: 4 x {art['pairs']} PNGs "
        f"({art['png_bytes']} bytes), video.npz and {art['pairs']} JSON "
        f"written; artifacts stage {art['artifacts_ms_per_frame']:.2f} ms per "
        f"frame, encode {art['encode_ms_per_frame']:.2f} ms per frame on {smi}; "
        f"launches {art['launches']}; stages ms {json.dumps(art['stages_ms'])} "
        f"({times['artifacts']:.1f} s)")

    t0 = time.perf_counter()
    hom = phase_homography(dev)
    times["homography"] = time.perf_counter() - t0
    for tag, r in hom.items():
        say(f"[homography] {tag} ({'--use-sparse-of, ' if tag == 'sparse' else ''}"
            f"FARNEBACK flow, {r['pairs']} pairs at 752x480): IoU per frame on "
            f"the card {json.dumps(r['ious_card'])} (median "
            f"{r['median_iou_card']:.4f}), on the CPU {json.dumps(r['ious_cpu'])} "
            f"(median {r['median_iou_cpu']:.4f}, gate: card >= CPU - 0.05); card "
            f"box against CPU box IoU {json.dumps([round(v, 3) for v in r['card_vs_cpu_box_iou']])}; "
            f"farneback_iterate_fused launches {r['launches']}; "
            f"{r['ms_per_frame_card']:.2f} ms per frame on {smi} "
            f"({r['wall_s_cpu']:.1f} s on the CPU); {r['mosaics']} mosaics; "
            f"stages ms {json.dumps(r['stages_ms_card'])}")
    say(f"[homography] ({times['homography']:.1f} s)")

    t0 = time.perf_counter()
    lkr = phase_lucas_kanade(dev)
    times["lucas_kanade"] = time.perf_counter() - t0
    say(f"[lucas_kanade] 752x480 bench scene: {lkr['survivors']} survivors of "
        f"{lkr['max_corners']} (gate >= 75 %), mean track EPE "
        f"{lkr['track_epe_px']:.4f} px (gate < 0.12), dense interior EPE "
        f"{lkr['dense_interior_epe_px']:.4f} px (gate < 1.6); FoE loop with "
        f"LUCAS_KANADE flow: {json.dumps(lkr['foe_loop'])} on {smi} "
        f"({times['lucas_kanade']:.1f} s)")

    t0 = time.perf_counter()
    scan = phase_scan(dev)
    times["scan"] = time.perf_counter() - t0
    for tag, r in scan.items():
        say(f"[scan] engine=scan FARNEBACK {tag} on {smi}: {json.dumps(r)}")
    b8 = runs[0]
    say(f"[scan] 752x480 per frame on {smi}: scan engine "
        f"{scan['752x480']['loop_ms_per_transition']:.3f} ms in the loop "
        f"({scan['752x480']['wall_ms_per_transition']:.3f} ms with staging and "
        f"JSON), device {scan['752x480']['device_ms_per_transition']:.3f} ms, "
        f"idle share {scan['752x480']['device_idle_share']:.3f}; batch engine "
        f"(phase 5, b=8) {b8['wall_ms_per_batch'] / b8['batch']:.3f} ms wall, "
        f"device {sum(b8['device_ms_per_batch'].values()) / b8['batch']:.3f} ms, "
        f"idle share {b8['device_idle_share']:.3f} ({times['scan']:.1f} s)")

    t0 = time.perf_counter()
    nat = phase_native(dev)
    times["native"] = time.perf_counter() - t0
    say(f"[native] loader.cpp alone builds with g++ in {nat['gxx_build_s']:.2f} s; "
        f"16 .flo files at 752x480 native <-> numpy bit-equal; prefetcher in "
        f"order, at most {nat['prefetcher_peak_inflight']} in flight (depth 4); "
        f"truncated file raises; ms per file on this host "
        f"{json.dumps(nat['ms_per_file'])}; PRECOMPUTED main path from disk: "
        f"{json.dumps(nat['precomputed'])} on {smi}, JSON equal between the "
        f"readers ({times['native']:.1f} s)")

    t0 = time.perf_counter()
    ent = phase_entry(dev)
    times["entry"] = time.perf_counter() - t0
    say(f"[entry] entry() at 240x320 on {smi}: {json.dumps(ent)} "
        f"({times['entry']:.1f} s)")

    t0 = time.perf_counter()
    nets = phase_nets(dev)
    times["nets"] = time.perf_counter() - t0
    for net, ld in nets["load"].items():
        say(f"[nets] {net}: {ld['path']} ({ld['bytes']} bytes) read by the port's "
            f"msgpack reader in {ld['read_s']:.3f} s, converted in "
            f"{ld['convert_s']:.3f} s: {ld['tensors']} tensors, "
            f"{ld['parameters']} parameters{', migrated' if ld.get('migrated') else ''}")
    say(f"[nets] SkyUNet 752x480 on {smi}: {json.dumps(nets['sky'])}")
    for k, v in nets["raft"].items():
        say(f"[nets] RAFT {k} on {smi}: {json.dumps(v)}")
    for lp in nets["loops"]:
        say(f"[nets] RAFT loop {lp['size']} {lp['pairs']} pairs batch {lp['batch']}: "
            f"{lp['frames_per_s']:.2f} frames/s on {smi}, device ms per batch "
            f"{json.dumps(lp['device_ms_per_batch'])} (events; the flow alone "
            f"{lp['flow_device_ms_per_batch']:.3f} ms, {lp['flow_device_timer']}) of "
            f"{lp['wall_ms_per_batch']:.3f} ms wall (device idle share "
            f"{lp['device_idle_share']:.3f}, {lp['device_idle_share_graph']:.3f} with "
            f"the graph's flow), escalation rungs {lp['escalation_rungs']} of "
            f"{lp['saturation_checks']} checks, host looks per batch "
            f"{lp['host_looks_per_batch']:.2f} {json.dumps(lp['synchronising_calls'])}, "
            f"median FoE err "
            f"{lp['median_foe_err_px']:.3f} px, stages ms {json.dumps(lp['stages_ms'])}, "
            f"farneback launches {lp['farneback_launches']}")
    for st in nets["stages"]:
        say(f"[nets] RAFT stage 752x480 b=8 {st['stage']}: {st['ms']:.4f} ms "
            f"({st['timer']}), bound {st['bound_ms']:.4f} ms ({st['bound_by']}: "
            f"{st['bytes']} bytes, {st['gflop_fp32']:.3f} GFLOP fp32, "
            f"{st['gflop_bf16']:.3f} GFLOP bf16), share of bound "
            f"{st['bound_ms'] / st['ms']:.3f} on {smi}")
    say(f"[nets] {nets['checks']} checks within tolerance ({times['nets']:.1f} s)")

    t0 = time.perf_counter()
    dsets = phase_datasets(dev)
    times["datasets"] = time.perf_counter() - t0
    mg = dsets["midgard"]
    say(f"[datasets] MIDGARD layout 752x480, 11 pairs, the CLI's defaults on {smi}: "
        f"{mg['skyunet_in_loop_frames_per_s']:.2f} frames/s with the SkyUNet in the "
        f"loop, {mg['cached_masks_frames_per_s']:.2f} on the cached masks "
        f"({mg['hrnet_pngs']} HRNet-layout PNGs), {mg['precomputed_frames_per_s']:.2f} "
        f"on PRECOMPUTED through the prefetcher ({mg['prefetcher_files']} files), "
        f"scan engine {mg['scan_ms_per_transition']:.2f} ms per transition; launches "
        f"{json.dumps(dsets['launches'])}")
    say(f"[datasets] card vs CPU, 4 frames: {json.dumps(dsets['midgard_card_vs_cpu'])}; "
        f"depth-less sky_tpr (both engines, sky_fpr NaN) "
        f"{json.dumps(dsets['depthless_sky_tpr'])}")
    pg = dsets["png"]
    say(f"[datasets] PNG decode {pg['size']} RGB, Paeth rows, on this host: native "
        f"{pg['native_ms']:.3f} ms, plain loop {pg['plain_ms']:.1f} ms per frame, "
        f"bit-equal; decodes native {pg['native_decodes']} / plain "
        f"{pg['plain_decodes']} in this step, {pg['native_decodes_total']} native in "
        f"the process")
    sm = dsets["sim"]
    say(f"[datasets] AirSim layout {sm['size']}, {sm['frames']} mock captures: render "
        f"{sm['render_s_per_frame']:.2f} s per frame (host); SimDataset opened in "
        f"{sm['open_s']:.2f} s; GT flow {sm['gt_flow_ms_per_pair']:.2f} ms per pair with "
        f"its file IO, {sm['gt_flow_device_ms_per_pair']:.3f} ms on the card (events), "
        f"card vs CPU {sm['gt_flow_card_vs_cpu_px']:.3g} px (tol "
        f"{GT_FLOW_CARD_CPU_TOL_PX}) on {smi}")
    for src_name, lp in sm["loops"].items():
        say(f"[datasets] AirSim FoE loop {sm['size']} batch 4 {src_name}: "
            f"{lp['frames_per_s']:.2f} frames/s on {smi}, median |FoE - GT FoE| "
            f"{lp['median_foe_err_px']:.2f} px, FoE in frame {lp['foe_in_frame']} of "
            f"{lp['pairs']}, launches {lp['launches']}")
    say(f"[datasets] {dsets['checks']} checks within tolerance; the CLI runs' "
        f"validation (FLOW_UV, TinyYOLO, GT flow from optical-flow/) s "
        f"{json.dumps(dsets['validation_s'])} ({times['datasets']:.1f} s)")

    t0 = time.perf_counter()
    yo = phase_yolo(dev)
    times["yolo"] = time.perf_counter() - t0
    for name, ld in yo["load"].items():
        say(f"[yolo] {name}.msgpack ({ld['bytes']} bytes) read in {ld['read_s']:.3f} s, "
            f"converted in {ld['convert_s']:.3f} s: {ld['tensors']} tensors, "
            f"{ld['parameters']} parameters")
    say(f"[yolo] card vs CPU on {smi}: {json.dumps(yo['card_vs_cpu'])}")
    say(f"[yolo] mean IoU / detection rate on the card against the JAX package's "
        f"(gate {YOLO_IOU_TOL} / one frame) on {smi}: {json.dumps(yo['quality'])}")
    tm = yo["timing"]
    for stage in ("forward", "decode_nms"):
        st = tm[stage]
        say(f"[yolo] TinyYOLO {stage} {tm['size']} b={tm['batch']} bf16 on {smi}: "
            f"{st['ms']:.4f} ms ({st['timer']}), {st['events_ms']:.4f} ms eager (events), "
            f"bound {st['bound_ms']:.5f} ms ({st['bound_by']}), share of bound "
            f"{st['bound_ms'] / st['ms']:.4f}, device activities per call "
            f"{st['launches'] if st['launches'] is not None else 'not measured'}"
            + (f", {st['gflop_bf16']:.3f} GFLOP bf16 + {st['gflop_fp32']:.4f} fp32"
               if stage == "forward" else ""))
    say(f"[yolo] detect + box strings per batch of {tm['batch']} (upload, forward, "
        f"decode, one pull, formatting), host clock: {tm['detect_batch_wall_ms']:.3f} ms; "
        f"host looks per batch {tm['host_looks_per_batch']} on {smi}")
    sv = yo["server"]
    say(f"[yolo] server, {sv['frames']} frames {sv['size']} per request ({sv['media_bytes']} "
        f"bytes npz) on {smi}: {sv['requests_per_s']:.3f} requests/s, "
        f"{sv['ms_per_frame']:.3f} ms per frame; in-process decode {sv['decode_ms']:.2f} ms, "
        f"infer {sv['infer_ms']:.2f} ms, annotate {sv['annotate_ms']:.2f} ms; answers equal "
        f"engine.predict, 4 concurrent posts equal, non-npz 400")
    cl = yo["cli"]
    say(f"[yolo] CLI defaults on the MIDGARD-layout copy without optical-flow/, {smi}: "
        f"{cl['wall_s']:.2f} s, validation {cl['validation_s']:.2f} s (figures "
        f"{cl['figures']}); farneback_iterate_fused launches {cl['detection_launches']} in "
        f"detection, {cl['validation_launches']} in validation; stats "
        f"{json.dumps(cl['stats'])}; remote branch (YOLO_INFERENCE_HOST, the port's server) "
        f"{cl['remote_validation_s']:.2f} s, {cl['remote_validation_launches']} launches, "
        f"IoU stats equal; --prepare-dataset FLOW_FOE_YOLO {cl['convert_s']:.2f} s, "
        f"{cl['convert_launches']} launches")
    say(f"[yolo] {yo['checks']} checks within tolerance ({times['yolo']:.1f} s)")

    t0 = time.perf_counter()
    tr = phase_train(dev)
    times["train"] = time.perf_counter() - t0
    for tag, r in tr["card_vs_cpu"].items():
        say(f"[train] one update card vs CPU {tag} on {smi}: {json.dumps(r)}")
    for tag, r in tr["runs"].items():
        say(f"[train] {tag} {r['size']} b={r['batch']}, {r['steps']} steps in chunks of "
            f"{r['chunk']} from the shipped weights, with selection, on {smi}: "
            f"{r['ms_per_step']:.3f} ms per step ({r['steps_per_s']:.2f} steps/s), "
            f"bound {r['bound_ms_per_step']:.4f} ms ({r['bound_by']}: "
            f"{r['gflop_per_step_bf16']:.2f} GFLOP bf16 + {r['gflop_per_step_fp32']:.3f} "
            f"fp32), share of bound {r['share_of_bound']:.4f}; max_memory_allocated "
            f"{r['max_memory_allocated_bytes']} bytes; host looks inside chunks "
            f"{r['host_looks_in_chunks']}, per chunk outside the selector "
            f"{r['host_looks_per_chunk']:.2f}; {r['selector_calls']} selector calls, "
            f"{r['wall_s_with_selection']:.2f} s with selection; loss "
            f"{r['first_loss']:.4f} -> {r['last_loss']:.4f}")
    ev = tr["evals"]
    say(f"[train] evals of the shipped checkpoints on {smi}: card {json.dumps(ev['card'])}; "
        f"JAX on the CPU {json.dumps(ev['jax_cpu'])}")
    say(f"[train] CLI --model all --steps 20 --chunk 10 in {tr['cli']['s']:.1f} s: wrote "
        f"{tr['cli']['written']}, read back by the port's reader, finite; "
        f"{tr['checkpoints_sha256_unchanged']} files under checkpoints/ unchanged "
        f"(sha256); fused kernel launches in training {json.dumps(tr['launches_train'])}")
    for ln in tr["cli"]["log"]:
        say(f"[train]   {ln}")
    say(f"[train] {tr['checks']} checks within tolerance ({times['train']:.1f} s)")

    t0 = time.perf_counter()
    tools = phase_tools(dev)
    times["tools"] = time.perf_counter() - t0
    trc = tools["trace"]
    say(f"[tools] trace_to around one {trc['size']} b={trc['batch']} main-path batch on "
        f"{smi}: {trc['trace_bytes']} bytes of Chrome trace, {trc['device_ms']:.3f} ms on "
        f"the card, launches {json.dumps(trc['launches'])}; top device ops:")
    for op in trc["top_device_ops"]:
        say(f"[tools]   {op['device_ms']:.4f} ms ({op['share']:.3f}) x{op['calls']} {op['name']}")
    say(f"[tools] foe_angular_error_map: {json.dumps(tools['foe_angular_error_map'])}; "
        f"run_demo on the mock: {json.dumps(tools['demo'])}; figures without matplotlib: "
        f"{json.dumps(tools['figures'])} ({times['tools']:.1f} s)")
    t0 = time.perf_counter()
    tflow = phase_tools_flow(dev)
    times["tools_flow"] = time.perf_counter() - t0
    _say_tools_flow(tflow, smi, times["tools_flow"])
    _keep("tools_flow.json", tflow)
    t0 = time.perf_counter()
    teval = phase_tools_eval(dev)
    times["tools_eval"] = time.perf_counter() - t0
    _say_tools_eval(teval, smi, times["tools_eval"])
    _keep("tools_eval.json", teval)
    t0 = time.perf_counter()
    multi = phase_multi(dev)
    times["multi"] = time.perf_counter() - t0
    _say_multi(multi, smi, times["multi"])
    dp, sp, chk = (multi[k] for k in ("data_parallel", "spatial", "chunked"))
    t0 = time.perf_counter()
    bn = phase_bench(dev)
    times["bench"] = time.perf_counter() - t0
    say(f"[bench] python -m mav_detection_tpu_torch.bench on {smi} (cv2 oracle and "
        f"baseline given): {bn['seconds']:.1f} s, farneback_iterate_fused launched "
        f"{bn['launches']} times, the band kernel {bn['expand_launches']}, EPE vs cv2 {bn['epe_cv2_px']} px, chip health "
        f"{bn['result']['chip_health']} ({times['bench']:.1f} s)")
    say(bn["line"])
    say(f"[phases] seconds {json.dumps(times)}")

    k = "farneback_iterate_fused"
    rows = [_fused_row(main_shape, 8, runs[0]["launches"][k], {
        "launches_1920x1024": runs[1]["launches"][k],
        "launches_artifacts": art["launches"][k],
        "launches_homography": hom["plain"]["launches"][k],
        "launches_homography_sparse": hom["sparse"]["launches"][k],
        "launches_scan": scan["752x480"]["launches"][k],
        "launches_scan_sparse": scan["752x480 use_sparse_of"]["launches"][k],
        "launches_scan_1920x1024": scan["1920x1024"]["launches"][k],
        "launches_entry": ent["launches"][k],
        "launches_datasets": dsets["launches"],
        "launches_validator": yo["launches"]["validation"],
        "launches_validator_remote": yo["launches"]["remote_validation"],
        "launches_convert": yo["launches"]["convert"],
        "launches_yolo_cli_detection": yo["launches"]["detection"],
        "launches_train": tr["launches_train"][k],
        "launches_tools_trace": trc["launches"][k],
        "launches_multi_data_parallel": dp["launches"][k],
        "launches_multi_chunked": chk["launches"][k],
        "launches_multi_spatial": sp["launches"][k],
        "launches_batch_overhead_probe": probes["fused_launches"],
        "launches_tools_flow": tflow["launches"],
        "launches_tools_eval": teval["launches"],
        "hires": _fused_row(hires_shape, 2, runs[1]["launches"][k], {}),
        "hires_b4": _fused_row(hires_shape, 4, runs[1]["launches"][k], {})})]
    # the same kernel at the scan engine's shape, b = 1
    rows.append(_fused_row(scan_shape, 1, scan["752x480"]["launches"][k], {
        "path": "scan engine",
        "hires": _fused_row(scan_hires_shape, 1, scan["1920x1024"]["launches"][k], {})}))
    rows += _probe_rows(probes)

    def band(counts):
        return sum(counts[key] for key in fe.KERNELS)
    rows.append(_expand_row(expand, {
        "launches": band(runs[0]["launches"]),
        "launches_per_kernel": {key: runs[0]["launches"][key] for key in fe.KERNELS},
        "launches_1920x1024": band(runs[1]["launches"]),
        "launches_artifacts": band(art["launches"]),
        "launches_homography": band(hom["plain"]["launches"]),
        "launches_homography_sparse": band(hom["sparse"]["launches"]),
        "launches_scan": band(scan["752x480"]["launches"]),
        "launches_scan_sparse": band(scan["752x480 use_sparse_of"]["launches"]),
        "launches_scan_1920x1024": band(scan["1920x1024"]["launches"]),
        "launches_entry": band(ent["launches"]),
        "launches_datasets": dsets["expand_launches"],
        "launches_yolo": yo["expand_launches"],
        "launches_tools_trace": band(trc["launches"]),
        "launches_multi_data_parallel": band(dp["launches"]),
        "launches_multi_chunked": band(chk["launches"]),
        "launches_multi_spatial": band(sp["launches"]),
        "launches_bench": bn["expand_launches"]}))
    say(json.dumps({"nets": {k: nets[k] for k in ("load", "sky", "raft", "stages")},
                    "datasets": {key: dsets[key] for key in (
                        "midgard", "midgard_card_vs_cpu", "png", "sim")},
                    "yolo": {key: yo[key] for key in (
                        "load", "card_vs_cpu", "quality", "timing", "server", "cli")},
                    "train": {key: tr[key] for key in ("card_vs_cpu", "runs", "evals")},
                    "tools": {"trace": trc, "foe_angular_error_map":
                              tools["foe_angular_error_map"], "demo": tools["demo"]},
                    "tools_flow": _tools_summary(tflow),
                    "tools_eval": _tools_summary(teval),
                    "multi": {key: multi[key] for key in (
                        "backend", "world_size", "nccl", "data_parallel", "spatial",
                        "chunked", "train")},
                    "nets_loops": [{k: lp[k] for k in (
                        "size", "frames_per_s", "device_ms_per_batch",
                        "flow_device_ms_per_batch", "wall_ms_per_batch",
                        "device_idle_share", "device_idle_share_graph",
                        "escalation_rungs", "host_looks_per_batch",
                        "median_foe_err_px")} for lp in nets["loops"]]}))
    say(json.dumps({"kernels": rows,
                    "main_path": [{k: r[k] for k in (
                        "size", "frames_per_s", "median_foe_err_px",
                        "device_ms_per_batch", "wall_ms_per_batch",
                        "device_idle_share")} for r in runs],
                    "scan": {tag: {key: r[key] for key in (
                        "wall_ms_per_transition", "loop_ms_per_transition",
                        "device_ms_per_transition", "device_idle_share")}
                        for tag, r in scan.items() if "device_idle_share" in r}}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
