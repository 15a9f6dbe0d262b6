"""Traffic kind ``step``: the flow + detect step alone, paced by the card.

The step is the program's ``farneback_flow_batch`` (its product flow
configuration for the frame size) then ``detect_frame_batch_scalars``, on
``batch`` frame pairs, captured once as a CUDA graph and replayed back to
back. Each replay takes the next batch from a ring of distinct consecutive
frames on the card (at least ``ring_bytes`` of gray frames) by device copies
inside the graph, and writes its flow and packed scalars into that slot of
an output ring, so the judge reads what the window produced.
``step_frames_per_s``: frame pairs over the window's seconds, host clock
around synchronised replays. Traffic parameters: ``batch``,
``ring_bytes``, ``chunk_s`` (seconds of replays between host looks),
``trace_s`` (the traced slice), ``check_slots`` (slots the judge compares),
``limits``.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from h100_bench import scene
from h100_bench.judge import Pair
from mav_detection_tpu_torch.ops.flow.farneback import farneback_flow_batch
from mav_detection_tpu_torch.pipeline.detector import (
    DetectionStep,
    detect_frame_batch_scalars,
    pack_frame_scalars,
)


def _scene(config):
    return dict(config["scene"], height=config["height"], width=config["width"])


def prepare(run) -> None:
    cfg, p, dev = run.config, run.params, run.device
    h, w, B = int(cfg["height"]), int(cfg["width"]), int(p["batch"])
    N = int(cfg["foe_samples"])
    slots = max(2, math.ceil(int(p["ring_bytes"]) / (B * h * w)))
    n = slots * B + 1
    sc = scene.render(_scene(cfg), n, run.seed, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed((run.seed + 1) % (2 ** 63))
    syx = torch.stack([torch.randint(0, h, (slots, B, 2 * N), generator=gen, device=dev),
                       torch.randint(0, w, (slots, B, 2 * N), generator=gen, device=dev)], -1)
    depth = sc["depth"] if cfg["depth"] else torch.ones((h, w), device=dev)
    omega = sc["omega"] if cfg["imu"] else torch.zeros((n, 3), device=dev)
    gt_foe = sc["foe"] if cfg["gt_foe"] else torch.full((2,), float("nan"), device=dev)
    st = run.state
    st.update(frames=sc["gray"], seg=sc["seg"], sky=sc["sky"], omega=omega, syx=syx,
              depth=depth, gt_foe=gt_foe, dt=float(cfg["scene"]["dt"]), slots=slots,
              batch=B)
    depth_b = depth.expand(B, h, w)
    foe_b = gt_foe.expand(B, 2).contiguous()
    dts = torch.full((B,), st["dt"], device=dev)
    gt_flow = torch.zeros((B, h, w, 2), device=dev)
    idx = torch.zeros((1,), dtype=torch.int64, device=dev)
    lanes = torch.arange(B, device=dev)
    out_flow = torch.full((slots, B, h, w, 2), float("nan"), device=dev)
    out_sc = torch.full((slots, B, 12), float("nan"), device=dev)
    control = run.control
    det = DetectionStep(foe_samples=N)
    detect = control.detect if control is not None else detect_frame_batch_scalars

    def flow_of(prev, curr):
        if control is not None:
            return control.flow(prev, curr)
        return farneback_flow_batch(prev, curr, None, dev)

    def step():
        base = idx * B + lanes
        flow = flow_of(sc["gray"].index_select(0, base), sc["gray"].index_select(0, base + 1))
        s = detect(
            flow, gt_flow, omega.index_select(0, base), dts, sc["seg"].index_select(0, base),
            sc["sky"].index_select(0, base), depth_b, foe_b,
            sample_yx=syx.index_select(0, idx)[0], config=det)
        out_flow.index_copy_(0, idx, flow[None])
        out_sc.index_copy_(0, idx, pack_frame_scalars(s)[None])
        idx.copy_(torch.remainder(idx + 1, slots))

    if dev.type == "cuda" and control is None:
        from h100_bench import timing
        graph = timing.capture(step)
        replay = graph.replay
    else:
        replay = step
    replay()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out_flow.fill_(float("nan"))
    out_sc.fill_(float("nan"))
    # the closure keeps every tensor the graph reads alive
    st.update(step=step, replay=replay, out_flow=out_flow, out_sc=out_sc, flow_of=flow_of,
              gt_flow=gt_flow, depth_b=depth_b, foe_b=foe_b, dts=dts, det=det)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _replays(run, seconds: float, at_least: int = 1) -> tuple:
    """(replays, seconds): replays in chunks of about ``chunk_s`` until
    ``seconds`` have passed and ``at_least`` were made, at most two chunks
    in flight."""
    st, dev = run.state, run.device
    replay = st["replay"]
    t = time.perf_counter()
    replay()
    _sync(dev)
    per = max(time.perf_counter() - t, 1e-4)
    chunk = max(1, int(float(run.params["chunk_s"]) / per))
    _sync(dev)
    t0 = time.perf_counter()
    n, pending = 0, None
    while True:
        for _ in range(chunk):
            replay()
        n += chunk
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            if pending is not None:
                pending.synchronize()
            pending = ev
        if time.perf_counter() - t0 >= seconds and n >= at_least:
            break
    _sync(dev)
    return n, time.perf_counter() - t0


def window(run) -> dict:
    st = run.state
    n, secs = _replays(run, run.seconds, at_least=st["slots"])
    B = st["batch"]
    bad = ~torch.isfinite(st["out_flow"]).all(dim=(2, 3, 4)) | \
        ~torch.isfinite(st["out_sc"][..., :2]).all(dim=2)
    failed = int(bad.sum()) * math.ceil(n / st["slots"])
    return {"attempted": n * B, "failed": failed,
            "metrics": {"step_frames_per_s": n * B / secs}}


def traced(run) -> None:
    _replays(run, float(run.params["trace_s"]))


def pairs(run) -> list:
    st = run.state
    B = st["batch"]
    rng = np.random.default_rng([run.seed, 7])
    k = min(int(run.params["check_slots"]), st["slots"])
    slots = rng.choice(st["slots"], size=k, replace=False)
    out = []
    flows = st["out_flow"]
    sc = st["out_sc"].cpu().numpy()
    frames = st["frames"]
    for s in sorted(int(v) for v in slots):
        for j in range(B):
            i = s * B + j
            out.append(Pair(
                prev=frames[i].cpu().numpy(), curr=frames[i + 1].cpu().numpy(),
                seg=st["seg"][i].clone(), sky=st["sky"][i].clone(), depth=st["depth"],
                omega=st["omega"][i].tolist(), dt=st["dt"],
                gt_foe=st["gt_foe"].tolist(), sample_yx=st["syx"][s, j].clone(),
                flow=flows[s, j].clone(), scalars=sc[s, j].tolist()))
    return out


def release(run) -> None:
    for key in ("step", "replay", "out_flow", "out_sc", "frames", "seg", "sky", "syx"):
        run.state.pop(key, None)
