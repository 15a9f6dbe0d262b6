"""Headline benchmark of the port: flow + detect frames/s on one card at 752x480.

The port of the repository's ``bench.py``, which stays the JAX package's
benchmark. The scene, step, gates and JSON keys are its own::

    python -m mav_detection_tpu_torch.bench [--device cpu]

prints one line of strict JSON (``null`` where a number was not taken):
``metric``, ``value`` (frames/s at batch 8, the headline), ``unit``,
``vs_baseline``, ``fps_batch8``, ``fps_single``, ``config`` (what ran,
``effective_fused_config`` included), the chip-health canaries
``canary_matmul_tflops``, ``kernel_ms_per_iter`` and ``chip_health``,
``host`` and ``hires`` (1920x1024), as ``bench.py`` does; then ``eager``
(the same steps timed eagerly) and ``device`` (the card's name and power
limit from ``nvidia-smi``).

Timing. On a card the step (``farneback_flow_batch`` then
``detect_frame_batch_scalars`` on ``bench.py``'s inputs) is captured once in
a CUDA graph and replayed back to back, so no host work sits between steps:
the counterpart of the reference's in-program ``fori_loop``. The replay
count grows until the measured window t(n) - t(1) spans ``MIN_WINDOW_S``
(``bench.py``'s rule). The eager figure, CUDA events around the same steps
launched one by one, goes under ``"eager"``: the batch engine is host-bound,
and the graph hides exactly that. ``--device cpu`` runs the plain versions
on the host clock, and the canaries are not measured there.

The reference's cv2 oracle and cv2-on-the-CPU baseline come from the caller
(``main(..., cv2_flow=...)``, a function of (prev8, curr8) returning
``cv2.calcOpticalFlowFarneback``'s flow): the package runs no cv2. Without
it the EPE vs cv2 and ``vs_baseline`` are ``null``. With it the gates of
``bench.py`` hold: EPE vs cv2 < 0.1 px at 752x480 (and EPE vs the analytic
GT < 0.55 px at 1920x1024 always), each raising where it fails.

Environment: ``MAV_BENCH_WARP`` picks the solver (default ``fused``; the
reference's name ``pallas`` means ``fused``); ``MAV_BENCH_HIRES=0`` skips
the 1920x1024 fields. The reference's ``band_rows`` is a TPU-only knob with
no counterpart here.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

# bench.py's scene constants (FOE, EXPANSION, OMEGA, DT) are data/scene.py's
from mav_detection_tpu_torch.data.scene import DT, EXPANSION, FOE, OMEGA, epe_interior  # noqa: F401
from mav_detection_tpu_torch.ops.flow.farneback import (
    FarnebackParams,
    border_scale_map,
    effective_fused_config,
    farneback_flow,
    farneback_flow_batch,
    poly_exp,
    tuned_flow_params,
)
from mav_detection_tpu_torch.ops.flow.farneback_iter import farneback_iterate
from mav_detection_tpu_torch.pipeline.detector import (
    DetectionStep,
    detect_frame_batch_scalars,
)
from mav_detection_tpu_torch.tools.common import dumps, fmt, oracle_flow, parser, scene
from mav_detection_tpu_torch.utils.device import resolve_device
from mav_detection_tpu_torch.utils.timing import eager_ms

H, W = 480, 752
BATCH = 8
HIRES_HW = (1024, 1920)   # the reference's native AirSim cameras

CV2_GATE_PX = 0.1          # EPE vs the cv2 oracle at 752x480 (bench.py:243)
HIRES_GATE_PX = 0.55       # EPE vs the analytic GT at 1920x1024 (bench.py:415)
MIN_WINDOW_S = 0.5         # the amortised window t(n) - t(1) must span this
EAGER_REPS = 10            # eager steps timed after warm-up
REACH_TIMEOUT_S = 180.0    # device_reachable's wait

# the matmul canary: M x M x M bf16 products chained with an abs-max rescale,
# CANARY_CHAIN of them in one captured graph
CANARY_M = 2048
CANARY_CHAIN = 64
# healthy bands of the canaries on an NVIDIA H100 80GB HBM3 at 700.00 W, set
# from that card's readings (PERF.md §6, the bench: 309.3-312.3 TFLOP/s and
# 0.015082-0.015115 ms per frame per iteration over seven runs in two calls):
# the matmul at least 2/3 of the lowest reading, the kernel at most 1.5x the
# highest
HEALTHY_TFLOPS_MIN = 206.0
HEALTHY_KERNEL_MS_MAX = 0.0227


def _warp() -> str:
    warp = os.environ.get("MAV_BENCH_WARP", "fused")
    return "fused" if warp == "pallas" else warp


def _params(hw=None) -> FarnebackParams:
    """The benchmarked configuration at ``hw`` (default (H, W)): the
    product's ``tuned_flow_params`` for the fused warp, else three layers of
    10 iterations with the ``fast`` refit schedule (``bench.py``'s)."""
    h, w = hw if hw is not None else (H, W)
    warp = _warp()
    if warp == "fused":
        return tuned_flow_params(h, w)
    return FarnebackParams(levels=2, pyr_scale=0.5, warp=warp, fast=True, iterations=10)


def make_step(prev8: np.ndarray, curr8: np.ndarray, batch: int, params: FarnebackParams,
              dev, generator: Optional[torch.Generator] = None):
    """(flow, step) closures over ``batch`` copies of the pair on ``dev``:
    ``flow()`` is ``farneback_flow_batch``; ``step(sample_yx=None)`` that
    flow then ``detect_frame_batch_scalars`` on ``bench.py``'s inputs (zero
    GT flow and IMU rates, empty masks, unit depth, a centred GT FoE,
    interval DT), its FoE samples ``sample_yx`` where given, else drawn
    from ``generator`` (a fresh one seeded 0 by default)."""
    h, w = prev8.shape
    a = torch.as_tensor(np.repeat(prev8[None], batch, 0), dtype=torch.float32).to(dev)
    b = torch.as_tensor(np.repeat(curr8[None], batch, 0), dtype=torch.float32).to(dev)
    aux = (torch.zeros((batch, h, w, 2), device=dev), torch.zeros((batch, 3), device=dev),
           torch.full((batch,), DT, device=dev),
           torch.zeros((batch, h, w), dtype=torch.uint8, device=dev),
           torch.zeros((batch, h, w), dtype=torch.bool, device=dev),
           torch.ones((batch, h, w), device=dev),
           torch.tensor([[w / 2.0, h / 2.0]], device=dev).repeat(batch, 1))
    gen = generator if generator is not None else (
        torch.Generator(device=dev).manual_seed(0))
    config = DetectionStep()

    def flow():
        return farneback_flow_batch(a, b, params, dev)

    def step(sample_yx=None):
        return detect_frame_batch_scalars(flow(), *aux, sample_yx=sample_yx,
                                          generator=gen, config=config)

    return flow, step


def amortized(run: Callable[[int], float], n: int, cap: int):
    """(seconds per call, n) by ``bench.py``'s rule: ``run(k)`` gives the
    seconds of k calls; n grows 4x until t(n) - t(1) spans MIN_WINDOW_S (or n
    reaches ``cap``), and the answer is that window over n - 1 calls."""
    run(1)
    while True:
        t1 = run(1)
        tn = run(n)
        if tn - t1 > MIN_WINDOW_S or n >= cap:
            return (tn - t1) / (n - 1), n
        n *= 4


def replayer(fn: Callable[[], object], dev: torch.device, generators=()):
    """``run(k)``: the seconds of k calls of ``fn``. On a card ``fn`` is
    captured once in a CUDA graph (after three warm-up calls, which build
    the kernels and the cached constants) and ``run`` replays it k times
    back to back between two CUDA events; the random ``generators`` are
    registered with the graph, so every replay draws anew. A capture that
    fails raises. On the CPU, k calls on the host clock."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        def run_host(k: int) -> float:
            t0 = time.perf_counter()
            for _ in range(k):
                fn()
            return time.perf_counter() - t0
        return run_host

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()

    def run(k: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3

    return run


def gpu_ms_per_frame(prev8: np.ndarray, curr8: np.ndarray, batch: int,
                     params: Optional[FarnebackParams] = None, dev="cuda") -> dict:
    """Amortised ms per frame of flow + detect at ``batch`` copies of the
    pair (the counterpart of ``bench.tpu_ms_per_frame``): ``"ms"`` from a
    replayed CUDA graph of the step (the host clock on the CPU),
    ``"eager_ms"`` the same step launched eagerly (CUDA events; the host
    clock on the CPU), ``"replays"`` the n the window took and ``"timer"``."""
    dev = resolve_device(dev)
    h, w = prev8.shape
    params = params or _params((h, w))
    gen = torch.Generator(device=dev).manual_seed(0)
    _, step = make_step(prev8, curr8, batch, params, dev, gen)
    run = replayer(step, dev, generators=(gen,))
    s, n = amortized(run, max(17 // batch, 3), 4096)
    eager = eager_ms(step, dev, EAGER_REPS, warm=1)
    return {"ms": s * 1e3 / batch, "eager_ms": eager / batch, "replays": n,
            "timer": "cuda graph" if dev.type == "cuda" else "host clock"}


def epe_check(prev8: np.ndarray, curr8: np.ndarray, gt_flow: np.ndarray,
              params: Optional[FarnebackParams] = None, oracle=None, dev="cuda"):
    """(EPE vs the cv2 oracle, EPE vs the analytic GT) of the port's flow
    on the 16-px interior; the first is None without ``oracle`` (an array or
    a ``.npy`` path of ``cv2.calcOpticalFlowFarneback``'s flow on the same
    pair). With it, an EPE vs cv2 of CV2_GATE_PX or more raises."""
    ours = farneback_flow(prev8, curr8, params or _params(prev8.shape), dev).cpu().numpy()
    epe_gt = epe_interior(ours, gt_flow)
    ref = oracle_flow(oracle, gt_flow.shape)
    if ref is None:
        return None, epe_gt
    epe_cv2 = epe_interior(ours, ref)
    if not epe_cv2 < CV2_GATE_PX:
        raise AssertionError(f"EPE vs cv2 oracle {epe_cv2:.4f} >= {CV2_GATE_PX} px gate")
    return epe_cv2, epe_gt


def detect_np(flow: np.ndarray):
    """``bench.py``'s numpy detection per frame (the baseline's, the
    reference's math): a 1000-pair FoE vote, then the 15-degree phi mask's
    pixel count."""
    h, w = flow.shape[:2]
    rng = np.random.default_rng(0)
    n = 1000
    ys = rng.integers(0, h, 2 * n)
    xs = rng.integers(0, w, 2 * n)
    f = flow[ys, xs]
    p = np.stack([xs, ys], 1).astype(np.float64)
    p1, f1, p2, f2 = p[:n], f[:n], p[n:], f[n:]
    x1, y1 = p1[:, 0], p1[:, 1]
    d1x, d1y = f1[:, 0], f1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    d2x, d2y = f2[:, 0], f2[:, 1]
    div = (-d1x) * (-d2y) - (-d1y) * (-d2x)
    ok = (np.abs(div) > 1e-12) & (np.hypot(d2x, d2y) > 2.5)
    da = x1 * (y1 + d1y) - y1 * (x1 + d1x)
    db = x2 * (y2 + d2y) - y2 * (x2 + d2x)
    px = np.where(ok, (da * -d2x - -d1x * db) / np.where(ok, div, 1), 0)
    py = np.where(ok, (da * -d2y - -d1y * db) / np.where(ok, div, 1), 0)
    pts = np.stack([px, py], 1)[ok]
    if len(pts):
        d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
        scores = (d < 30).sum(1)
        foe = pts[scores.argmax()]
    else:
        foe = np.zeros(2)
    xs_g, ys_g = np.meshgrid(np.arange(w), np.arange(h))
    ray = np.stack([xs_g - foe[0], ys_g - foe[1]], -1)
    mag = np.linalg.norm(flow, axis=-1)
    rmag = np.linalg.norm(ray, axis=-1)
    arg = (flow * ray).sum(-1) / np.maximum(1e-6, mag * rmag)
    phi = np.degrees(np.arccos(np.clip(arg, -1, 1)))
    return (phi * (mag > 1.0) > 15).sum()


def baseline_ms(prev8: np.ndarray, curr8: np.ndarray,
                cv2_flow: Optional[Callable] = None) -> Optional[float]:
    """ms per frame of ``cv2_flow`` then ``detect_np`` on the CPU (the
    counterpart of ``bench.cv2_baseline_ms``: 1 warm-up, 3 repetitions);
    None without ``cv2_flow``."""
    if cv2_flow is None:
        return None
    detect_np(cv2_flow(prev8, curr8))
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        detect_np(cv2_flow(prev8, curr8))
    return (time.perf_counter() - t0) / reps * 1e3


def device_reachable(dev, timeout_s: float = REACH_TIMEOUT_S) -> bool:
    """True iff a compile-free device op (a one-element sum pulled to the
    host) completes within ``timeout_s``. The probe runs in a daemon thread,
    because a hung device call cannot be interrupted; nothing that builds a
    kernel runs under the timeout."""
    dev = torch.device(dev)
    ok: list = []

    def probe() -> None:
        try:
            ok.append(float(torch.ones(1, device=dev).sum().item()))
        except Exception:
            ok.append(None)

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout_s)
    return bool(ok) and ok[0] is not None


def matmul_canary_s(dev) -> float:
    """Seconds per step of the chained CANARY_M^3 bf16 matmul, ``c = c @ b``
    then ``c / (max|c| + 1e-3)``, all on the device with no pull per step
    (``bench.py``'s canary): CANARY_CHAIN steps in one captured graph,
    replayed by ``amortized``."""
    m = CANARY_M
    dev = torch.device(dev)
    rng = np.random.default_rng(0)
    bmat = torch.as_tensor(rng.standard_normal((m, m)) / np.sqrt(m),
                           dtype=torch.float32).to(torch.bfloat16).to(dev)
    c = torch.as_tensor(rng.standard_normal((m, m)),
                        dtype=torch.float32).to(torch.bfloat16).to(dev)

    def chain() -> None:
        for _ in range(CANARY_CHAIN):
            d = c @ bmat
            c.copy_(d / (d.abs().amax() + 1e-3))

    s, _ = amortized(replayer(chain, dev), 4, 8192)
    return s / CANARY_CHAIN


def kernel_ms_per_iter(dev) -> float:
    """ms per frame per iteration of the bare ``farneback_iterate`` at the
    bench config: BATCH copies of the bench scene's first frame expanded
    (``poly_exp``), H x W, zero flow, the config's max_shift, winsize and
    iterations; a captured graph replayed by ``amortized`` (the plain
    version on the host clock on the CPU)."""
    p = _params()
    dev = torch.device(dev)
    tex = torch.as_tensor(scene(H, W, hires=False)[0], dtype=torch.float32).to(dev)
    R0 = poly_exp(tex[None], p.poly_n, p.poly_sigma).repeat(BATCH, 1, 1, 1).contiguous()
    R0p = R0 + 1e-6       # bench.py's R0 differs from R1 by its perturbation
    border = border_scale_map(H, W, dev)
    f0 = torch.zeros((BATCH, 2, H, W), dtype=torch.float32, device=dev)

    def call():
        return farneback_iterate(R0p, R0, f0, border, iterations=p.iterations,
                                 winsize=p.winsize, max_shift=p.max_shift)

    s, _ = amortized(replayer(call, dev), 4, 8192)
    return s / BATCH / p.iterations * 1e3


def chip_health_fields(dev) -> dict:
    """The chip's state inside the artifact, measured before any timing
    (``bench.py``'s canaries, the BENCH_r04 lesson: a sick chip read as a
    27x code regression): ``canary_matmul_tflops``, the matmul canary's
    rate (2 m^3 operations a step), and ``kernel_ms_per_iter``, the bare
    iterate kernel's ms per frame per iteration; ``chip_health`` is ``ok``
    iff both lie in this card's healthy bands (HEALTHY_TFLOPS_MIN,
    HEALTHY_KERNEL_MS_MAX). On the CPU neither is measured: both are None."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return {"canary_matmul_tflops": None, "kernel_ms_per_iter": None,
                "chip_health": "not measured (cpu: the canaries time a card)"}
    tflops = 2 * CANARY_M ** 3 / matmul_canary_s(dev) / 1e12
    ms_iter = kernel_ms_per_iter(dev)
    return {"canary_matmul_tflops": tflops, "kernel_ms_per_iter": ms_iter,
            "chip_health": health_verdict(tflops, ms_iter)}


def health_verdict(tflops: float, ms_iter: float) -> str:
    """``"ok"`` iff both canaries lie in their healthy bands, else a
    ``DEGRADED`` line that names both readings and bands."""
    if tflops >= HEALTHY_TFLOPS_MIN and ms_iter <= HEALTHY_KERNEL_MS_MAX:
        return "ok"
    return (f"DEGRADED (matmul {tflops:.0f} TFLOP/s, healthy>={HEALTHY_TFLOPS_MIN:.0f}; "
            f"kernel {ms_iter:.4f} ms/iter, healthy<={HEALTHY_KERNEL_MS_MAX:.4f}) — device "
            "timings in this artifact reflect the environment, not the code")


def host_fields() -> dict:
    """Host context for the cv2-CPU baseline denominator."""
    try:
        load = os.getloadavg()
    except OSError:  # pragma: no cover
        load = (float("nan"),) * 3
    return {"cpus": os.cpu_count(), "loadavg_1m": round(load[0], 2),
            "loadavg_5m": round(load[1], 2)}


def device_fields(dev) -> dict:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them; None for both on the
    CPU and wherever the query fails (no nvidia-smi, an error, a hang past
    60 s, output it cannot split): the bench never raises here."""
    dev = torch.device(dev)
    none = {"name": None, "power_limit": None}
    if dev.type != "cuda":
        return none
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={dev.index or 0}"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return none
    if "," not in out:
        return none
    name, limit = (v.strip() for v in out.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def hires_fields(dev, cv2_flow: Optional[Callable] = None):
    """(fields, timing): amortised flow + detect at the reference's native
    1920x1024 (HIRES_HW) and BATCH, on its hires scene; EPE vs the analytic
    GT (< HIRES_GATE_PX, raising), the baseline where ``cv2_flow`` is given,
    and the configuration that ran; ``timing`` is ``gpu_ms_per_frame``'s."""
    h, w = HIRES_HW
    prev8, curr8, gt = scene(h, w, hires=True)
    params = _params((h, w))
    base = baseline_ms(prev8, curr8, cv2_flow)
    t = gpu_ms_per_frame(prev8, curr8, BATCH, params, dev)
    epe_gt = epe_check(prev8, curr8, gt, params, None, dev)[1]
    if not epe_gt < HIRES_GATE_PX:
        raise AssertionError(f"hires EPE vs GT {epe_gt:.4f} >= {HIRES_GATE_PX} px gate")
    fps = 1e3 / t["ms"]
    return {"resolution": f"{w}x{h}", "fps_batch8": fps, "epe_gt": epe_gt,
            "vs_baseline": None if base is None else fps / (1e3 / base),
            "baseline_ms_per_frame": base,
            "config": {"batch": BATCH, "max_shift": params.max_shift,
                       **effective_fused_config(params, h, w, BATCH)}}, t


def main(argv=None, device=None, cv2_flow: Optional[Callable] = None) -> dict:
    ap = parser(__doc__)
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    # the probe first, as bench.py's: nothing else touches the card or
    # nvidia-smi before it
    reachable = device_reachable(dev)
    card = device_fields(dev)
    if not reachable:
        # the outage goes into the artifact instead of a hang: a null
        # headline with chip_health naming the cause
        res = {"metric": f"flow+detect throughput @{W}x{H} (batch {BATCH})",
               "value": None, "unit": "frames/sec/chip", "vs_baseline": None,
               "chip_health": (f"UNREACHABLE (no answer from {dev} in "
                               f"{REACH_TIMEOUT_S:.0f} s; this artifact records "
                               "the environment's state, not the code)"),
               "host": host_fields(), "device": card}
        print(dumps(res), flush=True)
        return res
    health = chip_health_fields(dev)   # first: certify the chip before timing
    prev8, curr8, gt = scene(H, W, hires=False)
    max_disp = float(np.abs(gt).max())
    p = _params()
    oracle = None if cv2_flow is None else cv2_flow(prev8, curr8)
    base = baseline_ms(prev8, curr8, cv2_flow)
    tb = gpu_ms_per_frame(prev8, curr8, BATCH, p, dev)
    t1 = gpu_ms_per_frame(prev8, curr8, 1, p, dev)
    epe_cv2, epe_gt = epe_check(prev8, curr8, gt, p, oracle, dev)
    hires, th = (hires_fields(dev, cv2_flow)
                 if os.environ.get("MAV_BENCH_HIRES", "1") != "0" else (None, None))

    fps_b, fps1 = 1e3 / tb["ms"], 1e3 / t1["ms"]
    # the headline is the product's configuration (batch 8, the Processor's
    # default), pinned; the single-stream figure is a field of its own
    res = {
        "metric": (f"flow+detect throughput @{W}x{H}, non-uniform flow "
                   f"(max {max_disp:.1f}px; EPE vs cv2 {fmt(epe_cv2)}px, vs GT "
                   f"{epe_gt:.3f}px; warp={p.warp}; headline=batch{BATCH}, "
                   f"single-stream {fps1:.1f} fps)"),
        "value": fps_b,
        "unit": "frames/sec/chip",
        "vs_baseline": None if base is None else fps_b / (1e3 / base),
        "fps_batch8": fps_b,
        "fps_single": fps1,
        "config": {"batch": BATCH, "warp": p.warp, "levels": p.levels,
                   "iterations": p.iterations, "level_iters": p.level_iters,
                   "max_shift": p.max_shift, "pyr_scale": p.pyr_scale,
                   "timer": tb["timer"], "replays": {"batch": tb["replays"],
                                                     "single": t1["replays"]},
                   **{k: v for k, v in effective_fused_config(p, H, W, BATCH).items()
                      if k != "warp"}},
        **health,
        "host": host_fields(),
        "hires": hires,
        "eager": {"fps_batch8": 1e3 / tb["eager_ms"], "fps_single": 1e3 / t1["eager_ms"],
                  "hires_fps_batch8": None if th is None else 1e3 / th["eager_ms"],
                  "timer": "cuda events" if dev.type == "cuda" else "host clock"},
        "device": card,
    }
    print(dumps(res), flush=True)
    return res


if __name__ == "__main__":
    result = main()
    if result["value"] is None:
        # skip interpreter teardown: the abandoned device call in the probe
        # thread can abort the process from its destructors otherwise
        sys.stdout.flush()
        os._exit(0)
