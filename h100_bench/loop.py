"""The product loop: ``Processor.run_detection_foe`` over whole sequences,
back to back (closed loop, one client), on the batch or the scan engine.

A ring of ``seq_frames + ring_extra`` consecutive frames of the scene is
rendered on the card once and kept on the host as a camera's frames would
arrive (BGR uint8, the segmentation, the sky estimate, depth where the
configuration has it). Sequence k is a ``RingDataset`` view of
``seq_frames`` of them from an offset drawn from the seed; a new
``Processor`` (the product's flow configuration, FARNEBACK, ``save_images``
off, FrameResult JSON under the run's temporary directory, as the CLI
writes it) runs it with FoE sample draws from the seed (``sample_yx``).

The window starts whole sequences until ``--seconds`` have passed (and at
least ``min_seqs``); the last one runs to its end. ``frames_per_s``: pairs
with a FrameResult over the seconds from the first sequence's start to the
last one's return. ``seq_s_p95``: the 95th percentile of one call's
seconds over every sequence of the window.

The judge's sample: ``check_seqs`` of the first ``min_seqs`` sequences,
drawn from the seed, and in each the pairs of ``check_calls`` flow calls
(batches on the batch engine, the last batch of the first sequence among
them; transitions on the scan engine). The flow of those calls is recorded
where the program makes it: the Processor's module-level flow function is
wrapped for the run by one that keeps a device copy of the sampled calls'
output. Where a control is given, its flow and detection functions take the
program's place underneath.
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from h100_bench import scene
from h100_bench.judge import Pair
from mav_detection_tpu_torch.core.config import FlowSource, RunConfig
from mav_detection_tpu_torch.pipeline import processor as processor_mod
from mav_detection_tpu_torch.pipeline import temporal as temporal_mod
from mav_detection_tpu_torch.pipeline.processor import Processor

POOL = 16          # FoE draw sets, drawn at set-up and cycled over sequences


class Ring:
    """The host copy of the rendered frames."""

    def __init__(self, config: Dict, n: int, seed: int, device: torch.device) -> None:
        sc = scene.render(dict(config["scene"], height=config["height"],
                               width=config["width"]), n, seed, device)
        self.h, self.w = int(config["height"]), int(config["width"])
        self.bgr = sc["bgr"].cpu().numpy()
        self.seg = sc["seg"].cpu().numpy()
        self.sky = sc["sky"].cpu().numpy()
        self.depth = sc["depth"].cpu().numpy() if config["depth"] else None
        self.omega = (sc["omega"].cpu().numpy() if config["imu"]
                      else np.zeros((n, 3), np.float32))
        self.foe = tuple(sc["foe"].tolist()) if config["gt_foe"] else None
        self.dt = float(sc["dt"])
        self.n = n


class RingDataset:
    """The program's dataset interface over ``n`` frames of the ring from
    ``offset``: frames as they come from a camera, its segmentation, sky
    estimate, depth (None where the configuration has none), IMU rotation,
    no GT flow."""

    def __init__(self, ring: Ring, offset: int, n: int, seq_path: str) -> None:
        self.ring, self.off = ring, offset
        self.N = n
        self.capture_shape = (ring.h, ring.w, 3)
        self.capture_size = (ring.w, ring.h)
        self.resolution = np.array([ring.w, ring.h])
        self.start_frame = 0
        self.sequence = "h100_bench"
        self.seq_path = seq_path
        self.results_path = os.path.join(seq_path, "results")
        self.result_imgs_path = os.path.join(seq_path, "result-images")
        self.device = None

    def get_frame(self, i: int) -> np.ndarray:
        return self.ring.bgr[self.off + i]

    def get_segmentation(self, i: int) -> np.ndarray:
        seg = self.ring.seg[self.off + i]
        return np.broadcast_to(seg[..., None], seg.shape + (3,))

    def get_sky_segmentation(self, i: int) -> np.ndarray:
        return self.ring.sky[self.off + i]

    def get_depth(self, i: int) -> Optional[np.ndarray]:
        return self.ring.depth

    def get_gt_foe(self, i: int):
        return self.ring.foe

    def get_gt_of(self, i: int):
        return None

    def has_precomputed_flow(self) -> bool:
        return False

    def get_angular_difference(self, first: int, second: int) -> np.ndarray:
        return self.ring.omega[self.off + first] * self.ring.dt

    def get_delta_time(self, i: int) -> float:
        return self.ring.dt

    def get_time(self, i: int) -> float:
        return (self.off + i) * self.ring.dt

    def get_annotation(self, i: int, ann_path=None) -> list:
        return []

    def release(self) -> None:
        pass


class Recorder:
    """Wraps the program's flow function: counts its calls per sequence and
    keeps a device copy of the output of the planned (sequence, call)s."""

    def __init__(self, plan: Set[Tuple[int, int]], control=None) -> None:
        self.plan, self.control = plan, control
        self.seq, self.call = -1, 0
        self.kept: Dict[Tuple[int, int], torch.Tensor] = {}
        self._saved: List[Tuple[object, str, object]] = []

    def begin(self, seq: int) -> None:
        self.seq, self.call = seq, 0

    def _patch(self, mod, name: str, fn) -> None:
        self._saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def install(self) -> None:
        for mod in (processor_mod, temporal_mod):
            self._patch(mod, "_farneback_cf", self._wrap(mod._farneback_cf))
        if self.control is not None:
            self._patch(processor_mod, "detect_frame_batch_scalars", self.control.detect)
            self._patch(temporal_mod, "detect_frame_batch", self.control.detect)

    def uninstall(self) -> None:
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved.clear()

    def _wrap(self, orig):
        def recorded(prev, curr, params):
            if self.control is not None:
                flow = self.control.flow(prev, curr)
            else:
                flow = orig(prev, curr, params)
            key = (self.seq, self.call)
            if key in self.plan:
                self.kept[key] = flow.detach().clone()
            self.call += 1
            return flow
        return recorded


def _draws(rng: np.random.Generator, engine: str, n_pairs: int, batch: int,
           N: int, h: int, w: int):
    """One sequence's FoE sample indices, as ``run_detection_foe`` takes
    them: per batch (batch, 2N, 2) on the batch engine, (n_pairs, 2N, 2) on
    the scan engine; int32 (y, x)."""
    if engine == "scan":
        shape = (n_pairs, 2 * N)
    else:
        shape = (-(-n_pairs // batch), batch, 2 * N)
    yx = np.stack([rng.integers(0, h, shape, dtype=np.int32),
                   rng.integers(0, w, shape, dtype=np.int32)], -1)
    return yx if engine == "scan" else list(yx)


def prepare(run, engine: str) -> None:
    cfg, p, dev = run.config, run.params, run.device
    n = int(cfg["sequence_frames"])
    B = int(p["batch"])
    N = int(cfg["foe_samples"])
    ring = Ring(cfg, n + int(p["ring_extra"]), run.seed, dev)
    rng = np.random.default_rng([run.seed, 1])
    pool = [_draws(rng, engine, n - 1, B, N, ring.h, ring.w) for _ in range(POOL)]
    min_seqs = int(p["min_seqs"])
    seqs = sorted(int(v) for v in rng.choice(min_seqs, size=int(p["check_seqs"]),
                                             replace=False))
    calls_per_seq = n - 1 if engine == "scan" else -(-(n - 1) // B)
    plan: Set[Tuple[int, int]] = set()
    for k, s in enumerate(seqs):
        picks = rng.choice(calls_per_seq, size=int(p["check_calls"]), replace=False)
        plan |= {(s, int(c)) for c in picks}
        if k == 0 and engine != "scan":
            plan.add((s, calls_per_seq - 1))     # the padded tail batch
    rec = Recorder(plan, run.control)
    rec.install()
    seq_path = os.path.join(tempfile.gettempdir(), "h100_bench", run.cell)
    config = RunConfig(dataset="synthetic", flow_source=FlowSource.FARNEBACK,
                       batch_size=B, foe_samples=N, engine=engine)
    st = run.state
    st.update(ring=ring, pool=pool, rec=rec, seq_path=seq_path, config=config,
              engine=engine, n=n, batch=B, seqs=seqs, results={}, next=0,
              offsets=np.random.default_rng([run.seed, 2]))
    run.counters.update(pairs=0, stage_host_s=0.0, scan_stage_s=0.0)
    # warm-up: one whole sequence, uncounted (every shape the window uses)
    _sequence(run, -1, count=False)


def _sequence(run, k: int, count: bool = True) -> Tuple[float, int]:
    """Runs sequence ``k`` (its offset the next drawn); (seconds of the
    call, pairs answered)."""
    st = run.state
    ring, n = st["ring"], st["n"]
    off = int(st["offsets"].integers(0, ring.n - n + 1))
    ds = RingDataset(ring, off, n, st["seq_path"])
    proc = Processor(st["config"], device=run.device, dataset=ds)
    proc.save_images = False
    st["rec"].begin(k)
    t0 = time.perf_counter()
    results = proc.run_detection_foe(sample_yx=st["pool"][k % POOL])
    secs = time.perf_counter() - t0
    if k in st["seqs"]:
        st["results"][k] = (off, k % POOL, dict(results))
    if count:
        run.counters["pairs"] += n - 1
        run.counters["stage_host_s"] += proc._stage_host_seconds
        run.counters["scan_stage_s"] += proc.tracer.totals.get("stage", 0.0)
    return secs, len(results)


def window(run) -> dict:
    st = run.state
    times: List[float] = []
    answered = attempted = 0
    t_first = time.perf_counter()
    k = 0
    while True:
        secs, got = _sequence(run, k)
        times.append(secs)
        attempted += st["n"] - 1
        answered += got
        k += 1
        if time.perf_counter() - t_first >= run.seconds and k >= int(run.params["min_seqs"]):
            break
    wall = time.perf_counter() - t_first
    st["next"] = k
    return {"attempted": attempted, "failed": attempted - answered,
            "metrics": {"frames_per_s": answered / wall,
                        "seq_s_p95": float(np.percentile(times, 95)),
                        "sequences": k}}


def traced(run) -> None:
    """``trace_seqs`` more whole sequences (a steady slice, after the
    window); their counters are not the window's."""
    st = run.state
    for _ in range(int(run.params["trace_seqs"])):
        _sequence(run, st["next"], count=False)
        st["next"] += 1


def pairs(run) -> List[Optional[Pair]]:
    st = run.state
    ring, n, B = st["ring"], st["n"], st["batch"]
    scan = st["engine"] == "scan"
    out: List[Optional[Pair]] = []
    for (k, call) in sorted(st["rec"].plan):
        if k not in st["results"]:      # a planned sequence that never ran
            out.append(None)
            continue
        off, pool_k, results = st["results"][k]
        flow = st["rec"].kept.get((k, call))
        lanes = [call] if scan else [call * B + j for j in range(B) if call * B + j < n - 1]
        for lane, i in enumerate(lanes):
            draws = st["pool"][pool_k]
            syx = draws[i] if scan else draws[call][lane]
            fr = results.get(i)
            scal = None if fr is None else [
                fr.foe_dense[0], fr.foe_dense[1], fr.tpr, fr.fpr, fr.tpr_fixed,
                fr.fpr_fixed, fr.sky_tpr, fr.sky_fpr, fr.drone_size_pixels,
                fr.drone_flow_pixels[0], fr.drone_flow_pixels[1], fr.center_phi]
            f = None if flow is None else flow[lane]
            g = off + i
            out.append(Pair(
                prev=ring.bgr[g], curr=ring.bgr[g + 1],
                seg=torch.from_numpy(ring.seg[g]), sky=torch.from_numpy(ring.sky[g]),
                depth=torch.from_numpy(ring.depth if ring.depth is not None
                                       else np.ones((ring.h, ring.w), np.float32)),
                omega=ring.omega[g].tolist(), dt=ring.dt,
                gt_foe=list(ring.foe) if ring.foe is not None else [float("nan")] * 2,
                sample_yx=torch.from_numpy(np.asarray(syx)), flow=f, scalars=scal))
    return out


def release(run) -> None:
    st = run.state
    st["rec"].uninstall()
