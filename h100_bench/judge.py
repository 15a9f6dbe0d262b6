"""The comparison that decides ``correct``.

Every cell hands the judge a sample of the frame pairs its window answered
(``Pair``): the inputs both sides got, and what the timed path produced for
the pair: its flow field (the Flow layer's output, recorded where it was
made) and its twelve per-frame scalars (the Detection step's output, a
FrameResult). The reference (``reference/``, plain float32, TF32 off)
works everything out again from the inputs alone, except where it reads the
program's outputs to judge them:

* ``flow_epe_px``: the Flow layer. The reference's flow from the pair's
  frames; per pair the mean end-point distance to the program's flow; the
  worst pair.
* ``foe_snap_px`` and ``foe_vote_gap``: the FoE vote. The reference's FoE
  candidates and their consensus scores from the program's flow (derotated,
  the same samples), as a served model's tokens are judged by the
  reference's logits over them. The program's FoE has to be one of those
  candidates (its distance to the nearest) and one of the best voted (its
  score's shortfall from the best, a share of the best); the worst pair.
* ``scalars_gap``: the rest of the Detection step. The reference's rates,
  sky rates, target area, mean GT flow and centre angle from the program's
  flow and FoE; per field the gap to the program's, as a share of
  max(1, |reference|), NaN against NaN none; the worst field and pair.
* ``missing``: pairs of the sample that never got an answer (or were
  never asked).

Each number has its limit in the cell's traffic file (``limits``).
"""
from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from h100_bench.reference import detect as ref_detect
from h100_bench.reference import farneback as ref_flow

NUMBERS = ("missing", "flow_epe_px", "foe_snap_px", "foe_vote_gap", "scalars_gap")
BATCH = 8
HUGE = 1e30      # stands for a gap without bound (one side NaN) in strict JSON


@dataclass
class Pair:
    """One frame pair as both sides got it, and the program's answer."""
    prev: np.ndarray          # (h, w) gray or (h, w, 3) BGR uint8
    curr: np.ndarray
    seg: torch.Tensor         # (h, w) uint8
    sky: torch.Tensor         # (h, w) bool
    depth: torch.Tensor       # (h, w) float32
    omega: Sequence[float]    # rad/s
    dt: float
    gt_foe: Sequence[float]   # (x, y), NaN where none
    sample_yx: torch.Tensor   # (2N, 2) int (y, x)
    flow: Optional[torch.Tensor] = None      # the program's (h, w, 2)
    # the program's, in ``pack_frame_scalars``'s order: foe x, y, tpr, fpr,
    # tpr_fixed, fpr_fixed, sky_tpr, sky_fpr, drone_size_pixels, drone flow
    # x, y, center_phi
    scalars: Optional[Sequence[float]] = None


def gray(img) -> torch.Tensor:
    """BT.601 BGR -> gray as the cameras' frames are converted (float32,
    rounded), or the frame itself where it is gray already."""
    a = np.asarray(img)
    if a.ndim == 2:
        return torch.from_numpy(np.ascontiguousarray(a))
    x = a.astype(np.float32)
    g = 0.114 * x[..., 0] + 0.587 * x[..., 1] + 0.299 * x[..., 2]
    return torch.from_numpy(np.round(g).astype(np.uint8))


def _finite_gap(a: float, b: float, scale: float) -> float:
    if math.isnan(a) and math.isnan(b):
        return 0.0
    if not (math.isfinite(a) and math.isfinite(b)):
        return HUGE
    return abs(a - b) / scale


def judge(pairs: List[Optional[Pair]], flow_params: Mapping, num_samples: int,
          device: torch.device) -> Dict[str, float]:
    """The numbers compared, over ``pairs`` (None: a pair of the sample
    that was never asked)."""
    dev = torch.device(device)
    out = {k: 0.0 for k in NUMBERS}
    answered = [p for p in pairs
                if p is not None and p.flow is not None and p.scalars is not None]
    out["missing"] = float(len(pairs) - len(answered))
    if not answered:       # nothing answered, or nothing to judge: not correct
        out["missing"] = max(out["missing"], 1.0)
        return out
    for b0 in range(0, len(answered), BATCH):
        batch = answered[b0:b0 + BATCH]
        prev = torch.stack([gray(p.prev) for p in batch]).to(dev)
        curr = torch.stack([gray(p.curr) for p in batch]).to(dev)
        ref = ref_flow.flow(prev, curr, flow_params)
        prog = torch.stack([p.flow.to(dev, torch.float32) for p in batch])
        epe = torch.linalg.vector_norm(prog - ref, dim=-1).mean(dim=(1, 2))
        out["flow_epe_px"] = max(out["flow_epe_px"], float(epe.max()))
        del ref, prev, curr

        omega = torch.tensor([list(p.omega) for p in batch], dtype=torch.float32, device=dev)
        dt = torch.tensor([p.dt for p in batch], dtype=torch.float32, device=dev)
        syx = torch.stack([p.sample_yx for p in batch]).to(dev)
        fd = ref_detect.derotate(prog, omega, dt)
        pts, valid, scores = ref_detect.candidates(fd, syx, num_samples)
        foe = torch.tensor([[p.scalars[0], p.scalars[1]] for p in batch],
                           dtype=torch.float32, device=dev)
        best = scores.max(dim=1).values
        own = ref_detect.score_points(foe[:, None], pts, valid)[:, 0]
        is_cand = ((pts == foe[:, None]).all(-1) & valid).any(dim=1)
        own = own - is_cand.to(own.dtype)
        d = torch.where(valid, torch.linalg.vector_norm(pts - foe[:, None], dim=-1),
                        torch.full_like(valid, float("inf"), dtype=torch.float32))
        for j in range(len(batch)):
            if float(best[j]) > 0:
                snap = float(d[j].min())
                gap = max(0.0, float(best[j] - own[j])) / float(best[j])
            else:     # no vote: the FoE is (0, 0)
                snap = float(torch.linalg.vector_norm(foe[j]))
                gap = 0.0 if snap == 0.0 else 1.0
            out["foe_snap_px"] = max(out["foe_snap_px"], snap)
            out["foe_vote_gap"] = max(out["foe_vote_gap"], gap)

        sc = ref_detect.scalars(
            prog, torch.zeros_like(prog), omega, dt,
            torch.stack([p.seg for p in batch]).to(dev),
            torch.stack([p.sky for p in batch]).to(dev),
            torch.stack([p.depth for p in batch]).to(dev),
            torch.tensor([list(p.gt_foe) for p in batch], dtype=torch.float32, device=dev),
            syx, num_samples, foe=foe)
        cols = [sc["tpr"], sc["fpr"], sc["tpr_fixed"], sc["fpr_fixed"], sc["sky_tpr"],
                sc["sky_fpr"], sc["drone_size_pixels"], sc["drone_flow_pixels"][:, 0],
                sc["drone_flow_pixels"][:, 1], sc["center_phi"]]
        ref_rows = torch.stack(cols, dim=1).cpu().numpy().astype(np.float64)
        for j, p in enumerate(batch):
            for k, r in enumerate(ref_rows[j]):
                a = float(p.scalars[k + 2])
                scale = 1.0 if not math.isfinite(r) else max(1.0, abs(float(r)))
                out["scalars_gap"] = max(out["scalars_gap"], _finite_gap(a, float(r), scale))
    return {k: (HUGE if not math.isfinite(v) else v) for k, v in out.items()}


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]):
    """(correct, {name: {"value", "limit"}}): correct iff every number is
    at or under its limit. The lines go to standard error, last."""
    checked = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(numbers[k] <= limits[k] for k in NUMBERS)
    return ok, checked


def say(checked: Mapping[str, Mapping[str, float]], ok: bool) -> None:
    print(f"correct {str(ok).lower()}", file=sys.stderr)
    for k, v in checked.items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
