"""Focus-of-Expansion estimation (``mav_detection_tpu.ops.geometry.foe``).

The dense half (``line_intersections``, ``foe_ransac``, ``get_foe_dense``,
``get_phi``) is batched over a leading frame axis. The sparse half
(``get_foe_sparse``, the ``TraceState`` ring and ``get_foe_sparse_traced``)
works on one frame's tracks, as the reference's does. A random partner
pairing cannot match across frameworks, so the sparse functions take the
permutation itself (``perm``); without one the pairing is the deterministic
roll.

Default constants are upstream's: N=1000 samples, magnitude gate 2.5 px,
inlier radius 30 px.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

MAGNITUDE_THRESHOLD = 2.5
RANSAC_THRESHOLD = 30.0
NUM_SAMPLES = 1000
TRACE_ROLLBACK = 20


def line_intersections(p1: torch.Tensor, d1: torch.Tensor, p2: torch.Tensor,
                       d2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intersect line (p1, p1+d1) with line (p2, p2+d2) elementwise over the
    leading axes; returns (points (..., 2), valid (...)). Parallel lines are
    invalid with point (0, 0)."""
    a1, b1 = p1, p1 + d1
    a2, b2 = p2, p2 + d2
    xdiff = torch.stack([a1[..., 0] - b1[..., 0], a2[..., 0] - b2[..., 0]], -1)
    ydiff = torch.stack([a1[..., 1] - b1[..., 1], a2[..., 1] - b2[..., 1]], -1)

    def det(a, b):
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]

    div = det(xdiff, ydiff)
    d = torch.stack([det(a1, b1), det(a2, b2)], -1)
    valid = div != 0
    safe_div = torch.where(valid, div, torch.ones_like(div))
    x = det(d, xdiff) / safe_div
    y = det(d, ydiff) / safe_div
    pts = torch.stack([x, y], -1)
    pts = torch.where(valid[..., None], pts, torch.zeros_like(pts))
    return pts, valid


def foe_ransac(estimates: torch.Tensor, valid: torch.Tensor,
               threshold: float = RANSAC_THRESHOLD) -> torch.Tensor:
    """Consensus vote over candidate FoE points, (n, N, 2) -> (n, 2).

    Each valid candidate counts the other valid estimates within
    ``threshold`` px (self excluded); the first candidate with the highest
    strictly-positive score wins, else (0, 0)."""
    diff = estimates[:, :, None, :] - estimates[:, None, :, :]
    dist = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    pair_ok = valid[:, None, :] & (dist < threshold)
    scores = pair_ok.sum(dim=2) - 1
    scores = torch.where(valid, scores, torch.full_like(scores, -1))
    best = torch.argmax(scores, dim=1)            # first maximum
    best_score = scores.gather(1, best[:, None])[:, 0]
    pick = estimates.gather(1, best[:, None, None].expand(-1, 1, 2))[:, 0]
    return torch.where((best_score > 0)[:, None], pick, torch.zeros_like(pick))


def sample_points(n: int, num_samples: int, h: int, w: int,
                  generator: Optional[torch.Generator],
                  device: torch.device) -> torch.Tensor:
    """(n, 2*num_samples, 2) uniform (y, x) pixel indices."""
    ys = torch.randint(0, h, (n, 2 * num_samples), generator=generator,
                       device=device)
    xs = torch.randint(0, w, (n, 2 * num_samples), generator=generator,
                       device=device)
    return torch.stack([ys, xs], -1)


def get_foe_dense(flow_uv: torch.Tensor, sample_yx: torch.Tensor,
                  num_samples: int = NUM_SAMPLES,
                  magnitude_threshold: float = MAGNITUDE_THRESHOLD,
                  ransac_threshold: float = RANSAC_THRESHOLD) -> torch.Tensor:
    """Dense-flow FoE (n, 2): sample flow-line pairs at ``sample_yx``
    ((n, 2*num_samples, 2) int (y, x)), intersect, consensus-vote."""
    n = flow_uv.shape[0]
    ys = sample_yx[..., 0].long()
    xs = sample_yx[..., 1].long()
    bi = torch.arange(n, device=flow_uv.device)[:, None]
    flows = flow_uv[bi, ys, xs]                      # (n, 2N, 2)
    coords = torch.stack([xs, ys], -1).to(flow_uv.dtype)

    p1, f1 = coords[:, :num_samples], flows[:, :num_samples]
    p2, f2 = coords[:, num_samples:], flows[:, num_samples:]

    # upstream gates on the *second* line's magnitude only
    mag2 = torch.sqrt(f2[..., 0] * f2[..., 0] + f2[..., 1] * f2[..., 1])
    gate = mag2 >= magnitude_threshold

    pts, parallel_ok = line_intersections(p1, f1, p2, f2)
    # upstream drops rows with x == 0.0 (its "invalid" sentinel)
    valid = gate & parallel_ok & (pts[..., 0] != 0.0)
    pts = torch.where(valid[..., None], pts, torch.zeros_like(pts))
    return foe_ransac(pts, valid, ransac_threshold)


def _partner_lines(cur: torch.Tensor, d: torch.Tensor, valid: torch.Tensor,
                   perm: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pick one partner motion line per track for intersection.

    Upstream pairs each line with an iid-uniform random line, possibly
    itself, which intersects as parallel and is dropped. A permutation
    ``perm`` ((N,) indices) has the same marginal (uniform partner), no
    partner collisions, and its fixed points degrade exactly like
    upstream's self-picks (parallel -> invalid). Without one the pairing is
    the deterministic rolled derangement (reproducible pipelines and tests).
    """
    if perm is None:
        idx = torch.roll(torch.arange(cur.shape[0], device=cur.device), 1)
    else:
        idx = torch.as_tensor(perm, device=cur.device).long()
    return cur[idx], d[idx], valid[idx]


def _vote(cur, d, valid, perm, ransac_threshold) -> torch.Tensor:
    """Intersect each valid motion line (through ``cur`` along ``-d``) with
    its partner's and take the consensus vote: (N, 2) -> (2,)."""
    # the partner must pass the SAME gate: a near-stationary partner line is
    # noise-dominated and its intersection must not vote
    p2, d2, v2 = _partner_lines(cur, d, valid, perm)
    pts, ok = line_intersections(cur, -d, p2, -d2)
    ok = ok & valid & v2
    pts = torch.where(ok[..., None], pts, torch.zeros_like(pts))
    return foe_ransac(pts[None], ok[None], ransac_threshold)[0]


def get_foe_sparse(points_old: torch.Tensor, points_new: torch.Tensor,
                   valid: torch.Tensor,
                   ransac_threshold: float = RANSAC_THRESHOLD,
                   perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sparse-track FoE (2,): each valid track (old -> new) that moved more
    than 0.5 px defines a motion line; each line is intersected with a
    partner line (see ``_partner_lines``) and the same consensus vote as the
    dense path picks the FoE. Fixed shapes; invalid tracks are masked out
    rather than filtered."""
    d = points_new - points_old
    moving = valid & (torch.linalg.norm(d, dim=-1) > 0.5)
    return _vote(points_new, d, moving, perm, ransac_threshold)


# ------------------------------------------------------------ trace history
class TraceState(NamedTuple):
    """Fixed-capacity per-track position history (functional ring buffer).

    Upstream's LK trace lists with ``ROLLBACK`` frames of history: the
    sparse FoE intersects each track's CURRENT motion against its position
    up to ``rollback`` frames ago; a long baseline makes the motion lines far
    better conditioned than one-frame displacements. Tracks replaced by LK
    replenishment restart their age; surviving tracks keep their history.

    Shapes: positions (T, N, 2); alive (T, N); age (N,) int32; head is the
    ring slot written last, a plain int (it never depends on device data).
    """
    positions: torch.Tensor
    alive: torch.Tensor
    age: torch.Tensor
    head: int


def trace_init(num_tracks: int, capacity: int = TRACE_ROLLBACK + 1,
               device: torch.device = torch.device("cpu")) -> TraceState:
    return TraceState(
        positions=torch.zeros((capacity, num_tracks, 2), dtype=torch.float32,
                              device=device),
        alive=torch.zeros((capacity, num_tracks), dtype=torch.bool, device=device),
        # age = frames of history available; -1 so the first push lands at 0
        age=torch.full((num_tracks,), -1, dtype=torch.int32, device=device),
        head=-1,
    )


def trace_update(state: TraceState, points: torch.Tensor, valid: torch.Tensor,
                 new_track: torch.Tensor) -> TraceState:
    """Push one frame of track positions into the ring (the buffers are
    copied: the old state stays valid, as the reference's does).

    ``valid`` marks tracks alive this frame; ``new_track`` marks pool slots
    that replenishment just re-seeded (their age restarts, severing the old
    trace)."""
    cap = state.positions.shape[0]
    head = (state.head + 1) % cap
    positions = state.positions.clone()
    positions[head] = points.to(torch.float32)
    alive = state.alive.clone()
    alive[head] = valid
    zero = torch.zeros_like(state.age)
    age = torch.where(new_track, zero, torch.where(valid, state.age + 1, zero))
    return TraceState(positions=positions, alive=alive, age=age, head=head)


def get_foe_sparse_traced(state: TraceState, rollback: int = TRACE_ROLLBACK,
                          ransac_threshold: float = RANSAC_THRESHOLD,
                          min_baseline: float = 0.5,
                          perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sparse FoE from trace history: per track, intersect the motion line
    (position ``min(rollback, age)`` frames ago -> current position) with a
    partner line, then the standard consensus vote."""
    cap, n = state.alive.shape
    head = state.head % cap
    cur = state.positions[head]                 # (N, 2)
    cur_ok = state.alive[head]

    # per-track rollback clamped by age (and ring capacity)
    rb = torch.clamp(state.age, max=min(rollback, cap - 1)).long()   # (N,)
    idx = (head - rb) % cap                     # (N,) ring index per track
    lane = torch.arange(n, device=cur.device)
    old = state.positions[idx, lane]
    old_ok = state.alive[idx, lane]

    d = cur - old
    valid = (cur_ok & old_ok & (rb > 0)
             & (torch.linalg.norm(d, dim=-1) > min_baseline))
    return _vote(cur, d, valid, perm, ransac_threshold)


def get_phi(derotated_flow_uv: torch.Tensor, foe: torch.Tensor) -> torch.Tensor:
    """Per-pixel angle (degrees) between the flow vector and the ray from the
    FoE, (n, h, w, 2) x (n, 2) -> (n, h, w): arccos of the normalized dot
    product with a 1e-6 norm floor and [-1, 1] clipping."""
    _, h, w, _ = derotated_flow_uv.shape
    dev = derotated_flow_uv.device
    x_coords = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    y_coords = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]

    diff1 = derotated_flow_uv
    ray_x = x_coords - foe[:, 0, None, None]
    ray_y = y_coords - foe[:, 1, None, None]

    flow_magnitude = torch.sqrt(diff1[..., 0] * diff1[..., 0]
                                + diff1[..., 1] * diff1[..., 1])
    img_distance = torch.sqrt(ray_x * ray_x + ray_y * ray_y)
    norm = torch.clamp(flow_magnitude * img_distance, min=1e-6)

    arccos_arg = (diff1[..., 0] * ray_x + diff1[..., 1] * ray_y) / norm
    arccos_arg = torch.clamp(arccos_arg, -1.0, 1.0)
    angle = torch.nan_to_num(torch.arccos(arccos_arg))
    return angle * (180.0 / math.pi)
