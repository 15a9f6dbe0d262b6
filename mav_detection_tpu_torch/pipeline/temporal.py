"""Temporal frame engine: the detection step over a whole sequence with
carried state (``mav_detection_tpu.pipeline.temporal.detect_sequence_scan``).

The reference compiles the sequence into one ``lax.scan``. Here the scan is a
Python loop on one stream: every transition enqueues the Farneback solver and
the fused detection step on the frames' device and writes its scalars into
preallocated (T-1, ...) tensors, so the host never waits for the device
inside the dense loop (no ``.item()``, no ``.cpu()``, no truth value of a
tensor). The carried state is the previous frame and the ``FlowHistory``
ring; with ``track_sparse`` also the Lucas-Kanade ``FeaturePool`` and the
sparse-FoE ``TraceState`` ring. Corner replenishment then keeps the looks of
its greedy sweep (one per ``SWEEP_ROUNDS`` rounds, see
``ops/flow/lucas_kanade.py``).

The reference's PRNG key becomes explicit draws: ``sample_yx`` for the dense
vote and ``sparse_perm`` for the sparse vote's partner pairing; without them
one ``torch.Generator`` on the device, seeded once, gives both.

The time-chunked variant (``detect_video_chunked``) splits the sequence
over the ranks of a process group: each rank scans a contiguous time chunk,
the first transition of a chunk fed by its left neighbour's last frame.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mav_detection_tpu_torch.ops.flow.farneback import (
    FarnebackParams,
    _farneback_cf,
)
from mav_detection_tpu_torch.ops.flow.lucas_kanade import (
    FeaturePool,
    lucas_kanade_track,
    replenish_features,
)
from mav_detection_tpu_torch.ops.geometry.boxsearch import (
    FlowHistory,
    make_flow_history,
)
from mav_detection_tpu_torch.ops.geometry.foe import (
    get_foe_sparse_traced,
    sample_points,
    trace_init,
    trace_update,
)
from mav_detection_tpu_torch.pipeline.detector import (
    DetectionStep,
    FrameScalars,
    _to_scalars,
    detect_frame_batch,
    pack_frame_scalars,
    unpack_frame_scalars,
)

# seed of the generator that draws when the caller passes no draws
SCAN_SEED = 0


def _flow_pair(prev: torch.Tensor, curr: torch.Tensor,
               params: FarnebackParams) -> torch.Tensor:
    """(h, w) x2 -> (h, w, 2): batch 1 of the channel-first solver."""
    return _farneback_cf(prev[None], curr[None], params)[0]


def detect_sequence_scan(
    frames: torch.Tensor,         # (T, h, w) grayscale sequence, any real dtype
    omegas: torch.Tensor,         # (T, 3) angular difference per transition
    dts: torch.Tensor,            # (T,)
    segmentations: torch.Tensor,  # (T, h, w) uint8
    sky_masks: torch.Tensor,      # (T, h, w) bool
    depths: torch.Tensor,         # (T, h, w)
    gt_foes: torch.Tensor,        # (T, 2)
    sample_yx: Optional[torch.Tensor] = None,
    params: FarnebackParams = FarnebackParams(warp="separable", fast=True),
    config: DetectionStep = DetectionStep(),
    history_len: int = 4,
    track_sparse: bool = False,
    n_tracks: int = 256,
    sparse_perm: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Run the detection step over the T-1 frame transitions with carried
    state, on the device the tensors lie on.

    Element t of every input describes transition (t-1, t); element 0 of the
    aux inputs is not read. Returns the per-transition ``FrameScalars``
    (leading axis T-1) and the final ``FlowHistory``; with ``track_sparse``
    also the (T-1, 2) trace-based sparse FoE.

    ``sample_yx``: (T-1, 2N, 2) (y, x) sample indices of the dense vote, N =
    ``config.foe_samples``. ``sparse_perm``: (T-1, n_tracks) partner
    permutations of the sparse vote. Either left out is drawn from
    ``generator`` (made on the device and seeded with ``SCAN_SEED`` when none
    is given).

    The flow history is written in place into one buffer that this call
    allocates (the reference copies the ring every step)."""
    T, h, w = frames.shape
    dev = frames.device
    n_trans = T - 1
    if generator is None and (sample_yx is None
                              or (track_sparse and sparse_perm is None)):
        generator = torch.Generator(device=dev)
        generator.manual_seed(SCAN_SEED)
    if sample_yx is None:
        sample_yx = sample_points(n_trans, config.foe_samples, h, w,
                                  generator, dev)
    elif tuple(sample_yx.shape) != (n_trans, 2 * config.foe_samples, 2):
        raise ValueError(
            f"sample_yx: shape {tuple(sample_yx.shape)} != "
            f"{(n_trans, 2 * config.foe_samples, 2)}")
    if track_sparse and sparse_perm is not None and \
            tuple(sparse_perm.shape) != (n_trans, n_tracks):
        raise ValueError(f"sparse_perm: shape {tuple(sparse_perm.shape)} != "
                         f"{(n_trans, n_tracks)}")

    prev = frames[0].to(torch.float32)
    history = make_flow_history(history_len, h, w, dev)
    buffer, index = history.buffer, history.index
    if track_sparse:
        pool = replenish_features(
            FeaturePool(torch.zeros((n_tracks, 2), dtype=torch.float32,
                                    device=dev),
                        torch.zeros((n_tracks,), dtype=torch.bool, device=dev)),
            prev, max_corners=n_tracks)
        tstate = trace_update(
            trace_init(n_tracks, device=dev), pool.points, pool.valid,
            torch.zeros((n_tracks,), dtype=torch.bool, device=dev))
        foe_sparse = torch.empty((n_trans, 2), dtype=torch.float32, device=dev)
    gt_flow = torch.zeros((1, h, w, 2), dtype=torch.float32, device=dev)

    out: Optional[FrameScalars] = None
    for t in range(1, T):
        # one frame converted per step, not the whole sequence up front
        curr = frames[t].to(torch.float32)
        flow = _flow_pair(prev, curr, params)
        buffer[index] = flow
        index = (index + 1) % history_len
        step = _to_scalars(detect_frame_batch(
            flow[None], gt_flow, omegas[t:t + 1], dts[t:t + 1],
            segmentations[t:t + 1], sky_masks[t:t + 1], depths[t:t + 1],
            gt_foes[t:t + 1], sample_yx=sample_yx[t - 1:t], config=config))
        if out is None:
            out = FrameScalars(*(
                torch.empty((n_trans,) + tuple(x.shape[1:]), dtype=x.dtype,
                            device=dev) for x in step))
        for dst, src in zip(out, step):
            dst[t - 1] = src[0]
        if track_sparse:
            # track the pool, refill dead slots from fresh corners (only
            # invalid slots change), push into the trace ring, intersect the
            # rolled-back motion lines
            tracks = lucas_kanade_track(prev, curr, pool.points)
            alive = pool.valid & tracks.status
            pool = replenish_features(FeaturePool(tracks.points, alive), curr,
                                      max_corners=n_tracks)
            tstate = trace_update(tstate, pool.points, pool.valid,
                                  ~alive & pool.valid)
            perm = (torch.randperm(n_tracks, generator=generator, device=dev)
                    if sparse_perm is None else sparse_perm[t - 1])
            foe_sparse[t - 1] = get_foe_sparse_traced(tstate, perm=perm)
        prev = curr

    if out is None:      # a one-frame sequence has no transition
        z = torch.zeros((0,), dtype=torch.float32, device=dev)
        z2 = torch.zeros((0, 2), dtype=torch.float32, device=dev)
        out = FrameScalars(foe=z2, tpr=z, fpr=z, tpr_fixed=z, fpr_fixed=z,
                           sky_tpr=z, sky_fpr=z,
                           drone_size_pixels=z.to(torch.int64),
                           drone_flow_pixels=z2, center_phi=z)
    history = FlowHistory(buffer=buffer, index=index)
    if track_sparse:
        return out, history, foe_sparse
    return out, history


def detect_video_chunked(
    mesh,
    frames,                       # (T, h, w), T divisible by the mesh size
    omegas,
    dts,
    segmentations,
    sky_masks,
    depths,
    gt_foes,
    sample_yx=None,
    params: FarnebackParams = FarnebackParams(warp="separable", fast=True),
    config: DetectionStep = DetectionStep(),
) -> FrameScalars:
    """Chunked-video sharding over ``mesh`` (a ``parallel.mesh.Mesh``): rank
    ``r`` takes the contiguous time chunk ``r`` of the sequence (its inputs
    alone go to its device) and receives its left neighbour's last frame as
    a one-frame halo (``exchange_rows`` along time), so every transition
    (t-1, t), the chunk boundaries included, is computed exactly once. The
    inputs are the whole sequence, laid out as ``detect_sequence_scan``'s
    (element t describes transition (t-1, t)), on any device or as numpy.

    ``sample_yx`` (T-1, 2N, 2) are the whole sequence's draws; each rank
    slices its own transitions, so the result equals ``detect_sequence_scan``
    on the same draws. Without them every rank draws the scan engine's
    (a generator on its device seeded ``SCAN_SEED``). Returns the
    per-transition scalars of transitions 1..T-1 (leading axis T-1,
    time-ordered) on every rank: the wrap-around transition of the
    reference's ring is dropped."""
    from mav_detection_tpu_torch.parallel.halo import exchange_rows
    from mav_detection_tpu_torch.parallel.mesh import all_gather_cat

    T = frames.shape[0]
    n_dev = mesh.size
    if T % n_dev:
        raise ValueError(f"sequence length {T} not divisible by {n_dev} devices")
    dev = mesh.device
    tl = T // n_dev
    lo = mesh.rank * tl
    h, w = frames.shape[1:3]
    if sample_yx is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SCAN_SEED)
        sample_yx = sample_points(T - 1, config.foe_samples, h, w, gen, dev)

    def chunk(a, start: int, stop: int) -> torch.Tensor:
        a = a[start:stop]
        return (torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray)
                else a).to(dev)

    frames_c = exchange_rows(chunk(frames, lo, lo + tl), 1, 0, mesh, dim=0)
    # element 0 of the aux inputs is not read: the halo frame's slot (or,
    # on rank 0, the sequence's first frame)
    aux_lo = max(lo - 1, 0) if mesh.rank else 0
    aux = [chunk(a, aux_lo, lo + tl) for a in (omegas, dts, segmentations,
                                                  sky_masks, depths, gt_foes)]
    first_t = lo if mesh.rank else 1
    out, _ = detect_sequence_scan(
        frames_c, *aux, sample_yx=chunk(sample_yx, first_t - 1, lo + tl - 1),
        params=params, config=config)
    packed = pack_frame_scalars(out)
    if mesh.rank == 0:
        # rank 0 has no transition into its first frame: a filler row keeps
        # the chunks equal for the gather and is dropped after it
        packed = torch.cat([packed.new_zeros((1, packed.shape[1])), packed])
    return unpack_frame_scalars(all_gather_cat(packed, mesh)[1:])
