"""The detection step's per-frame rates: the plain version, the CUDA
reduction that replaces it on the card, its plan and bound.

From the frames' segmentation (uint8), the dynamic and fixed detection
masks, the sky estimate (bool), depth (float32) and the raw GT flow
(float32 (n, h, w, 2)) with the IMU rates, ``detection_rates`` gives the
ten scalars ``FrameOutputs`` carries besides the FoE: pixel TPR / FPR of
both masks, sky TPR / FPR against depth > 0.8 of the frame's max, the
drone's size and mean derotated GT flow, and the angle of its box's centre
seen from the GT FoE.

Replaces no TPU kernel: the reference computes the same counts with XLA's
reductions (``mav_detection_tpu/pipeline/detector.py``). ``rates_ref`` is
the port's plain version, eager PyTorch (``_tpr_fpr`` three times,
``masked_mean_flow`` over the derotated GT flow, the device box), and runs
on CPU tensors. On CUDA tensors ``rates_cuda`` launches
``csrc/detect_rates.cu``, and refuses any dtype but those above: a pre-pass
for each frame's max depth and segmentation, one pass that reads every
pixel once and counts, and a last launch that sums the blocks' partials in
a fixed order and writes the scalars. Counts are exact; the flow sum runs in double, in
another order than the plain float32 sum.

``rates_bound`` is the stage's least time on the H100: its inputs read once
(``rates_bytes``), against its float32 operations (the rotational field at
every pixel).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from mav_detection_tpu_torch import _build
from mav_detection_tpu_torch.ops.geometry.derotation import derotate
from mav_detection_tpu_torch.ops.image.boxes import get_simple_bounding_box_device
from mav_detection_tpu_torch.ops.image.metrics import _tpr_fpr, masked_mean_flow

KERNELS = _build.counted("detect_rates_max", "detect_rates_count", "detect_rates_finish")

THREADS = 256          # kThreads in the CUDA source
INTS = 12              # integer partials of a count block (kInts)
MIN_ITEMS, MAX_ITEMS = 4, 64   # pixels a thread of a count block
BLOCKS_PER_SM = 2048 // THREADS
# float32 operations a pixel: the rotational field's u and v (9 each), then
# subtract, mask and sum each component
OPS_PER_PIXEL = 24


class Rates(NamedTuple):
    """Per-frame scalars of the rates stage, each with a leading frame axis."""
    tpr: torch.Tensor                # (n,) float32
    fpr: torch.Tensor
    tpr_fixed: torch.Tensor
    fpr_fixed: torch.Tensor
    sky_tpr: torch.Tensor
    sky_fpr: torch.Tensor
    drone_size_pixels: torch.Tensor  # (n,) int64
    drone_flow_pixels: torch.Tensor  # (n, 2) float32
    center_phi: torch.Tensor         # (n,) float32


# ------------------------------------------------------------------ plain
def rates_ref(segmentation, total_mask, estimate_fixed, sky_mask, depth, gt_flow_uv,
              omega, dt, gt_foe) -> Rates:
    """The plain version: upstream's integer-product rates, the sky rates
    against depth > 0.8 * max, the mean GT flow on the drone after
    derotation (NaN for an empty drone), the drone's area and the angle of
    its box's centre seen from the GT FoE (NaN for a NaN FoE)."""
    n = segmentation.shape[0]
    gt_flow_derot = derotate(gt_flow_uv.to(torch.float32), omega, dt)
    dmax = depth.reshape(n, -1).max(dim=1).values[:, None, None]
    sky_gt = depth > 0.8 * dmax
    sky_tpr, sky_fpr = _tpr_fpr(sky_gt.to(torch.uint8) * 255,
                                sky_mask.to(torch.uint8) * 255)
    seg_pos = segmentation > 127
    tpr, fpr = _tpr_fpr(segmentation, 255 * total_mask.to(torch.int32))
    tpr_fixed, fpr_fixed = _tpr_fpr(segmentation, 255 * estimate_fixed.to(torch.int32))
    drone_flow = masked_mean_flow(gt_flow_derot, seg_pos)
    drone_size = seg_pos.reshape(n, -1).sum(dim=1)
    # center_phi: angle of the target's bbox center seen from the GT FoE
    box = get_simple_bounding_box_device(segmentation).to(torch.float32)
    cx = (box[:, 0] + box[:, 2]) / 2.0
    cy = (box[:, 1] + box[:, 3]) / 2.0
    gt_foe = gt_foe.to(torch.float32)
    center_phi = torch.atan2(cy - gt_foe[:, 1], cx - gt_foe[:, 0]) * (180.0 / math.pi)
    return Rates(tpr, fpr, tpr_fixed, fpr_fixed, sky_tpr, sky_fpr, drone_size,
                 drone_flow, center_phi)


# --------------------------------------------------------------- dispatch
def detection_rates(segmentation, total_mask, estimate_fixed, sky_mask, depth,
                    gt_flow_uv, omega, dt, gt_foe) -> Rates:
    """``rates_cuda`` for CUDA tensors, ``rates_ref`` for CPU ones."""
    rates = rates_cuda if segmentation.is_cuda else rates_ref
    return rates(segmentation, total_mask, estimate_fixed, sky_mask, depth, gt_flow_uv,
                 omega, dt, gt_foe)


# ------------------------------------------------------------------- plan
def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Plan(NamedTuple):
    """The launches of a batch: ``prepass`` blocks a frame for the maxima,
    ``items`` pixels a thread and ``blocks`` blocks a frame for the counts."""
    prepass: int
    items: int
    blocks: int


def plan(n: int, h: int, w: int, sms: int) -> Plan:
    """About one wave of blocks for the pre-pass (at most ``THREADS`` a
    frame, so that a count block reduces its frame's partial maxima with
    one load a thread) and for the counts, on a card of ``sms``
    multiprocessors with ``BLOCKS_PER_SM`` blocks each, a count thread
    taking ``MIN_ITEMS`` to ``MAX_ITEMS`` pixels (the fastest of 1-64 on the
    H100 at b=8 752x480 and 1920x1024 and at b=1, PERF.md §6)."""
    hw = h * w
    wave = sms * BLOCKS_PER_SM
    prepass = max(1, min(THREADS, _cdiv(hw, THREADS), _cdiv(wave, n)))
    items = max(MIN_ITEMS, min(MAX_ITEMS, _cdiv(n * hw, THREADS * wave)))
    return Plan(prepass, items, _cdiv(hw, THREADS * items))


# ------------------------------------------------------------------ bound
def rates_bytes(n: int, h: int, w: int, depth_frames: Optional[int] = None) -> int:
    """Bytes the stage must move: each input read once (segmentation, the
    two masks and sky 1 B a pixel, the GT flow 8 B, depth 4 B a pixel of
    each of its ``depth_frames`` frames: n by default, 1 where one frame is
    expanded over the batch) and the scalars written (9 float32 and one
    int64 a frame)."""
    d = n if depth_frames is None else depth_frames
    return 12 * n * h * w + 4 * d * h * w + n * (9 * 4 + 8)


def rates_ops(n: int, h: int, w: int) -> int:
    """float32 operations of the stage: ``OPS_PER_PIXEL`` a pixel."""
    return OPS_PER_PIXEL * n * h * w


def rates_bound(n: int, h: int, w: int, depth_frames: Optional[int] = None):
    """(least ms on the H100, "bytes" or "operations")."""
    from mav_detection_tpu_torch.utils.timing import bound_ms

    return bound_ms(rates_bytes(n, h, w, depth_frames), rates_ops(n, h, w))


# ---------------------------------------------------------------- wrapper
def _frames(t: torch.Tensor, name: str, shape, align: int = 1
            ) -> Tuple[torch.Tensor, int]:
    """``t`` with each frame contiguous, and its batch stride in elements (0
    where one frame is expanded over the batch); copied where a frame is not
    contiguous or a frame's start is not ``align`` elements aligned."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t[0].is_contiguous() or t.stride(0) % align or \
            t.data_ptr() % (align * t.element_size()):
        t = t.clone(memory_format=torch.contiguous_format)
    return t, t.stride(0)


def rates_cuda(segmentation, total_mask, estimate_fixed, sky_mask, depth, gt_flow_uv,
               omega, dt, gt_foe) -> Rates:
    """``rates_ref`` as three launches of ``csrc/detect_rates.cu`` on the
    current stream: CUDA tensors, segmentation uint8, the masks and sky
    bool, depth and the GT flow float32 (anything else is a ValueError);
    ``depth`` may be one frame expanded over the batch (batch stride 0)."""
    for name, t, dtype in (("segmentation", segmentation, torch.uint8),
                           ("total_mask", total_mask, torch.bool),
                           ("estimate_fixed", estimate_fixed, torch.bool),
                           ("sky_mask", sky_mask, torch.bool), ("depth", depth, torch.float32),
                           ("gt_flow_uv", gt_flow_uv, torch.float32)):
        _build.check_tensor(name, t, dtype=dtype)    # the layout is _frames'
    n, h, w = segmentation.shape
    if h * w > 2 ** 31 - 1 - 2 * THREADS * MAX_ITEMS:
        raise ValueError(f"rates_cuda: a frame of {h}x{w} pixels is too large")
    dev = segmentation.device
    seg, seg_bs = _frames(segmentation, "segmentation", (n, h, w))
    tm, tm_bs = _frames(total_mask, "total_mask", (n, h, w))
    fx, fx_bs = _frames(estimate_fixed, "estimate_fixed", (n, h, w))
    sk, sk_bs = _frames(sky_mask, "sky_mask", (n, h, w))
    dp, dp_bs = _frames(depth, "depth", (n, h, w))
    fl, fl_bs = _frames(gt_flow_uv, "gt_flow_uv", (n, h, w, 2), align=2)
    small = {}
    for name, t, shape in (("omega", omega, (n, 3)), ("dt", dt, (n,)),
                           ("gt_foe", gt_foe, (n, 2))):
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name}: shape {tuple(t.shape)} on {t.device}, need "
                             f"{shape} on {dev}")
        small[name] = t.to(torch.float32).contiguous()
    pl = plan(n, h, w, _build.sm_count(dev.index))
    maxes = torch.empty((n, pl.prepass, 2), dtype=torch.float32, device=dev)
    ints = torch.empty((n, pl.blocks, INTS), dtype=torch.int32, device=dev)
    sums = torch.empty((n, pl.blocks, 2), dtype=torch.float64, device=dev)
    out = torch.empty((9 * n,), dtype=torch.float32, device=dev)
    size = torch.empty((n,), dtype=torch.int64, device=dev)
    p = lambda t: t.data_ptr()  # noqa: E731

    _build.launch("detect_rates", KERNELS[0], dev, p(seg), seg_bs, p(dp), dp_bs, n, h, w,
                  pl.prepass, p(maxes))
    _build.launch("detect_rates", KERNELS[1], dev,
                  p(seg), seg_bs, p(tm), tm_bs, p(fx), fx_bs, p(sk), sk_bs, p(dp), dp_bs,
                  p(fl), fl_bs, p(small["omega"]), p(small["dt"]), n, h, w, pl.items,
                  pl.prepass, p(maxes), p(ints), p(sums))
    _build.launch("detect_rates", KERNELS[2], dev, p(ints), p(sums), n, h, w, pl.items,
                  p(small["gt_foe"]), p(out), p(size))
    return Rates(tpr=out[0:n], fpr=out[n:2 * n], tpr_fixed=out[2 * n:3 * n],
                 fpr_fixed=out[3 * n:4 * n], sky_tpr=out[4 * n:5 * n],
                 sky_fpr=out[5 * n:6 * n], drone_size_pixels=size,
                 drone_flow_pixels=out[7 * n:].view(n, 2), center_phi=out[6 * n:7 * n])
