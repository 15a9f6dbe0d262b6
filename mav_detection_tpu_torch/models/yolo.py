"""Single-class YOLO-style detector (``mav_detection_tpu.models.yolo``):
TinyYOLO inference, its decode with greedy IoU suppression, and
``detect_boxes``.

A conv backbone at 1/16 resolution predicts (objectness, cx, cy, w, h) for 3
anchors per cell. ``decode_predictions`` takes the top 64 scores and runs the
reference's greedy suppression over them, batched over a leading dimension.

* **GroupNorm per image row.** The reference applies TinyYOLO to one
  unbatched (h, w, 3) image (``vmap`` over a batch), so Flax's GroupNorm
  takes its statistics per image row, and the checkpoints were trained that
  way. ``models/layers.GroupNorm`` does the same.
* **Top-k ties.** ``jax.lax.top_k`` breaks ties by the lower index;
  ``torch.topk`` promises no order, and saturated sigmoids (logits above ~17
  in fp32) do tie. The top k is a stable descending sort.
* **The greedy loop** computes the (B, k, k) IoU matrix once and runs its k
  sequential steps as masked updates of a (B, k) bool tensor on the device:
  no look from the host inside the loop.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mav_detection_tpu_torch.models.layers import Conv, GroupNorm, init_params

ANCHORS = np.array([[12.0, 12.0], [24.0, 24.0], [48.0, 48.0]], np.float32)
MAX_DETECTIONS = 16
STRIDE = 16


class Boxes(NamedTuple):
    """Kept boxes first, in score order; a leading batch dimension where the
    input was batched."""

    xywh: torch.Tensor   # (..., MAX_DETECTIONS, 4) center-format pixels
    score: torch.Tensor  # (..., MAX_DETECTIONS)
    valid: torch.Tensor  # (..., MAX_DETECTIONS) bool


class Stage(nn.Module):
    """Stride-2 conv -> GroupNorm(8) -> relu -> conv -> GroupNorm(8) -> relu."""

    def __init__(self, cin: int, features: int) -> None:
        super().__init__()
        self.down = Conv(cin, features, 3, stride=2)
        self.norm1 = GroupNorm(8, features)
        self.conv = Conv(features, features, 3)
        self.norm2 = GroupNorm(8, features)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = F.relu(self.norm1(self.down(x, dtype), dtype))
        return F.relu(self.norm2(self.conv(x, dtype), dtype))


class TinyYOLO(nn.Module):
    """(b, h, w, 3) images, h and w multiples of 16 -> (b, h/16, w/16,
    anchors * 5) raw predictions. The head runs in fp32."""

    def __init__(self, base: int = 24, n_anchors: int = 3) -> None:
        super().__init__()
        feats = [base, base * 2, base * 4, base * 8]
        self.stage1 = Stage(3, feats[0])
        self.stage2 = Stage(feats[0], feats[1])
        self.stage3 = Stage(feats[1], feats[2])
        self.stage4 = Stage(feats[2], feats[3])
        self.head = Conv(feats[3], n_anchors * 5, 1)

    def forward(self, images: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2).to(torch.float32) / 127.5 - 1.0
        for stage in (self.stage1, self.stage2, self.stage3, self.stage4):
            x = stage(x, dtype)
        return self.head(x, torch.float32).permute(0, 2, 3, 1)


_ANCHORS_ON: dict = {}


def _anchors_on(dev: torch.device) -> torch.Tensor:
    """``ANCHORS`` on ``dev``, copied once per device (so that a decode can be
    captured in a CUDA graph after its first call)."""
    key = str(dev)
    if key not in _ANCHORS_ON:
        _ANCHORS_ON[key] = torch.as_tensor(ANCHORS, device=dev)
    return _ANCHORS_ON[key]


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(B, k, 4) center boxes -> (B, k, k) with [b, i, j] the reference's
    ``iou(boxes[j], boxes[i])``."""
    a = boxes[:, None, :, :]       # j along the last axis
    b = boxes[:, :, None, :]       # i along the middle axis
    ax1, ay1 = a[..., 0] - a[..., 2] / 2, a[..., 1] - a[..., 3] / 2
    ax2, ay2 = a[..., 0] + a[..., 2] / 2, a[..., 1] + a[..., 3] / 2
    bx1, by1 = b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2
    bx2, by2 = b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2
    ix = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), min=0.0)
    iy = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), min=0.0)
    inter = ix * iy
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return inter / torch.clamp(union, min=1e-9)


def decode_predictions(raw: torch.Tensor, stride: int = STRIDE,
                       score_threshold: float = 0.5,
                       iou_threshold: float = 0.45) -> Boxes:
    """(B, gh, gw, anchors * 5) raw grid predictions -> top-K boxes with
    greedy IoU suppression, batched over B."""
    bsz, gh, gw = raw.shape[:3]
    na = ANCHORS.shape[0]
    dev = raw.device
    p = raw.to(torch.float32).reshape(bsz, gh, gw, na, 5)
    ys = torch.arange(gh, dtype=torch.float32, device=dev)[:, None, None]
    xs = torch.arange(gw, dtype=torch.float32, device=dev)[None, :, None]
    anchors = _anchors_on(dev)
    cx = (torch.sigmoid(p[..., 1]) + xs) * stride
    cy = (torch.sigmoid(p[..., 2]) + ys) * stride
    bw = torch.exp(torch.clamp(p[..., 3], -4, 4)) * anchors[:, 0]
    bh = torch.exp(torch.clamp(p[..., 4], -4, 4)) * anchors[:, 1]
    score = torch.sigmoid(p[..., 0]).reshape(bsz, -1)

    k = min(MAX_DETECTIONS * 4, score.shape[1])
    # stable descending sort: ties keep the lower index first, as top_k does
    top_scores, idx = torch.sort(score, dim=1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :k], idx[:, :k]
    boxes = torch.stack([torch.gather(c.reshape(bsz, -1), 1, idx)
                         for c in (cx, cy, bw, bh)], dim=-1)      # (B, k, 4)
    cand_ok = top_scores > score_threshold

    eye = torch.eye(k, dtype=torch.bool, device=dev)
    over = (_iou_matrix(boxes) > iou_threshold) & ~eye            # (B, k, k)
    keep = torch.zeros((bsz, k), dtype=torch.bool, device=dev)
    count = torch.zeros(bsz, dtype=torch.int32, device=dev)
    for i in range(k):
        conflict = (keep & over[:, i]).any(dim=1)
        take = cand_ok[:, i] & ~conflict & (count < MAX_DETECTIONS)
        keep[:, i] = take
        count += take.to(torch.int32)
    order = torch.argsort((~keep).to(torch.uint8), dim=1,
                          stable=True)[:, :MAX_DETECTIONS]
    return Boxes(xywh=torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
                 score=torch.gather(top_scores, 1, order),
                 valid=torch.gather(keep, 1, order))


def create_yolo(generator: Optional[torch.Generator] = None,
                image_hw: Tuple[int, int] = (480, 752)) -> TinyYOLO:
    """A TinyYOLO with Flax's default initialisers drawn from ``generator``
    (seed 0 when none is given). ``image_hw`` is the reference's init shape;
    the parameters do not depend on it."""
    model = TinyYOLO()
    init_params(model, generator if generator is not None
                else torch.Generator().manual_seed(0))
    return model


def pad_to_stride(images: torch.Tensor, stride: int = STRIDE) -> torch.Tensor:
    """(b, h, w, c) -> edge-replicated to multiples of ``stride``."""
    h, w = images.shape[1:3]
    ph, pw = (-h) % stride, (-w) % stride
    if not (ph or pw):
        return images
    x = images.permute(0, 3, 1, 2).to(torch.float32)
    return F.pad(x, (0, pw, 0, ph), mode="replicate").permute(0, 2, 3, 1)


def detect_boxes(model: TinyYOLO, image: Union[np.ndarray, torch.Tensor],
                 score_threshold: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16) -> Boxes:
    """(h, w, 3) or (B, h, w, 3) uint8 or float image(s) -> Boxes on the
    model's device (batched like the input); pads to /16 with edge
    replication."""
    dev = model.head.weight.device
    x = torch.as_tensor(image if isinstance(image, torch.Tensor)
                        else np.asarray(image)).to(dev)
    single = x.ndim == 3
    if single:
        x = x[None]
    with torch.no_grad():
        raw = model(pad_to_stride(x), dtype)
        boxes = decode_predictions(raw, score_threshold=score_threshold)
    if single:
        return Boxes(*(t[0] for t in boxes))
    return boxes


def boxes_to_host(boxes: Boxes) -> Boxes:
    """Boxes with numpy fields, from one pull of a packed (..., 16, 6)
    tensor."""
    packed = torch.cat([boxes.xywh, boxes.score[..., None],
                        boxes.valid[..., None].to(torch.float32)], -1).cpu().numpy()
    return Boxes(xywh=packed[..., :4], score=packed[..., 4],
                 valid=packed[..., 5] > 0.5)


def box_strings(boxes: Boxes) -> List[str]:
    """Host Boxes of one image -> the remote client's box-string protocol,
    ``"drone conf x y w h"`` with top-left pixel coordinates."""
    valid, xywh, score = boxes.valid, boxes.xywh, boxes.score
    out = []
    for j in range(len(valid)):
        if not valid[j]:
            continue
        cx, cy, bw, bh = xywh[j]
        out.append(f"drone {score[j]:.4f} {cx - bw / 2:.2f} {cy - bh / 2:.2f} "
                   f"{bw:.2f} {bh:.2f}")
    return out


def batch_box_strings(model: TinyYOLO, frames: np.ndarray, batch: int = 8,
                      score_threshold: float = 0.5) -> List[List[str]]:
    """Box strings of each frame of an (n, h, w, 3) stack, run in calls of
    ``batch`` frames with the ragged tail edge-padded (every call has the
    same shape; the padded frames never appear); one pull per call."""
    out: List[List[str]] = []
    for b0 in range(0, len(frames), batch):
        chunk = frames[b0:b0 + batch]
        pad = batch - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
        boxes = boxes_to_host(detect_boxes(model, chunk, score_threshold=score_threshold))
        out.extend(box_strings(Boxes(*(a[j] for a in boxes)))
                   for j in range(len(chunk) - pad))
    return out


def yolo_loss(model: TinyYOLO, images: torch.Tensor, target_xywh: torch.Tensor,
              stride: int = STRIDE, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The reference's single-target loss of each example: (b, h, w, 3)
    images (multiples of 16) and (b, 4) center boxes in px -> (b,) losses.
    Objectness BCE over every anchor of every cell (x100) with one positive,
    the cell of the box center (``clip(c / stride, 0, g - 1 - 1e-3)``,
    truncated to int32) at the anchor of the nearest area, plus the squared
    errors of that prediction's offsets and log sizes."""
    raw = model(images, dtype)
    b, gh, gw = raw.shape[:3]
    na = ANCHORS.shape[0]
    p = raw.reshape(b, gh, gw, na, 5)
    t = target_xywh.to(torch.float32)
    cx, cy, bw, bh = t[:, 0], t[:, 1], t[:, 2], t[:, 3]
    gx = torch.clamp(cx / stride, 0, gw - 1 - 1e-3)
    gy = torch.clamp(cy / stride, 0, gh - 1 - 1e-3)
    ci = gx.to(torch.int32).long()
    cj = gy.to(torch.int32).long()
    anchors = _anchors_on(raw.device)
    a = torch.argmin(torch.abs(anchors[None, :, 0] * anchors[None, :, 1]
                               - (bw * bh)[:, None]), dim=1)
    # the target cell and anchor as one flat index: scatter and gather, so
    # neither the forward nor the backward waits for the host
    flat = ((cj * gw + ci) * na + a)[:, None]                     # (b, 1)
    obj_target = torch.zeros((b, gh * gw * na), device=raw.device).scatter_(
        1, flat, 1.0).reshape(b, gh, gw, na)
    logit = p[..., 0]
    obj_loss = torch.mean(torch.clamp(logit, min=0) - logit * obj_target
                          + torch.log1p(torch.exp(-torch.abs(logit))), dim=(1, 2, 3))
    pred = torch.gather(p.reshape(b, gh * gw * na, 5), 1,
                        flat[..., None].expand(b, 1, 5))[:, 0]   # (b, 5)
    tx, ty = gx - ci, gy - cj
    anc = anchors[a]
    coord = ((torch.sigmoid(pred[:, 1]) - tx) ** 2
             + (torch.sigmoid(pred[:, 2]) - ty) ** 2
             + (pred[:, 3] - torch.log(torch.clamp(bw / anc[:, 0], min=1e-4))) ** 2
             + (pred[:, 4] - torch.log(torch.clamp(bh / anc[:, 1], min=1e-4))) ** 2)
    return obj_loss * 100.0 + coord
