"""Window search ops: pyramid sliding-window scan + hill-climb refinement
(``mav_detection_tpu.ops.geometry.boxsearch``).

* ``analyze_pyramid``: the scale-pyramid x sliding-window argmax. Each
  level's window scores come from one integral image and a strided argmax;
  no window loop exists at run time, and nothing comes back to the host.
* ``optimize_window``: the greedy +-1-px boundary hill climb over an
  integral image: each candidate rectangle scores in O(1), the 8 candidate
  moves evaluate as one gather, and the loop carries a hard iteration cap
  (upstream's loop is unbounded). The reference runs it as a ``while_loop``
  inside one compiled program; here the steps are tensor ops on the device
  with the state frozen once no move improves, and the host looks at the
  "still improving" flag once per ``SYNC_EVERY`` steps, only to stop early.
* ``FlowHistory`` / ``blockshaped``: temporal flow chaining and block
  pooling used by the warp-diff path.

Prefix sums are taken in another order than the reference's compiler takes
them, so window scores differ at fp32 rounding (~1e-7 relative): where two
windows or moves tie to that level the two packages may pick differently.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from mav_detection_tpu_torch.ops.geometry.warp import _dst_grid, remap_bilinear
from mav_detection_tpu_torch.ops.image.resize import resize

# optimize_window: steps enqueued between two looks at the improving flag
SYNC_EVERY = 32


class WindowResult(NamedTuple):
    score: torch.Tensor      # () best window sum
    box_xywh: torch.Tensor   # (4,) [x, y, w, h] in ORIGINAL image coordinates
    level: torch.Tensor      # () pyramid level index of the winner


def _integral(img: torch.Tensor) -> torch.Tensor:
    """Zero-padded 2-D inclusive prefix sums: ii[y, x] = sum(img[:y, :x])."""
    ii = torch.cumsum(torch.cumsum(img, dim=0), dim=1)
    return torch.nn.functional.pad(ii, (1, 0, 1, 0))


def _rect_sum(ii: torch.Tensor, x0, y0, x1, y1) -> torch.Tensor:
    """Sum of img[y0:y1, x0:x1] from the padded integral image (O(1))."""
    return ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]


def _gray_f32(img: torch.Tensor) -> torch.Tensor:
    x = img.to(torch.float32)
    return x.sum(dim=-1) if x.ndim == 3 else x


def analyze_pyramid(img: torch.Tensor, window: int = 64, step: int = 16,
                    n_levels: int = 5, scale: float = 1.5) -> WindowResult:
    """Best ``window``x``window`` sum over a resize pyramid (64x64 window,
    step 16, scale 1.5, stop below 30 px, as upstream's search)."""
    h, w = img.shape[:2]
    x = _gray_f32(img)
    dev = x.device

    # upstream initialises with an empty box and compares with a strict `<`:
    # an all-zero image keeps the empty box
    best_score = torch.zeros((), dtype=torch.float32, device=dev)
    best_box = torch.zeros(4, dtype=torch.float32, device=dev)
    best_level = torch.zeros((), dtype=torch.int32, device=dev)

    for lvl in range(n_levels):
        factor = scale ** lvl
        lh, lw = int(round(h / factor)), int(round(w / factor))
        if lh < 30 or lw < 30:
            break
        lev = resize(x, (lh, lw), "linear") if lvl else x
        ii = _integral(lev)
        ny = max((lh - window) // step + 1, 0)
        nx = max((lw - window) // step + 1, 0)
        if ny == 0 or nx == 0:
            # a level smaller than the window contributes nothing: upstream
            # skips every partial window
            continue
        ys = torch.arange(ny, device=dev) * step
        xs = torch.arange(nx, device=dev) * step
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        flat = _rect_sum(ii, xx, yy, xx + window, yy + window).reshape(-1)
        sc, am = torch.max(flat, dim=0)          # first maximum
        wy = torch.div(am, nx, rounding_mode="floor") * step
        wx = (am % nx) * step
        better = sc > best_score
        side = torch.full((), window * factor, dtype=torch.float32, device=dev)
        box = torch.stack([wx * factor, wy * factor, side, side]).to(torch.float32)
        best_box = torch.where(better, box, best_box)
        best_level = torch.where(better, torch.full_like(best_level, lvl), best_level)
        best_score = torch.maximum(best_score, sc)

    return WindowResult(score=best_score, box_xywh=best_box, level=best_level)


def _moves(device: torch.device) -> torch.Tensor:
    """(8, 4) deltas on [x, y, w, h]: corner (top-left, then bottom-right)
    x di x dj; a top-left move shifts x, y and compensates w, h."""
    moves = []
    for corner in (0, 1):
        for di in (-1, 1):
            for dj in (-1, 1):
                moves.append((di, dj, 0.0 - di, 0.0 - dj) if corner == 0
                             else (0.0, 0.0, di, dj))
    return torch.tensor(moves, dtype=torch.float32, device=device)


def optimize_window(mag_img: torch.Tensor, box_xywh: torch.Tensor,
                    max_iters: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy hill climb of box boundaries maximizing the enclosed sum: move
    the top-left OR the bottom-right corner by (+-1, +-1); take the best
    improving move; stop changing at the first step where no move improves.
    Returns (score, refined box [x, y, w, h])."""
    h, w = mag_img.shape[:2]
    ii = _integral(_gray_f32(mag_img))
    ii_flat = ii.reshape(-1)
    stride = w + 1
    hi = torch.tensor([w, h, w, h], dtype=torch.float32, device=ii.device)
    zero = torch.zeros((), dtype=torch.float32, device=ii.device)

    def score(boxes: torch.Tensor) -> torch.Tensor:
        """(m, 4) boxes -> (m,) enclosed sums (0 for an empty box)."""
        corners = torch.cat([boxes[:, :2], boxes[:, :2] + boxes[:, 2:]], dim=1)
        c = torch.minimum(torch.clamp(corners, min=0.0), hi).long()
        x0, y0, x1, y1 = c.unbind(dim=1)
        empty = (x1 <= x0) | (y1 <= y0)
        x1 = torch.maximum(x1, x0)
        y1 = torch.maximum(y1, y0)
        taps = ii_flat[torch.stack([y1 * stride + x1, y0 * stride + x1,
                                    y1 * stride + x0, y0 * stride + x0])]
        return torch.where(empty, zero, taps[0] - taps[1] - taps[2] + taps[3])

    moves = _moves(ii.device)
    box = box_xywh.to(device=ii.device, dtype=torch.float32)
    cur = score(box[None])[0]
    improving = torch.ones((), dtype=torch.bool, device=ii.device)
    for it in range(max_iters):
        cands = box[None, :] + moves
        scores = score(cands)
        best_sc, best = torch.max(scores, dim=0)         # first maximum
        improving = improving & (best_sc > cur)
        box = torch.where(improving, cands[best], box)
        cur = torch.where(improving, best_sc, cur)
        if (it + 1) % SYNC_EVERY == 0 and not bool(improving):
            break
    return cur, box


class FlowHistory(NamedTuple):
    """Ring buffer of flow fields with chained-warp accumulation."""
    buffer: torch.Tensor  # (length, h, w, 2)
    index: int            # next write slot


def make_flow_history(length: int, h: int, w: int,
                      device: torch.device = torch.device("cpu")) -> FlowHistory:
    return FlowHistory(buffer=torch.zeros((length, h, w, 2), dtype=torch.float32,
                                          device=device), index=0)


def push_flow(history: FlowHistory, flow: torch.Tensor) -> FlowHistory:
    """A new history with ``flow`` in the next slot (the buffer is copied:
    the old history stays valid, as the reference's is)."""
    buf = history.buffer.clone()
    buf[history.index] = flow.to(torch.float32)
    return FlowHistory(buffer=buf, index=(history.index + 1) % buf.shape[0])


def accumulated_flow(history: FlowHistory) -> torch.Tensor:
    """Chain the buffered flows, oldest first from ``index``, by successive
    warping: each step looks up the next field at the currently accumulated
    position."""
    length, h, w = history.buffer.shape[:3]
    xs, ys = _dst_grid((h, w), history.buffer.device)
    acc = torch.zeros((h, w, 2), dtype=torch.float32,
                      device=history.buffer.device)
    for k in range(length):
        field = history.buffer[(history.index + k) % length]
        acc = acc + remap_bilinear(field, xs + acc[..., 0], ys + acc[..., 1])
    return acc


def blockshaped(arr: torch.Tensor, nrows: int, ncols: int) -> torch.Tensor:
    """(h, w) -> (n, nrows, ncols) tiling."""
    h, w = arr.shape
    if h % nrows or w % ncols:
        raise ValueError(f"{h}x{w} not divisible by {nrows}x{ncols}")
    return (arr.reshape(h // nrows, nrows, -1, ncols)
            .transpose(1, 2)
            .reshape(-1, nrows, ncols))
