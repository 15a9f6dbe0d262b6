"""The published RAFT's all-pairs lookup: the plain version, the CUDA gather
that replaces it on the card, its plan and bound.

``lookup_corr_all_pairs`` samples each level of the all-pairs pyramid
((b, h, w, th, tw) float32 volumes, ``build_corr_pyramid``) in a (2r+1)^2
window around ``coords`` / 2^level, bilinear, zero outside the map, and
gives (b, levels * (2r+1)^2, h, w) float32 taps in the published order:
level, then the x offset, then the y offset.

Replaces no TPU kernel: the reference's lookup is XLA gathers
(``mav_detection_tpu/models/raft.py``). ``lookup_ref`` is the port's plain
version, ``grid_sample(align_corners=True)`` on one-channel maps
(``bilinear_sampler_zeros``), and runs on CPU tensors. On CUDA tensors
``lookup_cuda`` launches ``csrc/raft_lookup.cu`` once for all levels:
each pixel's taps from one read of its window of its own map, written
straight into the output, with the sampler's float32 arithmetic repeated
tap by tap. It refuses any dtype, layout, radius or depth of pyramid it
does not take; nothing falls back to the plain version on the card.

``lookup_bound`` is the lookup's least time on the H100: each window read
once at 32-byte sectors and each tap written once (``lookup_bytes``).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from mav_detection_tpu_torch import _build

KERNELS = _build.counted("raft_lookup")

RADIUS = 4               # kRadius in the CUDA source: the published radius
MAX_LEVELS = 4           # kMaxLevels
THREADS = 64             # kThreads: a pixel a thread, two warps a block
WINDOW = 2 * RADIUS + 3  # kWin: the taps' span, one more for the rounding
PITCH = 33               # kPitch: words a window cell in shared memory
SECTOR = 32              # bytes a DRAM sector
OPS_PER_TAP = 12         # four weights, four multiply-adds (two operations each)


# ------------------------------------------------------------------ plain
def bilinear_sampler_zeros(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``bilinear_sampler``: (n, c, H, W) sampled at (n, ..., 2) pixel
    coordinates (x, y), bilinear, zero outside the map
    (``grid_sample(align_corners=True)``). A map one pixel high or wide gets
    a one-pixel border of zeros first: ``align_corners`` cannot place a
    coordinate on a single pixel, and the border leaves every tap's value as
    it is."""
    H, W = img.shape[-2:]
    if H == 1 or W == 1:
        img, coords, H, W = F.pad(img, (1, 1, 1, 1)), coords + 1, H + 2, W + 2
    x, y = coords.split([1, 1], dim=-1)
    grid = torch.cat([2 * x / (W - 1) - 1, 2 * y / (H - 1) - 1], dim=-1)
    return F.grid_sample(img, grid, align_corners=True)


def lookup_ref(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
               radius: int) -> torch.Tensor:
    """The plain version (``CorrBlock.__call__``): the (2r+1)^2 offsets
    (``meshgrid(dy, dx)`` added to (x, y)) around each pixel's coordinates
    as one grid, ``bilinear_sampler_zeros`` a level, the levels' taps
    concatenated and moved to channels."""
    b, _, h, w = coords.shape
    n = 2 * radius + 1
    d = torch.linspace(-radius, radius, n, device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1).view(1, n, n, 2)
    centroid = coords.permute(0, 2, 3, 1).reshape(b * h * w, 1, 1, 2)
    outs = []
    for lvl, corr in enumerate(pyramid):
        vol = corr.reshape(b * h * w, 1, corr.shape[3], corr.shape[4])
        taps = bilinear_sampler_zeros(vol, centroid / 2 ** lvl + delta)
        outs.append(taps.view(b, h, w, -1))
    return torch.cat(outs, dim=-1).permute(0, 3, 1, 2).contiguous().float()


# --------------------------------------------------------------- dispatch
def lookup_corr_all_pairs(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                          radius: int) -> torch.Tensor:
    """``lookup_cuda`` for CUDA tensors, ``lookup_ref`` for CPU ones."""
    lookup = lookup_cuda if coords.is_cuda else lookup_ref
    return lookup(pyramid, coords, radius)


# ------------------------------------------------------------------- plan
class Plan(NamedTuple):
    """One launch: ``blocks`` blocks of ``THREADS`` pixels for each of
    ``levels`` levels, ``smem`` bytes of shared memory a block."""
    blocks: int
    levels: int
    smem: int


def plan(b: int, h: int, w: int, levels: int) -> Plan:
    """A thread a pixel of the b lanes' h x w grid, a grid row a level; each
    warp stages its 32 pixels' WINDOW x WINDOW windows (PITCH words a cell,
    so that the staging and the taps' reads spread over the banks)."""
    return Plan(-(-(b * h * w) // THREADS), levels, (THREADS // 32) * WINDOW ** 2 * PITCH * 4)


# ------------------------------------------------------------------ bound
def _row_sectors(nbytes: int) -> float:
    """32-byte sectors a row of ``nbytes`` (float32) covers, the mean over
    its eight 4-byte alignments within a sector."""
    return sum((o + nbytes - 1) // SECTOR + 1 for o in range(0, SECTOR, 4)) / (SECTOR // 4)


def lookup_bytes(b: int, h: int, w: int, shapes: Sequence[Tuple[int, int]],
                 radius: int = RADIUS) -> int:
    """Bytes an iteration's lookup must move: for each pixel and level of
    ``shapes`` ((th, tw) a level) the window its taps read, 2r+2 rows of
    2r+2 float32 clipped to the map, at the 32-byte sectors they cover;
    the coordinates read and the taps written once."""
    span = 2 * radius + 2
    window = sum(min(span, th) * _row_sectors(4 * min(span, tw)) * SECTOR
                 for th, tw in shapes)
    taps = 4 * len(shapes) * (2 * radius + 1) ** 2
    return round(b * h * w * (window + taps + 8))


def lookup_ops(b: int, h: int, w: int, levels: int, radius: int = RADIUS) -> int:
    """float32 operations of an iteration's lookup: ``OPS_PER_TAP`` a tap."""
    return OPS_PER_TAP * b * h * w * levels * (2 * radius + 1) ** 2


def lookup_bound(b: int, h: int, w: int, shapes: Sequence[Tuple[int, int]],
                 radius: int = RADIUS):
    """(least ms of an iteration's lookup on the H100, "bytes" or
    "operations")."""
    from mav_detection_tpu_torch.utils.timing import bound_ms

    return bound_ms(lookup_bytes(b, h, w, shapes, radius),
                    lookup_ops(b, h, w, len(shapes), radius))


def kernel_info():
    """The kernel's launch resources on the current card (``_build.RESOURCES``)."""
    return _build.kernel_resources("raft_lookup", "raft_lookup_info")


# ---------------------------------------------------------------- wrapper
def lookup_cuda(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                radius: int) -> torch.Tensor:
    """``lookup_ref`` as one launch of ``csrc/raft_lookup.cu`` on the
    current stream: coords a contiguous (b, 2, h, w) float32 CUDA tensor, 1
    to ``MAX_LEVELS`` contiguous (b, h, w, th, tw) float32 volumes on its
    card, radius ``RADIUS`` (anything else is a ValueError)."""
    if radius != RADIUS:
        raise ValueError(f"lookup_cuda takes radius {RADIUS}, got {radius}")
    if not 1 <= len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"lookup_cuda takes 1 to {MAX_LEVELS} levels, got {len(pyramid)}")
    if coords.dim() != 4 or coords.shape[1] != 2:
        raise ValueError(f"coords: shape {tuple(coords.shape)}, need (b, 2, h, w)")
    _build.check_tensor("coords", coords, coords.shape)
    b, _, h, w = coords.shape
    for lvl, vol in enumerate(pyramid):
        if vol.dim() != 5 or vol.device != coords.device:
            raise ValueError(f"pyramid[{lvl}]: shape {tuple(vol.shape)} on {vol.device}, "
                             f"need (b, h, w, th, tw) on {coords.device}")
        _build.check_tensor(f"pyramid[{lvl}]", vol, (b, h, w, *vol.shape[3:]))
    dev = coords.device
    out = torch.empty((b, len(pyramid) * (2 * radius + 1) ** 2, h, w), dtype=torch.float32,
                      device=dev)
    vols = [v.data_ptr() for v in pyramid] + [None] * (MAX_LEVELS - len(pyramid))
    dims = [d for v in pyramid for d in v.shape[3:]] + [0] * (2 * (MAX_LEVELS - len(pyramid)))
    _build.launch("raft_lookup", KERNELS[0], dev, *vols, *dims, len(pyramid),
                  coords.data_ptr(), b, h, w, radius, out.data_ptr())
    return out
