"""PyTorch layers that compute what ``flax.linen.Conv`` and ``GroupNorm``
compute, on NCHW tensors.

The compute dtype is an argument of each call, not state of the layer: one
set of fp32 weights then serves the product bfloat16 configuration and the
fp32 one (as Flax's ``param_dtype`` stays fp32 whatever ``dtype`` is).

* **SAME padding.** XLA pads ``lo = total // 2`` before and ``hi = total -
  lo`` after, ``total = max((ceil(n / s) - 1) * s + k - n, 0)``: at stride 2
  on an even size that is asymmetric ((2, 3) for the 7x7 stem, (0, 1) for a
  3x3), which ``nn.Conv2d(padding=...)`` cannot express. ``Conv`` pads
  explicitly and convolves with ``padding=0``.
* **dtype.** ``nn.Conv(dtype=bf16)`` casts input, kernel and bias to bf16
  and returns bf16; so does ``Conv`` with ``dtype=torch.bfloat16``. Flax
  adds the bias to the convolution's bf16 result, so ``Conv`` does too
  (PyTorch's CPU convolution would otherwise fuse it before the one
  rounding, and its bf16 losses drift from the reference's by ~3 %).
* **GroupNorm.** Flax's defaults: ``epsilon=1e-6``, statistics in fp32 as
  E[x²] − E[x]² clipped at 0, ``(x - mean) * (rsqrt(var + eps) * scale) +
  bias`` in fp32, output in the call's dtype. And one that is easy to miss:
  Flax's GroupNorm reduces over every axis but the first and the channels,
  taking the first as the batch. The reference applies its nets to one
  unbatched (h, w, c) image at a time (``vmap`` over the batch), so its
  statistics are **per image row**: over w and the group's channels. The
  checkpoints were trained that way, and ``GroupNorm`` here does the same.
* **Row sharding.** Inside ``row_sharded(mesh)`` every tensor holds this
  rank's band of image rows (equal bands, each starting on a multiple of
  every stride). ``Conv`` then pulls the rows its window reads beyond the
  band from the neighbours (``parallel.halo.exchange_rows``, differentiable)
  in place of zero padding, and pads zeros only at the global edges, with
  XLA's SAME split of the global height: the result is the unsharded
  convolution's rows of the band. GroupNorm's per-row statistics need
  nothing.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


# the mesh whose ranks each hold a band of rows, inside ``row_sharded``
_ROWS: contextvars.ContextVar = contextvars.ContextVar("rows", default=None)


@contextlib.contextmanager
def row_sharded(mesh) -> Iterator[None]:
    """Run the layers on row bands of ``mesh`` (a ``parallel.mesh.Mesh``)."""
    token = _ROWS.set(mesh)
    try:
        yield
    finally:
        _ROWS.reset(token)


def current_rows():
    """The row-sharding mesh of the enclosing ``row_sharded``, or None."""
    return _ROWS.get()


def _row_halo(x: torch.Tensor, k: int, s: int, mesh) -> torch.Tensor:
    """This rank's band with the rows a (k, stride s) SAME window reads
    beyond it: the neighbours' rows inside the image, zeros beyond its
    global edges."""
    from mav_detection_tpu_torch.parallel.halo import exchange_rows

    lo, _ = same_pads(x.shape[-2] * mesh.size, k, s)
    below = k - s - lo       # < 0: the window never reaches the next band
    x = exchange_rows(x, lo, max(below, 0), mesh)
    top = lo if mesh.rank == 0 else 0
    bottom = max(below, 0) if mesh.rank == mesh.size - 1 else 0
    return F.pad(x, (0, 0, top, bottom)) if top or bottom else x


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding (before, after) of one spatial dim of size ``n``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """``flax.linen.Conv(features, (k, k), strides=(s, s))`` with SAME
    padding; ``weight`` is OIHW (Flax's HWIO ``kernel`` transposed)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1) -> None:
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h, w = x.shape[-2:]
        top, bottom = same_pads(h, self.k, self.stride)
        left, right = same_pads(w, self.k, self.stride)
        x = x.to(dtype)
        rows = current_rows()
        if rows is not None:
            x = _row_halo(x, self.k, self.stride, rows)
            top = bottom = 0
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        # the bias goes on after the convolution's result is in ``dtype``,
        # as Flax adds it: in bf16 that is two roundings, where a bias fused
        # into the convolution (oneDNN on the CPU) is one
        y = F.conv2d(x, self.weight.to(dtype), None, self.stride)
        return y + self.bias.to(dtype)[:, None, None]


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm(num_groups)`` over the channels of NCHW."""

    EPS = 1e-6

    def __init__(self, groups: int, channels: int) -> None:
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, c, h, w = x.shape
        per = c // self.groups
        xf = x.to(torch.float32)
        grouped = xf.reshape(b, self.groups, per, h, w)
        mean = grouped.mean((2, 4), keepdim=True)                  # (b,g,1,h,1)
        var = torch.clamp((grouped * grouped).mean((2, 4), keepdim=True)
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.EPS) * self.weight.reshape(1, self.groups, per, 1, 1)
        y = (grouped - mean) * mul + self.bias.reshape(1, self.groups, per, 1, 1)
        return y.reshape(b, c, h, w).to(dtype)


def init_params(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Flax's default initialisers, drawn from ``generator``: conv kernels
    LeCun normal (truncated at 2 sigma, as ``variance_scaling`` draws them),
    biases 0, GroupNorm scales 1."""
    for m in module.modules():
        if isinstance(m, Conv):
            fan_in = m.weight.shape[1] * m.k * m.k
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            with torch.no_grad():
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
                m.weight.copy_(w * std)
                m.bias.zero_()
        elif isinstance(m, GroupNorm):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()


def conv_flops(model: nn.Module, fn) -> dict:
    """fp32 and bf16 operations (multiply-adds x2) of every ``Conv`` of
    ``model`` that ``fn()`` runs, counted from the output shapes by forward
    hooks: ``{"fp32": ..., "bf16": ...}``."""
    flops = {"fp32": 0.0, "bf16": 0.0}

    def hook(mod, args, out):
        kind = "bf16" if args[1] == torch.bfloat16 else "fp32"
        flops[kind] += 2.0 * out.numel() * mod.weight.shape[1] * mod.k * mod.k

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, Conv)]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return flops
