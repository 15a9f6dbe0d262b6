"""RAFT-style optical flow (``mav_detection_tpu.models.raft``): inference,
and the training loss and step.

Teed & Deng 2020 (arXiv:2003.12039): feature and context encoders at 1/8
resolution, a 4-level correlation pyramid, and a ConvGRU update operator
iterated ``iters`` times, then a learned convex 8x upsample of the final
flow. NCHW tensors; flow at 1/8 resolution is (b, 2, h, w) with channel 0
the x component; correlation features are (b, levels * (2r+1)^2, h, w),
taps ordered level, then dy, then dx.

Three correlation forms, as in the reference:

* ``all_pairs_correlation`` + ``build_corr_pyramid`` + ``lookup_corr``: the
  materialised (h*w)^2 volume, the last rung of the coverage ladder;
* ``build_feature_pyramid`` + ``lookup_corr_otf``: window dot products
  recomputed from pooled features (the plain version the volumes are held
  against);
* ``build_local_corr_volumes`` + ``lookup_corr_volumes``: per-frame banded
  volumes, exact within ``8 * max_flow_lookup`` px of motion (the product
  path). The volumes come from one fp32 matmul per row shift and a gather
  of the diagonal band; the lookup gathers its bilinear taps. The
  reference's skewed reshape and one-hot selector einsums were TPU
  lowerings of the same functions.

The GRU refinement is a Python loop of ``iters`` steps (``nn.scan`` in the
reference), and pairs are a batch dimension (``jax.vmap``). Compute runs in
``RAFTConfig.dtype`` (bfloat16 by default); the image normalisation, the
correlation, the flow and mask heads and the upsample run in fp32. Frames go
in as the dataset gives them (BGR uint8; a gray frame is repeated to 3
channels): the checkpoint was trained on that.

Entry points run on the card unless given ``device="cpu"``. With no model
given they load the shipped checkpoint (``models/pretrained.py``), or,
without one, random weights with a warning.
"""
from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass, replace
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mav_detection_tpu_torch.models.layers import Conv, GroupNorm, current_rows, init_params
from mav_detection_tpu_torch.ops.geometry.warp import sample_bilinear_replicate
from mav_detection_tpu_torch.ops.image.resize import resize_frames
from mav_detection_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("mav_detection_tpu_torch")
Device = Union[str, torch.device]


@dataclass(frozen=True)
class RAFTConfig:
    feature_dim: int = 128
    hidden_dim: int = 96
    context_dim: int = 64
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 12
    dtype: torch.dtype = torch.bfloat16
    # False = banded LOCAL correlation volumes built once per frame pair from
    # pooled features (no (h*w)^2 volume)
    materialize_corr: bool = True
    # half-width, in 1/8-res feature px, of the local volumes' flow coverage
    # when materialize_corr=False: |flow| <= 8*max_flow_lookup full-res px is
    # exact; beyond it the lookup window saturates
    max_flow_lookup: int = 2


_ARCHITECTURE = ("feature_dim", "hidden_dim", "context_dim", "corr_levels",
                 "corr_radius")


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1) -> None:
        super().__init__()
        self.conv1 = Conv(cin, features, 3, stride)
        self.norm1 = GroupNorm(8, features)
        self.conv2 = Conv(features, features, 3)
        self.norm2 = GroupNorm(8, features)
        self.down = (Conv(cin, features, 1, stride)
                     if stride != 1 or cin != features else None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x, dtype), dtype))
        y = self.norm2(self.conv2(y, dtype), dtype)
        if self.down is not None:
            x = self.down(x, dtype)
        return F.relu(x.to(dtype) + y)


class Encoder(nn.Module):
    """1/8-resolution convolutional encoder."""

    def __init__(self, output_dim: int) -> None:
        super().__init__()
        self.stem = Conv(3, 48, 7, 2)
        self.stem_norm = GroupNorm(8, 48)
        self.layer1 = ResidualBlock(48, 48)
        self.layer2 = ResidualBlock(48, 72, 2)
        self.layer3 = ResidualBlock(72, 96, 2)
        self.out = Conv(96, output_dim, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = F.relu(self.stem_norm(self.stem(x, dtype), dtype))
        x = self.layer3(self.layer2(self.layer1(x, dtype), dtype), dtype)
        return self.out(x, dtype)


def _inv_sqrt_dim(c: int) -> float:
    """1/sqrt(c) rounded as the reference's fp32 ``1.0 / jnp.sqrt(c)``."""
    return float(np.float32(1.0) / np.sqrt(np.float32(c)))


def all_pairs_correlation(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """(b, c, h, w) x (b, c, H, W) -> (b, h, w, H, W) correlation volume,
    one fp32 matmul per pair (f1 a band of rows of f2's image when row
    sharded)."""
    b, c, h, w = f1.shape
    th, tw = f2.shape[-2:]
    a = f1.reshape(b, c, h * w).transpose(1, 2).to(torch.float32)
    corr = torch.matmul(a, f2.reshape(b, c, th * tw).to(torch.float32))
    return corr.reshape(b, h, w, th, tw) / float(np.sqrt(np.float32(c)))


def build_corr_pyramid(corr: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Average-pool the target dims of the volume (2x2/2, VALID) into a
    pyramid of (b, h, w, th, tw) volumes."""
    b, h, w = corr.shape[:3]
    pyramid = [corr]
    cur = corr.reshape(b * h * w, 1, corr.shape[3], corr.shape[4])
    for _ in range(levels - 1):
        cur = F.avg_pool2d(cur, 2)
        pyramid.append(cur.reshape(b, h, w, cur.shape[2], cur.shape[3]))
    return pyramid


def _row0(h: int) -> int:
    """Global row of this rank's first row of an h-row band inside
    ``layers.row_sharded``; 0 unsharded."""
    rows = current_rows()
    return 0 if rows is None else rows.rank * h


def _grid(h: int, w: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel coordinates (global rows when row sharded)."""
    ys = (torch.arange(h, dtype=torch.float32, device=device)
          + _row0(h))[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return ys, xs


def lookup_corr(pyramid: Sequence[torch.Tensor], flow: torch.Tensor,
                radius: int) -> torch.Tensor:
    """Sample each level of a materialised pyramid in a (2r+1)^2 window
    around x + flow, bilinear with clipped coordinates -> (b, levels *
    (2r+1)^2, h, w)."""
    b, _, h, w = flow.shape
    ys, xs = _grid(h, w, flow.device)
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=flow.device)
    n = 2 * radius + 1
    outs = []
    for lvl, corr in enumerate(pyramid):
        th, tw = corr.shape[3], corr.shape[4]
        scale = 2.0 ** lvl
        cx = (xs + flow[:, 0]) / scale
        cy = (ys + flow[:, 1]) / scale
        gx = torch.clamp(cx[..., None, None] + d[None, :], 0, tw - 1)   # (b,h,w,1,n)
        gy = torch.clamp(cy[..., None, None] + d[:, None], 0, th - 1)   # (b,h,w,n,1)
        x0, y0 = torch.floor(gx), torch.floor(gy)
        fx, fy = gx - x0, gy - y0
        x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
        x1i = torch.clamp(x0i + 1, max=tw - 1)
        y1i = torch.clamp(y0i + 1, max=th - 1)
        flat = corr.reshape(b, h * w, th * tw)

        def tap(yi, xi):
            idx = (yi * tw + xi).expand(b, h, w, n, n).reshape(b, h * w, n * n)
            return torch.gather(flat, 2, idx).reshape(b, h, w, n, n)

        v = ((1 - fx) * (1 - fy) * tap(y0i, x0i) + fx * (1 - fy) * tap(y0i, x1i)
             + (1 - fx) * fy * tap(y1i, x0i) + fx * fy * tap(y1i, x1i))
        outs.append(v.reshape(b, h, w, n * n))
    return torch.cat(outs, -1).permute(0, 3, 1, 2)


def build_feature_pyramid(f2: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Average-pooled fp32 feature maps (b, c, th, tw). Pooling the volume
    over target positions equals correlating against pooled features."""
    pyr = [f2.to(torch.float32)]
    for _ in range(levels - 1):
        pyr.append(F.avg_pool2d(pyr[-1], 2))
    return pyr


def lookup_corr_otf(f1: torch.Tensor, f2_pyramid: Sequence[torch.Tensor],
                    flow: torch.Tensor, radius: int) -> torch.Tensor:
    """Window dot products recomputed from the pooled features each call:
    the features are sampled bilinearly (replicate borders) at every tap,
    then dotted with f1 -> (b, levels * (2r+1)^2, h, w)."""
    b, c, h, w = f1.shape
    ys, xs = _grid(h, w, flow.device)
    f1f = f1.to(torch.float32).permute(0, 2, 3, 1)                 # (b,h,w,c)
    scale_dot = _inv_sqrt_dim(c)
    outs = []
    for lvl, f2l in enumerate(f2_pyramid):
        th, tw = f2l.shape[-2:]
        s = 2.0 ** lvl
        cx = (xs + flow[:, 0]) / s
        cy = (ys + flow[:, 1]) / s
        fmaps = f2l.permute(0, 2, 3, 1)                            # (b,th,tw,c)
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                gx = torch.clamp(cx + dx, 0, tw - 1)
                gy = torch.clamp(cy + dy, 0, th - 1)
                sampled = torch.stack([sample_bilinear_replicate(
                    fmaps[k], gx[k], gy[k]) for k in range(b)])
                outs.append(torch.sum(f1f * sampled, -1) * scale_dot)
    return torch.stack(outs, 1)


def local_volume_extent(lvl: int, radius: int, max_flow: int) -> int:
    """R of pyramid level ``lvl``: the volume spans shifts u, v in [-R, R+1]
    (U = 2R + 2 entries per axis)."""
    return -(-max_flow // (2 ** lvl)) + 1 + radius


def build_local_corr_volumes(f1: torch.Tensor, f2_pyramid: Sequence[torch.Tensor],
                             radius: int, max_flow: int) -> List[torch.Tensor]:
    """Per-frame-pair LOCAL correlation volumes, one (b, h, w, U, U) fp32
    tensor per level: D[y, x, u, v] = <f1(y, x), f2_l(clip(y//s + u - R),
    clip(x//s + v - R))> / sqrt(C).

    For each row shift u one batched matmul of the full-resolution rows of
    f1 that share a pooled row against that row of the edge-padded pooled
    map gives every column product; the band x//s + v is then gathered.
    Row sharded, f1 is this rank's band of rows (its global rows from
    ``_row0``) and the pyramid the whole image's."""
    b, c, h, w = f1.shape
    f1f = f1.to(torch.float32)
    scale_dot = _inv_sqrt_dim(c)
    row0 = _row0(h)
    vols = []
    for lvl, f2l in enumerate(f2_pyramid):
        s = 2 ** lvl
        R = local_volume_extent(lvl, radius, max_flow)
        pad = R + 2
        f2p = F.pad(f2l.to(torch.float32), (pad, pad, pad, pad), mode="replicate")
        twp = f2p.shape[-1]
        # a band starting inside a pooled row is padded up to its start
        off, base = row0 % s, row0 // s
        # ceil sizes: ragged pixels keep their true base index y//s, the
        # edge padding supplies the clamped values
        ky, kx = -(-(h + off) // s), -(-w // s)
        U = 2 * R + 2
        # full-res pixels grouped by pooled row: (b, ky, s*kx*s, c)
        f1g = F.pad(f1f, (0, kx * s - w, off, ky * s - h - off)).permute(0, 2, 3, 1)
        f1g = f1g.reshape(b, ky, s * kx * s, c)
        # band column of pixel (.., X, ..) at shift v: X + v + 2 in f2p
        band = (torch.arange(kx, device=f1.device)[:, None]
                + torch.arange(U, device=f1.device)[None, :] + 2)
        band = band[None, None, None, :, None, :].expand(b, ky, s, kx, s, U)
        per_u = []
        for u in range(U):
            rows = f2p[:, :, base + u + 2:base + u + 2 + ky, :].permute(0, 2, 1, 3)
            m = torch.matmul(f1g, rows).reshape(b, ky, s, kx, s, twp)
            d = torch.gather(m, 5, band).reshape(b, ky * s, kx * s, U)
            per_u.append(d[:, off:off + h, :w])
        vols.append(torch.stack(per_u, 3) * scale_dot)
    return vols


def lookup_corr_volumes(vols: Sequence[torch.Tensor],
                        f2_shapes: Sequence[Tuple[int, int]],
                        flow: torch.Tensor, radius: int) -> torch.Tensor:
    """Window lookup out of the local volumes -> (b, levels * (2r+1)^2, h,
    w): equal to ``lookup_corr_otf`` for |flow| within the volumes'
    coverage; beyond it the window saturates at the volume's edge. The
    bilinear taps are gathered, first along v, then along u; a tap whose
    clipped coordinate pins to the map's border gets fraction 0, as the
    sampler's pre-floor clip gives."""
    b, _, h, w = flow.shape
    ys, xs = _grid(h, w, flow.device)
    d_off = torch.arange(-radius, radius + 1, device=flow.device)
    n = 2 * radius + 1
    outs = []
    for lvl, (D, (th, tw)) in enumerate(zip(vols, f2_shapes)):
        s = float(2 ** lvl)
        U = D.shape[-1]
        lo = -((U - 2) // 2)

        def axis(base, fl, size):
            a = (torch.remainder(base, s) + fl) / s
            sa = torch.floor(a)
            g = a - sa
            cc = ((base + fl) / s)[..., None] + d_off
            g_eff = torch.where((cc >= 0) & (cc <= size - 1), g[..., None],
                                torch.zeros_like(cc))
            j0 = torch.clamp(sa.to(torch.int64)[..., None] + d_off - lo, 0, U - 1)
            j1 = torch.clamp(sa.to(torch.int64)[..., None] + d_off + 1 - lo, 0, U - 1)
            return j0, j1, g_eff                                   # (b,h,w,n)

        jy0, jy1, gy = axis(ys, flow[:, 1], th)
        jx0, jx1, gx = axis(xs, flow[:, 0], tw)
        ex = (b, h, w, U, n)
        t = (torch.gather(D, 4, jx0[:, :, :, None, :].expand(ex)) * (1.0 - gx)[:, :, :, None, :]
             + torch.gather(D, 4, jx1[:, :, :, None, :].expand(ex)) * gx[:, :, :, None, :])
        ey = (b, h, w, n, n)
        out = ((1.0 - gy)[..., None] * torch.gather(t, 3, jy0[..., None].expand(ey))
               + gy[..., None] * torch.gather(t, 3, jy1[..., None].expand(ey)))
        outs.append(out.reshape(b, h, w, n * n))
    return torch.cat(outs, -1).permute(0, 3, 1, 2)


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim: int, input_dim: int) -> None:
        super().__init__()
        self.convz = Conv(hidden_dim + input_dim, hidden_dim, 3)
        self.convr = Conv(hidden_dim + input_dim, hidden_dim, 3)
        self.convq = Conv(hidden_dim + input_dim, hidden_dim, 3)

    def forward(self, h: torch.Tensor, x: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(self.convz(hx, dtype))
        r = torch.sigmoid(self.convr(hx, dtype))
        q = torch.tanh(self.convq(torch.cat([r * h, x], 1), dtype))
        return (1 - z) * h + z * q


class UpdateBlock(nn.Module):
    """Motion encoder, GRU and flow head. The convex-upsample mask head is
    at the RAFT level (``mask_hidden`` / ``mask_head``), run once on the
    final hidden state."""

    def __init__(self, config: RAFTConfig) -> None:
        super().__init__()
        cor = config.corr_levels * (2 * config.corr_radius + 1) ** 2
        self.corr1 = Conv(cor, 96, 1)
        self.corr2 = Conv(96, 64, 3)
        self.flow1 = Conv(2, 64, 7)
        self.flow2 = Conv(64, 32, 3)
        self.motion = Conv(96, 80, 3)
        self.gru = ConvGRU(config.hidden_dim, 82 + config.context_dim)
        self.flow_hidden = Conv(config.hidden_dim, 128, 3)
        self.flow_head = Conv(128, 2, 3)

    def forward(self, hidden, context, corr_feat, flow, dtype):
        c = F.relu(self.corr1(corr_feat.to(dtype), dtype))
        c = F.relu(self.corr2(c, dtype))
        f = F.relu(self.flow1(flow.to(dtype), dtype))
        f = F.relu(self.flow2(f, dtype))
        motion = self.motion(torch.cat([c, f], 1), dtype)
        motion = torch.cat([F.relu(motion), flow.to(dtype)], 1)
        hidden = self.gru(hidden, torch.cat([motion, context], 1), dtype)
        dflow = self.flow_head(
            F.relu(self.flow_hidden(hidden, dtype)).to(torch.float32), torch.float32)
        return hidden, dflow


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """8x upsample of (b, 2, h, w) flow with learned convex combinations of
    its 3x3 neighbours -> (b, 2, 8h, 8w); ``mask`` is (b, 576, h, w), channel
    k*9 + j for sub-pixel k = 8a + b and neighbour j = 3dy + dx."""
    b, _, h, w = flow.shape
    m = torch.softmax(mask.reshape(b, 64, 9, h, w), dim=2)
    rows = current_rows()
    if rows is None:
        pads = F.pad(flow * 8.0, (1, 1, 1, 1), mode="replicate")
    else:
        from mav_detection_tpu_torch.parallel.halo import exchange_rows

        # one neighbour row each way, replicated at the global edges
        pads = F.pad(exchange_rows(flow * 8.0, 1, 1, rows),
                     (1, 1, 1 if rows.rank == 0 else 0,
                      1 if rows.rank == rows.size - 1 else 0), mode="replicate")
    neighbors = torch.stack([pads[:, :, dy:dy + h, dx:dx + w]
                             for dy in range(3) for dx in range(3)], 2)  # (b,2,9,h,w)
    up = torch.sum(m[:, None] * neighbors[:, :, None], 3)                # (b,2,64,h,w)
    return (up.reshape(b, 2, 8, 8, h, w).permute(0, 1, 4, 2, 5, 3)
            .reshape(b, 2, 8 * h, 8 * w))


class RAFT(nn.Module):
    """The net. Weights hold the architecture of ``config``; a call may pass
    another config with the same architecture (the coverage ladder changes
    only the correlation form, the tests the dtype)."""

    def __init__(self, config: RAFTConfig = RAFTConfig()) -> None:
        super().__init__()
        self.config = config
        self.fnet = Encoder(config.feature_dim)
        self.cnet = Encoder(config.hidden_dim + config.context_dim)
        self.update = UpdateBlock(config)
        self.mask_hidden = Conv(config.hidden_dim, 128, 3)
        self.mask_head = Conv(128, 8 * 8 * 9, 1)

    def _config(self, config: Optional[RAFTConfig]) -> RAFTConfig:
        cfg = config or self.config
        for k in _ARCHITECTURE:
            if getattr(cfg, k) != getattr(self.config, k):
                raise ValueError(f"RAFTConfig.{k}={getattr(cfg, k)} does not match "
                                 f"the weights' {getattr(self.config, k)}")
        return cfg

    def forward(self, image1: torch.Tensor, image2: torch.Tensor, iters: int,
                config: Optional[RAFTConfig] = None,
                upsample_all: bool = False) -> torch.Tensor:
        """(b, 3, H, W) fp32 images in [0, 255], H and W multiples of 8 ->
        (b, 2, H, W) flow from image1 to image2; with ``upsample_all`` (the
        training sequence loss) the upsampled prediction of every iteration,
        (iters, b, 2, H, W)."""
        cfg = self._config(config)
        b = image1.shape[0]
        x1 = image1.to(torch.float32) / 127.5 - 1.0
        x2 = image2.to(torch.float32) / 127.5 - 1.0
        feats = self.fnet(torch.cat([x1, x2]), cfg.dtype)
        return self.refine(feats[:b], feats[b:], self.cnet(x1, cfg.dtype), iters, cfg,
                           upsample_all)

    def video(self, frames: torch.Tensor, iters: int,
              config: Optional[RAFTConfig] = None) -> torch.Tensor:
        """(n, 3, H, W) consecutive frames -> (n-1, 2, H, W) flow of every
        transition; each frame goes through fnet once, and every frame but
        the last through cnet once."""
        cfg = self._config(config)
        xs = frames.to(torch.float32) / 127.5 - 1.0
        feats = self.fnet(xs, cfg.dtype)
        return self.refine(feats[:-1], feats[1:], self.cnet(xs[:-1], cfg.dtype),
                           iters, cfg)

    def correlation(self, f1: torch.Tensor, f2: torch.Tensor, cfg: RAFTConfig
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
        """The per-iteration lookup of ``cfg``'s correlation form, with its
        per-pair precompute done."""
        r = cfg.corr_radius
        rows = current_rows()
        if rows is not None:
            # the targets span the whole image: every rank gathers f2 (1/8
            # resolution) and builds its own rows' volumes against it
            from mav_detection_tpu_torch.parallel.halo import gather_rows

            f2 = gather_rows(f2, rows)
        if cfg.materialize_corr:
            pyramid = build_corr_pyramid(all_pairs_correlation(f1, f2), cfg.corr_levels)
            return lambda flow: lookup_corr(pyramid, flow, r)
        fpyr = build_feature_pyramid(f2, cfg.corr_levels)
        vols = build_local_corr_volumes(f1, fpyr, r, cfg.max_flow_lookup)
        shapes = [tuple(p.shape[-2:]) for p in fpyr]
        return lambda flow: lookup_corr_volumes(vols, shapes, flow, r)

    def refine(self, f1: torch.Tensor, f2: torch.Tensor, cnet_out: torch.Tensor,
               iters: int, cfg: RAFTConfig, upsample_all: bool = False) -> torch.Tensor:
        """The GRU refinement and the convex upsample: of the final state,
        or (``upsample_all``) of every iteration's, with the same mask-head
        weights. The flow is not detached between iterations: training
        differentiates through every lookup, as the reference does."""
        dt = cfg.dtype
        hidden = torch.tanh(cnet_out[:, :cfg.hidden_dim])
        context = F.relu(cnet_out[:, cfg.hidden_dim:])
        lookup = self.correlation(f1, f2, cfg)
        b, _, h8, w8 = f1.shape
        flow = torch.zeros((b, 2, h8, w8), dtype=torch.float32, device=f1.device)
        hiddens, flows = [], []
        for _ in range(iters):
            hidden, dflow = self.update(hidden, context, lookup(flow), flow, dt)
            flow = flow + dflow
            if upsample_all:
                hiddens.append(hidden)
                flows.append(flow)
        if upsample_all:
            hidden, flow = torch.cat(hiddens), torch.cat(flows)
        mask = self.mask_head(F.relu(self.mask_hidden(hidden, dt)).to(torch.float32),
                              torch.float32)
        up = convex_upsample(flow, mask)
        return up.reshape(iters, b, *up.shape[1:]) if upsample_all else up


# --------------------------------------------------------------- interface
# Inference default: the banded local volumes (no (h*w)^2 volume)
INFERENCE_CONFIG = RAFTConfig(materialize_corr=False)

# Product iteration count: on the shipped checkpoint fewer GRU iterations
# than the 12 it was trained with are better on small fast movers
PRODUCT_ITERS = 6

_RAFT_CACHE: dict = {}


def _images_nchw(images, device: torch.device) -> torch.Tensor:
    """(n, H, W[, 1|3]) frames -> (n, 3, Hp, Wp) fp32, edge-padded to
    multiples of 8, a gray frame repeated to 3 channels."""
    t = torch.as_tensor(images).to(device)
    if t.ndim == 3:
        t = t[..., None]
    if t.shape[-1] == 1:
        t = t.expand(*t.shape[:-1], 3)
    t = t.permute(0, 3, 1, 2).to(torch.float32)
    h, w = t.shape[-2:]
    ph, pw = (-h) % 8, (-w) % 8
    if ph or pw:
        t = F.pad(t, (0, pw, 0, ph), mode="replicate")
    return t


def _model_device(model: RAFT) -> torch.device:
    return model.mask_head.weight.device


def raft_flow(model: RAFT, image1, image2, iters: int = PRODUCT_ITERS,
              config: RAFTConfig = INFERENCE_CONFIG) -> torch.Tensor:
    """(b, H, W[, 3]) frame pairs, on the model's device -> (b, H, W, 2)
    flow. Pads to multiples of 8 and crops back.

    With the default ``INFERENCE_CONFIG`` the banded volumes are exact only
    for |flow| <= ``8 * max_flow_lookup`` full-res px (16 px) and saturate
    beyond; ``flow_coverage_px`` / ``check_flow_saturation`` detect that and
    the ``_auto`` entry points escalate."""
    iters = iters or PRODUCT_ITERS
    dev = _model_device(model)
    x1, x2 = _images_nchw(image1, dev), _images_nchw(image2, dev)
    h, w = torch.as_tensor(image1).shape[1:3]
    with torch.no_grad():
        flow = model(x1, x2, iters, config)
    return flow[:, :, :h, :w].permute(0, 2, 3, 1).contiguous()


def _default_params(device: Device = "cpu",
                    generator: Optional[torch.Generator] = None) -> RAFT:
    """No-checkpoint fallback: random weights (valid-shaped but
    uninformative flow) drawn from ``generator`` (a CPU generator seeded 0
    when none is given, then cached per device), with a warning."""
    logger.warning(
        "no RAFT checkpoint found — using untrained weights; run "
        "`python -m mav_detection_tpu.cli.train --model raft`")
    key = ("default", str(device))
    if generator is None and key in _RAFT_CACHE:
        return _RAFT_CACHE[key]
    model = RAFT()
    init_params(model, generator if generator is not None
                else torch.Generator().manual_seed(0))
    model = model.to(device)
    if generator is None:
        _RAFT_CACHE[key] = model
    return model


def create_raft(generator: Optional[torch.Generator] = None,
                config: RAFTConfig = RAFTConfig()) -> RAFT:
    """A RAFT of ``config``'s architecture with Flax's default initialisers
    drawn from ``generator`` (seed 0 when none is given), on the CPU."""
    model = RAFT(config)
    init_params(model, generator if generator is not None
                else torch.Generator().manual_seed(0))
    return model


def _resolve_model(model: Optional[RAFT], device: Device) -> Tuple[RAFT, torch.device]:
    dev = resolve_device(device)
    if model is None:
        from mav_detection_tpu_torch.models import pretrained

        model = pretrained.load_raft(dev)
        if model is None:
            model = _default_params(dev)
    elif _model_device(model).type != dev.type:
        raise ValueError(f"RAFT on {dev}: the model's weights are on "
                         f"{_model_device(model)}")
    return model, dev


def raft_flow_batch(images1, images2, model: Optional[RAFT] = None,
                    iters: int = PRODUCT_ITERS,
                    config: RAFTConfig = INFERENCE_CONFIG,
                    device: Device = "cuda") -> torch.Tensor:
    """Batched pair inference on ``device`` -> (b, H, W, 2). With no model,
    the shipped checkpoint (``checkpoints/raft.msgpack``), else random
    weights with a warning."""
    model, dev = _resolve_model(model, device)
    return raft_flow(model, torch.as_tensor(images1).to(dev),
                     torch.as_tensor(images2).to(dev), iters, config)


def raft_flow_video(frames, model: Optional[RAFT] = None,
                    iters: int = PRODUCT_ITERS,
                    config: RAFTConfig = INFERENCE_CONFIG,
                    device: Device = "cuda") -> torch.Tensor:
    """Flow for every consecutive transition of (n, H, W[, 1|3]) frames ->
    (n-1, H, W, 2), each frame encoded once (the pair API encodes every
    interior frame twice). Same checkpoint and math as the pair path."""
    model, dev = _resolve_model(model, device)
    t = torch.as_tensor(frames).to(dev)
    h, w = t.shape[1:3]
    with torch.no_grad():
        flow = model.video(_images_nchw(t, dev), iters or PRODUCT_ITERS, config)
    return flow[:, :, :h, :w].permute(0, 2, 3, 1).contiguous()


def flow_coverage_px(config: RAFTConfig = INFERENCE_CONFIG) -> float:
    """Exact-lookup coverage of the banded local volumes in full-res px
    (infinite for the materialised all-pairs volume)."""
    if config.materialize_corr:
        return float("inf")
    return 8.0 * config.max_flow_lookup


def flow_magnitude_quantile(flow, quantile: float = 0.99,
                            n_real: Optional[int] = None) -> float:
    """numpy's linear-interpolation ``quantile`` of |flow| over the first
    ``n_real`` lanes of (b, H, W, 2) flow, computed where the flow lies: the
    two order statistics come back in one transfer."""
    t = torch.as_tensor(flow)
    mag = torch.linalg.vector_norm(t[:n_real].to(torch.float32), dim=-1).reshape(-1)
    pos = quantile * (mag.numel() - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, mag.numel() - 1)
    a, b = (float(v) for v in torch.stack([
        torch.kthvalue(mag, lo + 1).values, torch.kthvalue(mag, hi + 1).values]).cpu())
    g = pos - lo
    return b - (b - a) * (1 - g) if g >= 0.5 else a + (b - a) * g


def quantile_reaches_sharded(mesh, flow, threshold: float, quantile: float = 0.99,
                             n_real: Optional[int] = None
                             ) -> Tuple[bool, Optional[float]]:
    """Whether the ``quantile`` magnitude (numpy's linear interpolation)
    over the first ``n_real`` lanes of every rank's flow reaches
    ``threshold``, decided as ``flow_magnitude_quantile`` over the ranks'
    lanes together would decide it: one all-reduce of the counts at or
    above the threshold and one of the two order statistics beside it.
    Returns (decision, the quantile where the decision needed it, else
    None)."""
    from mav_detection_tpu_torch.parallel.mesh import all_reduce_sum_

    t = torch.as_tensor(flow)
    mag = torch.linalg.vector_norm(t[:n_real].to(torch.float32), dim=-1).reshape(-1)
    at_or_above = mag >= threshold
    counts = torch.stack([at_or_above.sum(), torch.tensor(mag.numel(), device=mag.device)]
                         ).to(torch.float64)
    inf = torch.tensor(float("inf"), device=mag.device)
    # the largest magnitude below the threshold and the smallest at or above
    # it, both as maxima
    edges = torch.stack([torch.where(at_or_above, -inf, mag).max() if mag.numel() else -inf,
                         (-torch.where(at_or_above, mag, inf)).max() if mag.numel() else -inf])
    all_reduce_sum_(counts, mesh)
    torch.distributed.all_reduce(edges, op=torch.distributed.ReduceOp.MAX,
                                 group=mesh.group)
    c, n = (int(v) for v in counts.cpu())
    if n == 0:
        return False, None
    below, above = (float(v) for v in edges.cpu())
    above = -above
    pos = quantile * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    first = n - c               # sorted index of the first value >= threshold
    if lo >= first:
        return True, None
    if hi < first:
        return False, None
    g = pos - lo
    q = above - (above - below) * (1 - g) if g >= 0.5 else below + (above - below) * g
    return q >= threshold, q


def check_flow_saturation(flow, config: RAFTConfig = INFERENCE_CONFIG,
                          quantile: float = 0.99,
                          n_real: Optional[int] = None, mesh=None) -> bool:
    """True (and a log warning) when the ``quantile`` magnitude of the first
    ``n_real`` lanes reaches >= 90 % of the exact lookup range: beyond it
    the estimate saturates. Only real lanes count: the reference takes the
    quantile over a padded tail's repeated frames too, which dilutes it.
    With ``mesh`` the lanes are this rank's share of a batch and the
    decision is the whole batch's, the same on every rank."""
    cov = flow_coverage_px(config)
    if not np.isfinite(cov):
        return False
    if mesh is not None:
        saturated, q = quantile_reaches_sharded(mesh, flow, 0.9 * cov, quantile, n_real)
    else:
        q = flow_magnitude_quantile(flow, quantile, n_real)
        saturated = q >= 0.9 * cov
    if saturated:
        shown = f"{q:.1f} px" if q is not None else f">= {0.9 * cov:.1f} px"
        logger.warning(
            f"RAFT flow p{int(quantile * 100)} magnitude {shown} is near/"
            f"beyond the local-volume coverage ({cov:.0f} px): estimates "
            "saturate — raise RAFTConfig.max_flow_lookup or use "
            "materialize_corr=True")
        return True
    return False


# Level-0 all-pairs volume budget for the escalation ladder's final rung:
# (h/8*w/8)^2 fp32 per pair. Override via env.
_MATERIALIZE_BUDGET_BYTES = int(
    os.environ.get("MAVTPU_RAFT_MATERIALIZE_BUDGET", 512 << 20))


def _escalate_config(config: RAFTConfig,
                     image_hw: Tuple[int, int]) -> Optional[RAFTConfig]:
    """Next rung of the coverage-escalation ladder, or None when exhausted:
    doubles ``max_flow_lookup`` until the band spans the frame's largest
    dimension, switching to the materialised all-pairs volume when that is
    both smaller than the remaining band and within the budget."""
    if config.materialize_corr:
        return None
    h, w = int(image_hw[0]), int(image_hw[1])
    if 8.0 * config.max_flow_lookup >= float(max(h, w)):
        return None
    doubled = replace(config, max_flow_lookup=config.max_flow_lookup * 2)
    n = (-(-h // 8)) * (-(-w // 8))
    band_px = 8 * (2 * doubled.max_flow_lookup + 1)
    if 4 * n * n <= _MATERIALIZE_BUDGET_BYTES and band_px >= max(h, w) // 2:
        return replace(config, materialize_corr=True)
    return doubled


def _flow_with_escalation(run: Callable[[RAFTConfig], torch.Tensor],
                          images_hw: Tuple[int, int], config: RAFTConfig,
                          n_real: Optional[int] = None, mesh=None) -> torch.Tensor:
    """Run inference, and while the first ``n_real`` lanes saturate the
    banded volumes' coverage, re-run the same batch on the next rung of the
    ladder. One scalar pair comes to the host per rung; the flow stays
    where it was computed. With ``mesh`` the rung is decided once for the
    whole sharded batch, so every rank climbs together."""
    cfg = config
    flow = run(cfg)
    while check_flow_saturation(flow, cfg, n_real=n_real, mesh=mesh):
        nxt = _escalate_config(cfg, images_hw)
        if nxt is None:
            logger.warning(
                "RAFT coverage ladder exhausted at "
                f"max_flow_lookup={cfg.max_flow_lookup} "
                f"materialize_corr={cfg.materialize_corr} — keeping the "
                "widest-coverage estimate")
            break
        logger.info(
            "RAFT flow saturated its lookup coverage — escalating to "
            f"max_flow_lookup={nxt.max_flow_lookup} "
            f"materialize_corr={nxt.materialize_corr} and re-running the batch")
        cfg = nxt
        flow = run(cfg)
    return flow


def raft_flow_batch_auto(images1, images2, model: Optional[RAFT] = None,
                         iters: int = PRODUCT_ITERS,
                         config: RAFTConfig = INFERENCE_CONFIG,
                         device: Device = "cuda",
                         n_real: Optional[int] = None, mesh=None) -> torch.Tensor:
    """``raft_flow_batch`` with coverage escalation on saturation of the
    first ``n_real`` pairs (of every rank's, with ``mesh``)."""
    model, dev = _resolve_model(model, device)
    hw = (int(images1.shape[1]), int(images1.shape[2]))
    return _flow_with_escalation(
        lambda cfg: raft_flow_batch(images1, images2, model, iters, cfg, dev),
        hw, config, n_real, mesh)


def raft_flow_video_auto(frames, model: Optional[RAFT] = None,
                         iters: int = PRODUCT_ITERS,
                         config: RAFTConfig = INFERENCE_CONFIG,
                         device: Device = "cuda",
                         n_real: Optional[int] = None, mesh=None) -> torch.Tensor:
    """``raft_flow_video`` with coverage escalation on saturation of the
    first ``n_real`` transitions (of every rank's, with ``mesh``)."""
    model, dev = _resolve_model(model, device)
    hw = (int(frames.shape[1]), int(frames.shape[2]))
    return _flow_with_escalation(
        lambda cfg: raft_flow_video(frames, model, iters, cfg, dev), hw, config,
        n_real, mesh)


@dataclass(frozen=True)
class TunedRAFT:
    """Resolution-keyed inference operating point: ``scale`` > 1 runs the
    net at (h // scale, w // scale) and upsamples the flow (linear) times
    ``scale``, which brings the motion of large frames back into the range
    the checkpoint was trained at."""

    scale: int = 1
    iters: int = PRODUCT_ITERS
    config: RAFTConfig = INFERENCE_CONFIG


def tuned_raft_config(h: int, w: int) -> TunedRAFT:
    """Native scale up to 752x480, quarter scale above it (the reference's
    operating points, measured on its checkpoint)."""
    if h * w <= 480 * 752:
        return TunedRAFT()
    return TunedRAFT(scale=4)


def _run_scaled(run_auto: Callable[[TunedRAFT], torch.Tensor],
                images_hw: Tuple[int, int],
                tuned: Optional[TunedRAFT]) -> torch.Tensor:
    """Run at the operating point's working scale and bring the flow back
    to ``images_hw``; the saturation check inside ``run_auto`` runs at the
    working scale, where the volumes' coverage is defined."""
    h, w = images_hw
    t = tuned or tuned_raft_config(h, w)
    flow = run_auto(t)
    if t.scale > 1:
        flow = resize_frames(flow, (h, w)) * float(t.scale)
    return flow


def raft_flow_batch_tuned(images1, images2, model: Optional[RAFT] = None,
                          tuned: Optional[TunedRAFT] = None,
                          device: Device = "cuda",
                          n_real: Optional[int] = None, mesh=None) -> torch.Tensor:
    """Product entry point for pair batches: ``tuned_raft_config`` picks the
    working scale and iterations, inference runs through the escalation
    ladder, the flow comes back at the input resolution, on ``device``.
    ``mesh``: the pairs are this rank's lanes of a sharded batch."""
    dev = resolve_device(device)
    images1 = torch.as_tensor(images1).to(dev)
    images2 = torch.as_tensor(images2).to(dev)
    h, w = int(images1.shape[1]), int(images1.shape[2])
    t = tuned or tuned_raft_config(h, w)
    if t.scale > 1:
        hw = (h // t.scale, w // t.scale)
        images1, images2 = resize_frames(images1, hw), resize_frames(images2, hw)
    return _run_scaled(
        lambda tt: raft_flow_batch_auto(images1, images2, model, tt.iters,
                                        tt.config, dev, n_real, mesh), (h, w), t)


def raft_flow_video_tuned(frames, model: Optional[RAFT] = None,
                          tuned: Optional[TunedRAFT] = None,
                          device: Device = "cuda",
                          n_real: Optional[int] = None, mesh=None) -> torch.Tensor:
    """Product entry point for contiguous frame chains (shared per-frame
    encoding through ``raft_flow_video``); ``mesh``: the chain is this
    rank's lanes of a sharded batch."""
    dev = resolve_device(device)
    frames = torch.as_tensor(frames).to(dev)
    h, w = int(frames.shape[1]), int(frames.shape[2])
    t = tuned or tuned_raft_config(h, w)
    if t.scale > 1:
        frames = resize_frames(frames, (h // t.scale, w // t.scale))
    return _run_scaled(
        lambda tt: raft_flow_video_auto(frames, model, tt.iters, tt.config, dev,
                                        n_real, mesh), (h, w), t)


# ---------------------------------------------------------------- training
def raft_loss(model: RAFT, img1: torch.Tensor, img2: torch.Tensor,
              flow_gt: torch.Tensor, gamma: float = 0.8, iters: int = 12,
              pixel_weight: Optional[torch.Tensor] = None,
              config: Optional[RAFTConfig] = None) -> torch.Tensor:
    """The reference's sequence L1 loss (RAFT eq. 7) of each example:
    (b, H, W, 3) images in [0, 255] (H, W multiples of 8), (b, H, W, 2) GT
    flow, optional (b, H, W) pixel weights -> (b,) losses. The prediction of
    iteration i of n weighs ``gamma ** (n - 1 - i)``; with ``pixel_weight``
    each iteration's L1 is the weighted mean over pixels and both flow
    components. Runs in ``config``'s dtype (the model's own by default)."""
    preds = model(img1.permute(0, 3, 1, 2), img2.permute(0, 3, 1, 2), iters,
                  config, upsample_all=True)                    # (n, b, 2, H, W)
    n = preds.shape[0]
    weights = gamma ** torch.arange(n - 1, -1, -1, dtype=torch.float32,
                                    device=preds.device)
    err = torch.abs(preds - flow_gt.permute(0, 3, 1, 2)[None])
    if pixel_weight is not None:
        w = pixel_weight[None, :, None].to(torch.float32)
        per_iter = (torch.sum(err * w, dim=(2, 3, 4))
                    / (torch.sum(w, dim=(2, 3, 4)) * err.shape[2]))
    else:
        per_iter = torch.mean(err, dim=(2, 3, 4))
    return torch.sum(weights[:, None] * per_iter, dim=0)


def make_train_step(model: RAFT, optimizer, iters: int = 12,
                    config: Optional[RAFTConfig] = None):
    """A (img1, img2, flow_gt) -> loss step: the mean of the per-example
    losses, its gradient, one update of ``optimizer`` (a
    ``models.optim.TrainOptimizer``). The loss stays on the device."""

    def train_step(img1, img2, flow_gt):
        optimizer.zero_grad()
        loss = raft_loss(model, img1, img2, flow_gt, iters=iters, config=config).mean()
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step
