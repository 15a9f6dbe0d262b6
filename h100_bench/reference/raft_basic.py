"""Plain float32 RAFT at its published widths: the yardstick of the Flow
layer in the configurations that name ``flow_reference: raft_basic``.

A frozen copy of the published forward (Teed & Deng, ECCV 2020,
arXiv:2003.12039; princeton-vl/RAFT ``core/raft.py`` with ``args.small``
False, ``core/extractor.py::BasicEncoder``, ``core/update.py::
BasicUpdateBlock`` / ``SepConvGRU`` / ``BasicMotionEncoder``,
``core/corr.py::CorrBlock``) in plain ``torch`` functions over a dict of
weights under the published state-dict names; it imports nothing of the
program. Run in float32 with TF32 off in both ``torch.backends.cuda.matmul``
and ``torch.backends.cudnn`` for the call, restored after.

``flow(prev, curr, config, weights)``: (b, h, w) gray uint8 frames (repeated
to 3 channels) or (b, h, w, 3) ones, padded at the bottom and right to
multiples of 8 by repeating the edge (the published ``InputPadder`` centres
the padding; the configurations' frame sizes need none), normalised as
``2 * (x / 255) - 1``; fnet (instance norm) on both frames, cnet (batch
norm in eval mode) on the first; the all-pairs volume ``fmap1^T fmap2 /
sqrt(256)`` and its 4-level average-pooled pyramid; ``iters`` iterations of
the lookup (``grid_sample(align_corners=True)``, zeros outside, taps x
offset first), the motion encoder, ``SepConvGRU`` and the flow head, the
coordinates carried as ``coords1``; then the convex 8x upsample of the
final flow (``F.unfold``, zeros beyond the border) with the mask of the
final hidden state, scaled by 0.25: the published loop's last ``up_mask``
(computed once here, at the last iteration) -> (b, h, w, 2) float32. The
configuration's ``raft`` block gives the widths and ``iters``.

``weights(config, seed, device)``: float32 tensors under the published
names, drawn on the CPU from one ``torch.Generator`` seeded with ``seed``,
conv by conv in the published module order (fnet, cnet, update_block;
weight then bias), then moved to ``device``. The published initialisation:
the encoders' kernels ``kaiming_normal_(mode="fan_out",
nonlinearity="relu")``, every other kernel and every bias PyTorch's
default, uniform within 1/sqrt(fan_in); batch norm weight 1, bias 0,
running mean 0, running variance 1 (and its int64 ``num_batches_tracked``
0, so that the dict loads strictly).

``CONTROL_PRECISION = "bf16"``: the same forward with every part in
bfloat16: the convolutions (the flow and mask heads among them, as the
configuration runs them), and also what the configuration keeps in
float32, the volume and its pyramid, the lookup's coordinates and taps, the
flow and the upsample (the sampler rounds its inputs and its result to
bfloat16; the norms' statistics stay float32).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

CONTROL_PRECISION = "bf16"
# the published fixed widths: encoder stem and layers, motion encoder
# (correlation 256 -> 192, flow 128 -> 64, out 126), flow head, mask head
STEM, LAYERS = 64, ((64, 1), (96, 2), (128, 2))
MOTION = (256, 192, 128, 64, 126)
HEAD, MASK = 256, 256
EPS = 1e-5


# ------------------------------------------------------------ weights
def _convs(raft: Mapping) -> List[Tuple[str, Tuple[int, ...], bool]]:
    """(name, kernel shape, is an encoder's) of every convolution, in the
    published module order."""
    out: List[Tuple[str, Tuple[int, ...], bool]] = []
    hid, ctx = int(raft["hidden_dim"]), int(raft["context_dim"])
    for enc, dim in (("fnet", int(raft["feature_dim"])), ("cnet", hid + ctx)):
        out.append((f"{enc}.conv1", (STEM, 3, 7, 7), True))
        cin = STEM
        for i, (planes, stride) in enumerate(LAYERS, 1):
            for j in range(2):
                src = cin if j == 0 else planes
                out.append((f"{enc}.layer{i}.{j}.conv1", (planes, src, 3, 3), True))
                out.append((f"{enc}.layer{i}.{j}.conv2", (planes, planes, 3, 3), True))
                if j == 0 and stride != 1:
                    out.append((f"{enc}.layer{i}.{j}.downsample.0", (planes, src, 1, 1), True))
            cin = planes
        out.append((f"{enc}.conv2", (dim, cin, 1, 1), True))
    cor = int(raft["corr_levels"]) * (2 * int(raft["corr_radius"]) + 1) ** 2
    c1, c2, f1, f2, mo = MOTION
    e = "update_block.encoder"
    out += [(f"{e}.convc1", (c1, cor, 1, 1), False), (f"{e}.convc2", (c2, c1, 3, 3), False),
            (f"{e}.convf1", (f1, 2, 7, 7), False), (f"{e}.convf2", (f2, f1, 3, 3), False),
            (f"{e}.conv", (mo, c2 + f2, 3, 3), False)]
    gin = hid + ctx + mo + 2
    for step, k in (("1", (1, 5)), ("2", (5, 1))):
        for gate in "zrq":
            out.append((f"update_block.gru.conv{gate}{step}", (hid, gin) + k, False))
    out += [("update_block.flow_head.conv1", (HEAD, hid, 3, 3), False),
            ("update_block.flow_head.conv2", (2, HEAD, 3, 3), False),
            ("update_block.mask.0", (MASK, hid, 3, 3), False),
            ("update_block.mask.2", (64 * 9, MASK, 1, 1), False)]
    return out


def _batch_norms(raft: Mapping) -> List[Tuple[str, int]]:
    """(name, channels) of cnet's batch norms, each under every name the
    published state dict gives it (``norm3`` is also ``downsample.1``)."""
    out = [("cnet.norm1", STEM)]
    for i, (planes, stride) in enumerate(LAYERS, 1):
        for j in range(2):
            out += [(f"cnet.layer{i}.{j}.norm1", planes), (f"cnet.layer{i}.{j}.norm2", planes)]
            if j == 0 and stride != 1:
                out += [(f"cnet.layer{i}.{j}.norm3", planes),
                        (f"cnet.layer{i}.{j}.downsample.1", planes)]
    return out


def weights(config: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    raft = config["raft"]
    g = torch.Generator()
    g.manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    for name, shape, encoder in _convs(raft):
        fan_in = math.prod(shape[1:])
        if encoder:
            std = math.sqrt(2.0 / (shape[0] * math.prod(shape[2:])))
            out[f"{name}.weight"] = torch.randn(shape, generator=g) * std
        else:
            out[f"{name}.weight"] = (torch.rand(shape, generator=g) * 2 - 1) / math.sqrt(fan_in)
        out[f"{name}.bias"] = (torch.rand(shape[:1], generator=g) * 2 - 1) / math.sqrt(fan_in)
    for name, c in _batch_norms(raft):
        out[f"{name}.weight"] = torch.ones(c)
        out[f"{name}.bias"] = torch.zeros(c)
        out[f"{name}.running_mean"] = torch.zeros(c)
        out[f"{name}.running_var"] = torch.ones(c)
        out[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return {k: v.to(device) for k, v in out.items()}


# ------------------------------------------------------------ precision
@contextlib.contextmanager
def _no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _round(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dt`` and held in float32 (the sampler's bf16)."""
    return x.to(dt).to(torch.float32)


# ------------------------------------------------------------ the net
def _conv(x, W, name, dt, stride=1):
    w = W[f"{name}.weight"]
    pad = (w.shape[2] // 2, w.shape[3] // 2)
    return F.conv2d(x.to(dt), w.to(dt), W[f"{name}.bias"].to(dt), stride, pad)


def _norm(x, W, name, kind, dt):
    x = x.to(torch.float32)
    if kind == "instance":
        return F.instance_norm(x, eps=EPS).to(dt)
    return F.batch_norm(x, W[f"{name}.running_mean"], W[f"{name}.running_var"],
                        W[f"{name}.weight"], W[f"{name}.bias"], False, 0.0, EPS).to(dt)


def _encoder(x, W, enc, kind, dt):
    x = F.relu(_norm(_conv(x, W, f"{enc}.conv1", dt, 2), W, f"{enc}.norm1", kind, dt))
    for i, (_, stride) in enumerate(LAYERS, 1):
        for j in range(2):
            p = f"{enc}.layer{i}.{j}"
            s = stride if j == 0 else 1
            y = F.relu(_norm(_conv(x, W, f"{p}.conv1", dt, s), W, f"{p}.norm1", kind, dt))
            y = F.relu(_norm(_conv(y, W, f"{p}.conv2", dt), W, f"{p}.norm2", kind, dt))
            if s != 1:
                x = _norm(_conv(x, W, f"{p}.downsample.0", dt, s), W, f"{p}.norm3", kind, dt)
            x = F.relu(x + y)
    return _conv(x, W, f"{enc}.conv2", dt)


def _sampler(img, coords, dt):
    """``bilinear_sampler``: ``grid_sample(align_corners=True)``, zeros
    outside, at pixel coordinates (x, y). A level one pixel high or wide,
    where ``align_corners`` has no scale, gets a one-pixel zero border
    first, which changes no tap."""
    H, W = img.shape[-2:]
    if H == 1 or W == 1:
        img, coords, H, W = F.pad(img, (1, 1, 1, 1)), coords + 1, H + 2, W + 2
    x, y = coords.split([1, 1], dim=-1)
    grid = torch.cat([2 * x / (W - 1) - 1, 2 * y / (H - 1) - 1], dim=-1).to(dt)
    out = F.grid_sample(_round(img, dt), _round(grid, dt), align_corners=True)
    return out.to(dt)


def _lookup(pyramid, coords, r, dt):
    b, _, h, w = coords.shape
    d = torch.linspace(-r, r, 2 * r + 1, device=coords.device, dtype=dt)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1).view(1, 2 * r + 1,
                                                                          2 * r + 1, 2)
    centroid = coords.permute(0, 2, 3, 1).reshape(b * h * w, 1, 1, 2)
    outs = [_sampler(corr, centroid / 2 ** i + delta, dt).view(b, h, w, -1)
            for i, corr in enumerate(pyramid)]
    return torch.cat(outs, dim=-1).permute(0, 3, 1, 2)


def _gru(h, x, W, dt):
    for step in "12":
        g = f"update_block.gru.conv{{}}{step}"
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(_conv(hx, W, g.format("z"), dt))
        r = torch.sigmoid(_conv(hx, W, g.format("r"), dt))
        q = torch.tanh(_conv(torch.cat([r * h, x], 1), W, g.format("q"), dt))
        h = (1 - z) * h + z * q
    return h


def _update(net, inp, corr, flow, W, dt):
    e = "update_block.encoder"
    cor = F.relu(_conv(F.relu(_conv(corr, W, f"{e}.convc1", dt)), W, f"{e}.convc2", dt))
    flo = F.relu(_conv(F.relu(_conv(flow, W, f"{e}.convf1", dt)), W, f"{e}.convf2", dt))
    out = F.relu(_conv(torch.cat([cor, flo], 1), W, f"{e}.conv", dt))
    net = _gru(net, torch.cat([inp, out, flow], 1), W, dt)
    h = "update_block.flow_head"
    delta = _conv(F.relu(_conv(net, W, f"{h}.conv1", dt)), W, f"{h}.conv2", dt)
    return net, delta


def _upsample(flow, mask):
    n, _, h, w = flow.shape
    m = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(m * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, 2, 8 * h, 8 * w)


def _forward(image1, image2, raft, W, dt):
    hid = int(raft["hidden_dim"])
    x1 = 2 * (image1 / 255.0) - 1.0
    x2 = 2 * (image2 / 255.0) - 1.0
    b = x1.shape[0]
    fmaps = _encoder(torch.cat([x1, x2]), W, "fnet", "instance", dt)
    f1, f2 = fmaps[:b].to(dt), fmaps[b:].to(dt)
    c, h8, w8 = f1.shape[1:]
    corr = torch.matmul(f1.reshape(b, c, h8 * w8).transpose(1, 2), f2.reshape(b, c, h8 * w8))
    corr = (corr / math.sqrt(c)).reshape(b * h8 * w8, 1, h8, w8)
    pyramid = [corr]
    for _ in range(int(raft["corr_levels"]) - 1):
        pyramid.append(F.avg_pool2d(pyramid[-1], 2, stride=2))
    cnet = _encoder(x1, W, "cnet", "batch", dt)
    net, inp = torch.tanh(cnet[:, :hid]), torch.relu(cnet[:, hid:])
    ys, xs = torch.meshgrid(torch.arange(h8, device=x1.device),
                            torch.arange(w8, device=x1.device), indexing="ij")
    coords0 = torch.stack([xs, ys]).to(dt)[None].repeat(b, 1, 1, 1)
    coords1 = coords0.clone()
    for _ in range(int(raft["iters"])):
        corr_feat = _lookup(pyramid, coords1, int(raft["corr_radius"]), dt)
        net, delta = _update(net, inp, corr_feat, coords1 - coords0, W, dt)
        coords1 = coords1 + delta
    m = "update_block.mask"
    mask = 0.25 * _conv(F.relu(_conv(net, W, f"{m}.0", dt)), W, f"{m}.2", dt)
    return _upsample(coords1 - coords0, mask)


def _images(frames: torch.Tensor) -> torch.Tensor:
    t = frames if frames.ndim == 4 else frames[..., None].expand(*frames.shape, 3)
    t = t.permute(0, 3, 1, 2).to(torch.float32)
    h, w = t.shape[-2:]
    return F.pad(t, (0, (-w) % 8, 0, (-h) % 8), mode="replicate") if (h % 8 or w % 8) else t


def flow(prev: torch.Tensor, curr: torch.Tensor, config: Mapping,
         weights: Mapping[str, torch.Tensor], precision: str = "fp32") -> torch.Tensor:
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"precision {precision!r}: fp32 or bf16")
    dt = torch.bfloat16 if precision == "bf16" else torch.float32
    h, w = prev.shape[1:3]
    with _no_tf32(), torch.no_grad():
        up = _forward(_images(prev), _images(curr), config["raft"], weights, dt)
    return up[:, :, :h, :w].permute(0, 2, 3, 1).to(torch.float32).contiguous()
