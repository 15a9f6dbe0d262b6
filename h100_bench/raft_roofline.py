"""The operations of one published-RAFT flow call, counted from the
configuration's widths, and the H100's peak they are held against
(``raft_mfu``).

Two operations per multiply-add of every convolution (fnet on both frames
of a pair, cnet on the first; per iteration the motion encoder, the
``SepConvGRU`` and the flow head; the mask head once, as the program runs
it) and of the all-pairs correlation matmul, at the frame size padded to
multiples of 8. The lookups, the pooling, the norms, the activations and
the upsample count nothing, so the share of the peak is never above what
the card did.

Peak: NVIDIA H100 SXM data sheet at 700 W, 989.4 TFLOP/s dense BF16.
"""
from __future__ import annotations

from typing import Mapping, Tuple

BF16_FLOPS_PER_S = 989.4e12


def _out(n: int, k: int, stride: int) -> int:
    """Output size of a convolution padded k // 2 on both sides."""
    return (n + 2 * (k // 2) - k) // stride + 1


def conv_flops(h: int, w: int, cin: int, cout: int, k: Tuple[int, int],
               stride: int = 1) -> Tuple[float, int, int]:
    """(operations, output height, output width) of one image's
    convolution."""
    ho, wo = _out(h, k[0], stride), _out(w, k[1], stride)
    return 2.0 * ho * wo * cout * cin * k[0] * k[1], ho, wo


def encoder_flops(h: int, w: int, raft: Mapping, out_dim: int) -> Tuple[float, int, int]:
    """One image through ``BasicEncoder``: the 7x7 stride-2 stem, two
    residual blocks per layer (the first of layers 2 and 3 at stride 2 with
    a 1x1 downsample), the 1x1 output; (operations, h/8, w/8)."""
    stem, *layers = (int(d) for d in raft["encoder_dims"])
    total, h, w = conv_flops(h, w, 3, stem, (7, 7), 2)
    cin = stem
    for i, planes in enumerate(layers):
        stride = 1 if i == 0 else 2
        for j in range(2):
            s = stride if j == 0 else 1
            src = cin if j == 0 else planes
            f1, ho, wo = conv_flops(h, w, src, planes, (3, 3), s)
            f2, _, _ = conv_flops(ho, wo, planes, planes, (3, 3))
            total += f1 + f2
            if s != 1:
                total += conv_flops(h, w, src, planes, (1, 1), s)[0]
            h, w = ho, wo
        cin = planes
    total += conv_flops(h, w, cin, out_dim, (1, 1))[0]
    return total, h, w


def update_flops(h8: int, w8: int, raft: Mapping) -> float:
    """One iteration of one pair: motion encoder, ``SepConvGRU``, flow
    head."""
    me = raft["motion_encoder"]
    (c1, c2), (f1, f2), mo = me["corr"], me["flow"], int(me["out"])
    hid, ctx = int(raft["hidden_dim"]), int(raft["context_dim"])
    cor = int(raft["corr_levels"]) * (2 * int(raft["corr_radius"]) + 1) ** 2
    head = int(raft["flow_head_dim"])
    convs = [(cor, c1, (1, 1)), (c1, c2, (3, 3)), (2, f1, (7, 7)), (f1, f2, (3, 3)),
             (c2 + f2, mo, (3, 3))]
    gin = hid + ctx + mo + 2
    convs += [(gin, hid, (1, 5))] * 3 + [(gin, hid, (5, 1))] * 3
    convs += [(hid, head, (3, 3)), (head, 2, (3, 3))]
    return sum(conv_flops(h8, w8, cin, cout, k)[0] for cin, cout, k in convs)


def mask_flops(h8: int, w8: int, raft: Mapping) -> float:
    up = int(raft["upsample"])
    hid, m = int(raft["hidden_dim"]), int(raft["mask_head_dim"])
    return (conv_flops(h8, w8, hid, m, (3, 3))[0]
            + conv_flops(h8, w8, m, up * up * 9, (1, 1))[0])


def pair_flops(config: Mapping) -> float:
    """Operations of one frame pair at the configuration's frame size."""
    raft = config["raft"]
    h = -(-int(config["height"]) // 8) * 8
    w = -(-int(config["width"]) // 8) * 8
    fnet, h8, w8 = encoder_flops(h, w, raft, int(raft["feature_dim"]))
    cnet, _, _ = encoder_flops(h, w, raft, int(raft["hidden_dim"]) + int(raft["context_dim"]))
    corr = 2.0 * (h8 * w8) ** 2 * int(raft["feature_dim"])
    return (2 * fnet + cnet + corr + int(raft["iters"]) * update_flops(h8, w8, raft)
            + mask_flops(h8, w8, raft))
