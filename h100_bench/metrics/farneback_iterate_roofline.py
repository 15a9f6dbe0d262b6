"""``farneback_iterate_roofline`` (Iterate kernel, moves
``step_frames_per_s``): the least time of the program's public
``farneback_iterate`` at the cell's finest layer (batch, height, width, the
configuration's winsize, finest-layer iterations and max_shift), by the
bytes and operations the iteration needs at the H100's published peaks
(``roofline``), as a percentage of its time in a replayed CUDA graph (CUDA
events). Its inputs: the finest layer's coefficients of a fixed batch of
the ring (the reference's expansion) and the program's own flow of it. None
outside a step cell or off the card."""
from __future__ import annotations

import torch

from h100_bench import roofline, timing
from h100_bench.reference import farneback as ref
from mav_detection_tpu_torch.ops.flow.farneback_iter import farneback_iterate

REPS = 50


def read(run):
    st = run.state
    if run.device.type != "cuda" or "flow_of" not in st:
        return None
    fp = run.config["flow"]
    B = st["batch"]
    prev, curr = st["frames"][:B], st["frames"][1:B + 1]
    _, h, w = prev.shape
    smooth = ref.gaussian_kernel(3, 0.0)
    n, sigma = int(fp["poly_n"]), float(fp["poly_sigma"])
    with torch.no_grad():
        R0 = ref.poly_expand(prev.float(), smooth, h, w, n, sigma, "fp32").contiguous()
        R1 = ref.poly_expand(curr.float(), smooth, h, w, n, sigma, "fp32").contiguous()
    flow0 = st["flow_of"](prev, curr).permute(0, 3, 1, 2).contiguous()
    border = torch.from_numpy(ref.border_map(h, w)).to(run.device)
    iters = ref.level_iterations(fp, 0)
    ms = timing.graph_ms(lambda: farneback_iterate(
        R0, R1, flow0, border, iterations=iters, winsize=int(fp["winsize"]),
        max_shift=int(fp["max_shift"])), REPS)
    bound, _ = roofline.iterate_bound_ms(B, h, w, int(fp["winsize"]), iters)
    return 100.0 * bound / ms
