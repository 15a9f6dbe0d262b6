"""Cross-domain (out-of-family) evaluation of the learned models.

The port of ``tools/cross_domain_eval.py``. RAFT, the sky net, TinyYOLO, LK
dense flow and Farneback are scored on two renderers that are not the
family the nets train on, both with exact GT:

* the bench scene family (blurred-noise texture, radial expansion plus
  rotation, analytic GT flow), scaled to the frame as the reference scales
  it, seeds 1..``--seeds``;
* mock-simulator captures (ray-cast ground plane and sky, 6 pairs at
  128x96), GT flow from the view-projection matrices and depth by
  ``data/airsim_flow.calculate_flow`` on the device; the sky/ground horizon
  band is excluded from the flow EPE as the reference excludes it.

Farneback runs the tool's own ``FarnebackParams(warp="auto", fast=True,
levels=2, pyr_scale=0.5)`` (tensor code: the port's ``auto`` computes both
warps and picks per refit). The scene renderer is an argument
(``scene=``): the package renders with scipy (``data/scene.py``), whose
pixels differ slightly from the reference's cv2 render, so a caller holding
the two packages to each other passes ``bench.make_scene``::

    python -m mav_detection_tpu_torch.tools.cross_domain_eval [--hw 240x320]
        [--seeds 3] [--iters 0]

``--device cpu`` runs the plain versions.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mav_detection_tpu_torch.ops.flow.farneback import FarnebackParams
from mav_detection_tpu_torch.tools.common import (
    best_iou,
    dumps,
    hw,
    masked_epe,
    mean_or_none,
    parser,
)
from mav_detection_tpu_torch.utils.device import resolve_device

BENCH_H, BENCH_W = 480, 752       # the bench scene's own frame (bench.py H, W)
FOE = (310.0, 190.0)
EXPANSION = 0.016
SIM_HW = (96, 128)
SIM_PAIRS = 6
SIM_DT = 0.12


# the tool's own Farneback parameters (not ``tuned_flow_params``)
PARAMS = FarnebackParams(warp="auto", fast=True, levels=2, pyr_scale=0.5)


def _nets(raft, dev):
    from mav_detection_tpu_torch.models import pretrained

    raft = raft if raft is not None else pretrained.load_raft(dev)
    return raft, pretrained.load_sky(dev), pretrained.load_yolo(None, dev)


def _raft(model, a: np.ndarray, b: np.ndarray, iters: int) -> np.ndarray:
    from mav_detection_tpu_torch.models.raft import raft_flow

    return raft_flow(model, a[None], b[None], iters=iters)[0].cpu().numpy()


def _farneback(a: np.ndarray, b: np.ndarray, dev) -> np.ndarray:
    from mav_detection_tpu_torch.ops.flow.farneback import farneback_flow

    return farneback_flow(a.astype(np.float32), b.astype(np.float32), PARAMS,
                          device=dev).cpu().numpy()


def _sky_rates(model, frame: np.ndarray, sky_gt: np.ndarray, dev, floor: int = 0):
    """(TPR, FPR) of the sky net's mask; ``floor`` 1 guards empty classes
    as the reference's mock-sim scoring does."""
    from mav_detection_tpu_torch.models.sky_segmentation import sky_mask

    est = sky_mask(model, frame, dev).cpu().numpy()
    tpr = float((est & sky_gt).sum() / max(sky_gt.sum(), floor))
    fpr = float((est & ~sky_gt).sum() / max((~sky_gt).sum(), floor))
    return tpr, fpr


def _yolo_iou(model, frame: np.ndarray, gt_rect) -> float:
    from mav_detection_tpu_torch.models.yolo import boxes_to_host, detect_boxes

    return best_iou(boxes_to_host(detect_boxes(model, frame)), gt_rect)


def bench_geometry(h: int, w: int):
    """(FoE, drone centre, drone radius, scale) of the bench scene at (h, w),
    scaled from its own frame as the reference scales them."""
    scale = min(h / BENCH_H, w / BENCH_W)
    return ((FOE[0] * w / BENCH_W, FOE[1] * h / BENCH_H),
            (170.0 * w / BENCH_W, 120.0 * h / BENCH_H), max(10.0 * scale, 4.0), scale)


def disc(h: int, w: int, pos, r: float) -> np.ndarray:
    """The pixels within ``r`` of ``pos`` (x, y)."""
    return ((np.arange(w)[None, :] - pos[0]) ** 2
            + (np.arange(h)[:, None] - pos[1]) ** 2 <= r ** 2)


def bench_scene_metrics(h: int, w: int, seeds: Sequence[int], iters: int = 0, raft=None,
                        scene: Optional[Callable] = None, device=None) -> dict:
    """Flow EPE (overall and drone region), sky TPR / FPR and YOLO IoU on
    the bench family at (h, w), each the mean over ``seeds``. ``raft`` (a
    ``models.raft.RAFT`` on the device) overrides the shipped checkpoint, as
    when scoring a candidate; ``scene`` is the renderer (``make_scene``'s
    signature), ``data/scene.make_scene`` when None."""
    from mav_detection_tpu_torch.core.rectangle import Rectangle
    from mav_detection_tpu_torch.ops.flow.lucas_kanade import lk_dense_flow

    if scene is None:
        from mav_detection_tpu_torch.data.scene import make_scene as scene
    dev = resolve_device(device if device is not None else "cuda")
    raft, sky, yolo = _nets(raft, dev)
    foe, pos, r, scale = bench_geometry(h, w)
    drone = disc(h, w, pos, r)
    out = {k: [] for k in ("raft_epe", "raft_drone_epe", "fb_epe", "lk_epe",
                           "sky_tpr", "sky_fpr", "yolo_iou")}
    for seed in seeds:
        prev8, curr8, gt = scene(seed, h=h, w=w, foe=foe, expansion=EXPANSION,
                                 drone_pos=pos, drone_vel=(4.0 * scale, 2.5 * scale),
                                 drone_radius=r)
        interior = np.zeros((h, w), bool)
        interior[16:-16, 16:-16] = True
        if raft is not None:
            fl = _raft(raft, prev8, curr8, iters)
            out["raft_epe"].append(masked_epe(fl, gt, interior))
            out["raft_drone_epe"].append(masked_epe(fl, gt, drone))
        out["fb_epe"].append(masked_epe(_farneback(prev8, curr8, dev), gt, interior))
        g0, g1 = (torch.as_tensor(x, dtype=torch.float32).to(dev) for x in (prev8, curr8))
        out["lk_epe"].append(masked_epe(lk_dense_flow(g0, g1).cpu().numpy(), gt, interior))
        sky_gt = np.zeros((h, w), bool)
        sky_gt[: int(0.35 * h)] = True
        frame = np.repeat(prev8[..., None], 3, -1)
        if sky is not None:
            tpr, fpr = _sky_rates(sky, frame, sky_gt, dev)
            out["sky_tpr"].append(tpr)
            out["sky_fpr"].append(fpr)
        if yolo is not None:
            gt_rect = Rectangle((pos[0] - r, pos[1] - r), (2 * r, 2 * r))
            out["yolo_iou"].append(_yolo_iou(yolo, frame, gt_rect))
    return {k: mean_or_none(v) for k, v in out.items()}


def _horizon_interior(depth_m: np.ndarray, h: int, w: int) -> np.ndarray:
    """The 6-px interior less a 2-row band around the sky/ground depth
    jump, which every flow method smooths across."""
    interior = np.zeros((h, w), bool)
    interior[6:-6, 6:-6] = True
    ddepth = np.abs(np.diff(depth_m, axis=0, prepend=depth_m[:1]))
    horizon = ddepth > 500.0
    for _ in range(2):
        horizon[1:] |= horizon[:-1]
        horizon[:-1] |= horizon[1:]
    return interior & ~horizon


def mock_captures(h: int = SIM_HW[0], w: int = SIM_HW[1], n_pairs: int = SIM_PAIRS):
    """(responses, states) of the reference's ``n_pairs + 1`` mock captures:
    observer and target flying level, ``SIM_DT`` s apart."""
    from mav_detection_tpu_torch.sim.client import MockSimClient, Vector3

    c = MockSimClient(image_hw=(h, w), fov_deg=100, target_radius_m=0.7)
    c.set_pose("Drone1", Vector3(0.0, 0.0, -6.0), 0.05)
    c.set_pose("Drone2", Vector3(7.0, 1.0, -5.5), 0.0)
    for d in c.drones.values():
        d.landed = False
    c.drones["Drone1"].velocity = np.array([2.0, 0.3, 0.0])
    c.drones["Drone2"].velocity = np.array([-1.2, 0.8, 0.0])
    frames, states = [], []
    for _ in range(n_pairs + 1):
        frames.append({r.image_type: r for r in c.capture("Drone1")})
        states.append({v: c.get_state(v) for v in ("Drone1", "Drone2")})
        c.continue_for_time(SIM_DT)
    return frames, states


def mock_sim_metrics(h: int = SIM_HW[0], w: int = SIM_HW[1], iters: int = 0, raft=None,
                     device=None) -> dict:
    """Flow EPE against the matrices-and-depth GT on mock-simulator
    captures, YOLO IoU against the segmentation box, sky TPR / FPR against
    the far-depth band, each the mean over the pairs. ``raft`` overrides the
    shipped checkpoint: a candidate's evaluation must pass it, or the gate
    compares the shipped weights with themselves."""
    from mav_detection_tpu_torch.data.airsim_flow import calculate_flow, parse_view_proj
    from mav_detection_tpu_torch.ops.image.boxes import get_simple_bounding_box

    dev = resolve_device(device if device is not None else "cuda")
    raft, sky, yolo = _nets(raft, dev)
    frames, states = mock_captures(h, w)
    out = {k: [] for k in ("raft_epe", "raft_drone_epe", "fb_epe",
                           "sky_tpr", "sky_fpr", "yolo_iou")}
    for i in range(len(frames) - 1):
        r1, r2, s1 = frames[i], frames[i + 1], states[i]
        vp1, vp2 = parse_view_proj(s1), parse_view_proj(states[i + 1])
        seg1 = r1["segmentation"].data[..., 0]
        vel = s1["Drone2"]["ue4"]["linearVelocity"]
        disp = np.array([vel["X"], vel["Y"], vel["Z"]]) * SIM_DT * 100.0

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype).to(dev)

        gt = calculate_flow(t(vp1), t(vp2), (w, h), t(r1["depth"].data * 100.0), t(disp),
                            t(seg1, torch.uint8)).cpu().numpy()
        interior = _horizon_interior(r1["depth"].data, h, w)
        drone = seg1 > 0
        f1, f2 = r1["scene"].data, r2["scene"].data
        if raft is not None:
            fl = _raft(raft, f1, f2, iters)
            out["raft_epe"].append(masked_epe(fl, gt, interior))
            if drone.any():
                out["raft_drone_epe"].append(masked_epe(fl, gt, drone))
        out["fb_epe"].append(masked_epe(_farneback(f1[..., 0], f2[..., 0], dev), gt, interior))
        if sky is not None:
            tpr, fpr = _sky_rates(sky, f1, r1["depth"].data >= 9000.0, dev, floor=1)
            out["sky_tpr"].append(tpr)
            out["sky_fpr"].append(fpr)
        if yolo is not None and drone.any():
            out["yolo_iou"].append(_yolo_iou(yolo, f1, get_simple_bounding_box(
                r1["segmentation"].data)))
    return {k: mean_or_none(v) for k, v in out.items()}


def main(argv=None, device=None, scene: Optional[Callable] = None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--hw", type=hw, default=(240, 320), metavar="HxW")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=0, help="0 = the product default")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    h, w = args.hw
    t0 = time.perf_counter()
    bench_m = bench_scene_metrics(h, w, range(1, 1 + args.seeds), iters=args.iters,
                                  scene=scene, device=dev)
    print(f"bench-family ({w}x{h}, {args.seeds} seeds): {dumps(bench_m)}")
    sim_m = mock_sim_metrics(iters=args.iters, device=dev)
    print(f"mock-sim ({SIM_HW[1]}x{SIM_HW[0]}, {SIM_PAIRS} pairs): {dumps(sim_m)}")
    secs = time.perf_counter() - t0
    print(f"({secs:.1f}s)")
    res = {"device": str(dev), "hw": f"{h}x{w}", "seeds": args.seeds, "iters": args.iters,
           "bench": bench_m, "sim": sim_m, "seconds": secs}
    print(dumps(res))
    return res


if __name__ == "__main__":
    main()
