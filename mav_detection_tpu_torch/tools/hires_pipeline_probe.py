"""Probe: the product loop end to end at the reference's 1920x1024.

The port of ``tools/hires_pipeline_probe.py``. It runs the CLI's Processor
loop (PNG decode on the staging thread, the upload, flow and detection on
the card, FrameResult JSON and, unless ``--no-images``, the debug images)
on a mock-simulator sequence materialised in the reference's AirSim
directory layout (``sim/``), and reports the ``Tracer`` stage breakdown,
the staging thread's host seconds and whether they overlapped the main
thread's stages (``overlap_proven``: both fit inside the wall only if they
ran at once). A cold pass runs first; the numbers are the second pass's.

The link canary times one upload of a float32 host buffer and one download
of a float32 tensor computed on the card (a constant could short-circuit
the copy), host clock around synchronised copies, and divides the bytes the
buffer holds (``h2d_bytes``, the numerator) by each time. The upload is
pageable, as the loop's side arrays are.

The sequence materialises under ``--data-root`` (idempotent: a collected
sequence is reused), by default a fresh temporary directory removed at the
end; never under the repository::

    python -m mav_detection_tpu_torch.tools.hires_pipeline_probe
        [--size 1024x1920] [--frames 25] [--batch 8] [--no-images]
        [--no-gt-flow] [--data-root DIR]

``--device cpu`` (the tool's ``--cpu``) runs the loop on the host and
measures no link.
"""
from __future__ import annotations

import glob
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from mav_detection_tpu_torch.tools.common import dumps, hw, parser, simdata_path
from mav_detection_tpu_torch.utils.device import resolve_device
from mav_detection_tpu_torch.utils.timing import device_name

COLLECTION = {
    "orientations": ["north"],
    "locations": {"probefield": {"x": 0.0, "y": 0.0, "z": -2.0}},
    "orbit_speed": [2.0],
    "global_speed": {"default": {"lin_x": 1.2, "sin_y": 0.0, "sin_z": 0.0}},
    "heights": {"low": 3.0},
    "radii": [15.0],
    "modes": ["collision"],
    "collision_angles": [10.0],
}
CANARY_BYTES = 32 << 20


def materialize(root: str, size, frames: int) -> str:
    """Collect a mock-sim sequence of ``frames`` captures at ``size`` under
    ``root`` (skipped where it is there); the sequence path relative to
    ``root``."""
    from mav_detection_tpu_torch.sim import MockSimClient, SimDataCollector

    collector = SimDataCollector(MockSimClient(image_hw=size, fov_deg=100), COLLECTION,
                                 root_data_dir=root, max_iterations=frames)
    if collector.configs:
        seq_dir = collector.get_base_dir(collector.configs[0])
    else:
        # a collected configuration is skipped when the grid is built
        done = [os.path.dirname(p) for p in glob.glob(os.path.join(root, "*", "images"))]
        if not done:
            raise RuntimeError(f"no configuration to fly and no sequence under {root}")
        seq_dir = done[0]
    have = len(glob.glob(os.path.join(seq_dir, "images", "*.png")))
    if have >= frames:
        print(f"# sequence already materialized ({have} frames)")
    else:
        t0 = time.time()
        collector.run()
        print(f"# collected {frames} frames at {size[1]}x{size[0]} in "
              f"{time.time() - t0:.1f}s")
    return os.path.relpath(seq_dir, root)


def link_canary(dev: torch.device, nbytes: int = CANARY_BYTES) -> dict:
    """Host <-> device MB/s each way: a float32 host buffer of ``nbytes``
    uploaded (pageable), and a float32 tensor of ``nbytes`` computed on the
    card downloaded; host clock around synchronised copies. MB/s is the
    buffer's bytes over the time; None on the CPU."""
    host = np.random.default_rng(0).random(nbytes // 4).astype(np.float32)
    out = {"h2d_bytes": int(host.nbytes), "numerator_bytes": nbytes,
           "d2h_bytes": nbytes, "h2d_mbps": None, "d2h_mbps": None}
    if dev.type != "cuda":
        return out
    t_host = torch.from_numpy(host)

    def made(s: float) -> torch.Tensor:
        return torch.sin(torch.arange(nbytes // 4, device=dev, dtype=torch.float32) + s)

    t_host.to(dev)
    made(1.0).cpu()                       # warm both directions
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    up = t_host.to(dev)
    torch.cuda.synchronize(dev)
    out["h2d_mbps"] = nbytes / 2 ** 20 / (time.perf_counter() - t0)
    arr = made(2.0)
    torch.cuda.synchronize(dev)           # computed before the pull starts
    t0 = time.perf_counter()
    arr.cpu()
    out["d2h_mbps"] = nbytes / 2 ** 20 / (time.perf_counter() - t0)
    del up
    return out


def run_probe(root: str, seq: str, batch: int, flow_source: str, save_images: bool,
              dev: torch.device, use_gt_flow: bool = True) -> dict:
    from mav_detection_tpu_torch.core.config import FlowSource, RunConfig
    from mav_detection_tpu_torch.data.sim_data import SimDataset
    from mav_detection_tpu_torch.pipeline.processor import Processor
    from mav_detection_tpu_torch.utils.tracing import Tracer

    cfg = RunConfig(dataset="simulation", sequence=seq, mode="FLOW_FOE_CLUSTERING",
                    flow_source=FlowSource[flow_source], batch_size=batch)
    with simdata_path(root):
        ds = SimDataset(sequence=seq, device=dev)
    if not use_gt_flow:
        ds.get_gt_of = lambda i: None     # no GT-flow fields staged or uploaded
    proc = Processor(cfg, device=dev, dataset=ds)
    proc.save_images = save_images

    def run():
        proc.detection_results = {}
        out = proc.run_detection()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    t0 = time.time()
    run()
    cold_wall = time.time() - t0
    proc.tracer = Tracer()
    t0 = time.time()
    results = run()
    wall = time.time() - t0
    stages = proc.tracer.as_dict()
    n = len(results)
    h, w = ds.capture_shape[:2]
    # the fields each batch moves: up, B+1 gray frames (and B GT flows);
    # down, the debug fields where images are saved, else the packed scalars
    up_mb = ((batch + 1) * h * w + (batch * h * w * 2 * 4 if use_gt_flow else 0)) / 2 ** 20
    down_mb = ((batch * h * w * (2 * 4 + 4 + 1 + 1)) if save_images else 0.001) / 2 ** 20
    main_s = sum(v["total_s"] for v in stages.values())
    host_s = proc._stage_host_seconds
    return {
        "cold_wall_s": cold_wall,
        "fields_mb_per_batch": {"h2d": up_mb, "d2h": down_mb},
        "frames": n, "wall_s": wall, "wall_fps": n / wall,
        "host_stage_s": host_s, "host_stage_frac": host_s / wall,
        "stages_ms_per_call": {k: v["total_s"] / max(v["calls"], 1) * 1e3
                               for k, v in stages.items()},
        "stages_total_s": {k: v["total_s"] for k, v in stages.items()},
        "overlap_proven": bool(host_s + main_s > wall * 1.02),
        "serial_sum_s": host_s + main_s,
    }


def main(argv=None, device=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--size", type=hw, default=(1024, 1920), metavar="HxW")
    ap.add_argument("--frames", type=int, default=25)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--flow-source", default="FARNEBACK")
    ap.add_argument("--no-images", action="store_true",
                    help="skip the result-image artifacts (pure compute loop)")
    ap.add_argument("--no-gt-flow", action="store_true",
                    help="stage and upload no GT flow (the drone_flow_pixels "
                         "diagnostic costs B fields per batch of h2d)")
    ap.add_argument("--data-root", default=None,
                    help="where the sequence materialises (default: a temporary "
                         "directory, removed at the end)")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    h, w = args.size
    made_root = args.data_root is None
    base = tempfile.mkdtemp(prefix="mav-hires-probe-") if made_root else args.data_root
    try:
        root = os.path.join(base, f"{h}x{w}")
        os.makedirs(root, exist_ok=True)
        seq = materialize(root, (h, w), args.frames)
        out = run_probe(root, seq, args.batch, args.flow_source, not args.no_images, dev,
                        use_gt_flow=not args.no_gt_flow)
    finally:
        if made_root:
            shutil.rmtree(base, ignore_errors=True)
    out.update(device=device_name(dev), size=f"{w}x{h}", batch=args.batch,
               flow_source=args.flow_source, link=link_canary(dev))
    print(dumps(out))
    return out


if __name__ == "__main__":
    main()
