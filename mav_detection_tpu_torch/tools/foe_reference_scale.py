"""FoE error at the reference's own scale and protocol.

The port of ``tools/foe_reference_scale.py``. BASELINE.md's headline
accuracy rows are FoE errors on AirSim straight-flight sequences at
1920x1024 ("center": mean (2.81, -7.18) px, std (4.9, 6.4) px, outliers
over 50 px rejected, frames from 56 on). This tool gives the comparable
number of the closed loop: mock-simulator straight flight at 1920x1024 ->
states with view-projection matrices -> GT flow from matrices and depth
(``SimDataset``, on the device) -> the FoE detection branch on
GROUND_TRUTH flow -> ``Validator.compute_foe_stats``. The validator drops
the frames before ``FOE_STABILIZE_FRAME`` (56) only when more frames than
that exist; its means are None without inliers, printed ``null``.

The collection goes to a temporary directory, removed afterwards, unless
``--keep PATH``; ``SIMDATA_PATH`` is set for the run only::

    python -m mav_detection_tpu_torch.tools.foe_reference_scale [--frames 90]
        [--hw 1024x1920] [--batch 2] [--keep PATH] [--foe-samples 1000]

``--device cpu`` runs the plain versions.
"""
from __future__ import annotations

import logging
import os
import shutil
import tempfile
import time

from mav_detection_tpu_torch.tools.common import dumps, hw, parser, simdata_path
from mav_detection_tpu_torch.utils.device import resolve_device

# Collision mode with a small crossing angle: the observer flies a straight
# track (captures are unconditional in this mode), so the camera expands
# about a steady FoE like the reference's straight-flight sequences. Both
# drones start on a radius-R circle and fly toward its centre at
# global_speed, so the sequence is ~2R / (2 * speed) steps long: R = 70 at
# 1.0 m/s gives ~70 captures, enough for the frames >= 56 rule to engage.
COLLECTION = {
    "orientations": ["north"],
    "locations": {"fieldline": {"x": 0.0, "y": 0.0, "z": -2.0}},
    "orbit_speed": [2.0],
    "global_speed": {"default": {"lin_x": 1.0, "sin_y": 0.0, "sin_z": 0.0}},
    "heights": {"low": 4.0},
    "radii": [70.0],
    "modes": ["collision"],
    "collision_angles": [5.0],
}
REFERENCE = {"reference_mean": [2.81, -7.18], "reference_std": [4.9, 6.4]}


def collect(root: str, h: int, w: int, frames: int) -> str:
    """Fly the collection into ``root``; the sequence's name under it."""
    from mav_detection_tpu_torch.sim.client import MockSimClient
    from mav_detection_tpu_torch.sim.control import SimDataCollector

    collector = SimDataCollector(MockSimClient(image_hw=(h, w), fov_deg=90), COLLECTION,
                                 root_data_dir=root, max_iterations=frames)
    if not collector.configs:
        raise FileExistsError(f"{root} already holds the collection: --keep a new path")
    collector.run()
    return os.path.relpath(collector.get_base_dir(collector.configs[0]), root)


def foe_stats(root: str, seq: str, batch: int, foe_samples: int, dev, sample_yx=None):
    """(stats, scoring frames, dataset frames): the FoE loop on GROUND_TRUTH
    flow over the sequence, then the validator's FoE statistics.
    ``sample_yx``: the FoE draws per batch, in place of the run's
    generator."""
    from mav_detection_tpu_torch.core.config import FlowSource, RunConfig
    from mav_detection_tpu_torch.data.sim_data import SimDataset
    from mav_detection_tpu_torch.eval.validator import Validator
    from mav_detection_tpu_torch.pipeline.processor import Processor

    with simdata_path(root):
        ds = SimDataset(sequence=seq, device=dev)
        cfg = RunConfig(dataset="simulation", sequence=seq, mode="FLOW_FOE_CLUSTERING",
                        flow_source=FlowSource.GROUND_TRUTH, batch_size=batch,
                        headless=True, foe_samples=foe_samples)
        Processor(cfg, device=dev, dataset=ds).run_detection_foe(sample_yx=sample_yx)
        v = Validator(cfg, device=dev)
        v.dataset = ds
        v.load_results()
        stats = v.compute_foe_stats()
    return stats, len(v.foe_error), ds.N


def main(argv=None, device=None, sample_yx=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--hw", type=hw, default=(1024, 1920), metavar="HxW",
                    help="capture resolution (reference: 1024x1920)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--keep", default="", help="keep the collected dataset at this path")
    ap.add_argument("--foe-samples", type=int, default=1000,
                    help="dense-FoE sampling budget (reference N=1000)")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    log = logging.getLogger("foe-ref")
    h, w = args.hw
    root = args.keep or tempfile.mkdtemp(prefix="foe_ref_")
    t0 = time.perf_counter()
    try:
        log.info(f"collecting {args.frames} frames at {w}x{h} ...")
        seq = collect(root, h, w, args.frames)
        t1 = time.perf_counter()
        stats, n_scoring, n = foe_stats(root, seq, args.batch, args.foe_samples, dev,
                                        sample_yx)
    finally:
        if not args.keep:
            shutil.rmtree(root, ignore_errors=True)
    t2 = time.perf_counter()
    mean, std = stats["foe_mean"], stats["foe_std"]
    if mean is None:
        log.info(f"ours: no FoE inliers over {n_scoring} scoring frames (of {n - 1})")
    else:
        log.info("ours:      mean (%.2f, %.2f) px, std (%.1f, %.1f) px over %d scoring "
                 "frames (of %d) at %dx%d" % (mean[0], mean[1], std[0], std[1], n_scoring,
                                              n - 1, w, h))
    log.info("reference: mean (2.81, -7.18) px, std (4.9, 6.4) px "
             "(straight flight 'center', get_figures.py:163-172)")
    res = {"ours_mean": mean, "ours_std": std, **REFERENCE, "resolution": f"{w}x{h}",
           "frames": n, "scoring_frames": n_scoring, "outliers": stats["foe_outliers"],
           "device": str(dev), "collect_s": t1 - t0, "detect_s": t2 - t1}
    print(dumps(res))
    return res


if __name__ == "__main__":
    main()
