"""Command-line entry point of the port.

The parser knows the reference's flag surface (``mav_detection_tpu.cli.
main``) plus ``--device``; the port runs the batch and scan engines on every
dataset (the FoE detection loop, or on the batch engine the homography
branch with ``--algorithm HOMOGRAPHY``), and every flag or value outside the
``PORTED`` table raises "not yet ported" instead of being ignored.

The bare defaults run the FoE loop over a MIDGARD sequence (``MIDGARD_PATH``,
sequence ``countryside-natural/north-narrow`` unless ``--sequence`` names
another) on PRECOMPUTED flow, which falls back to Farneback on the card where
the sequence has no ``.flo`` files. Simulation sequences come from the
collector (``cli/collect.py``).

Usage:
    MIDGARD_PATH=<dir> python -m mav_detection_tpu_torch.cli.main --headless
    python -m mav_detection_tpu_torch.cli.collect --collection foe-demo \
        --mock --image-size 1024x1920 --data-dir <dir> --max-iterations 8
    SIMDATA_PATH=<dir> python -m mav_detection_tpu_torch.cli.main \
        --dataset simulation --sequence <collected sequence> \
        --flow-source GROUND_TRUTH --batch-size 4 --headless
    python -m mav_detection_tpu_torch.cli.main --dataset synthetic \
        --flow-source FARNEBACK --headless
    python -m mav_detection_tpu_torch.cli.main --dataset synthetic \
        --flow-source LUCAS_KANADE --headless
    python -m mav_detection_tpu_torch.cli.main --dataset synthetic \
        --flow-source RAFT --headless
    python -m mav_detection_tpu_torch.cli.main --dataset synthetic \
        --algorithm HOMOGRAPHY --flow-source FARNEBACK [--use-sparse-of] \
        --headless
    python -m mav_detection_tpu_torch.cli.main --dataset synthetic \
        --flow-source FARNEBACK --engine scan [--use-sparse-of] --headless

``--dataset vis_drone`` reads ``VIS_DRONE_PATH``, ``--dataset experiment``
``EXPERIMENT_PATH``. With ``SYNTHETIC_PATH`` set, the synthetic sequence is
written there. The FrameResult JSON lands in the sequence's ``results/``
directory and the debug images (FoE branch: ``result-images/``,
``derotated/``, ``phi/``, ``processed/``, ``video.npz``; homography branch:
the ``processed/`` mosaics) beside it.
"""
from __future__ import annotations

import argparse
import logging
from typing import List, Optional

from mav_detection_tpu_torch.core.config import RunConfig
from mav_detection_tpu_torch.pipeline.processor import Processor

# flags the port runs, and the values it accepts where it restricts them
PORTED = {
    "dataset": {"synthetic", "midgard", "simulation", "vis_drone", "experiment"},
    "sequence": None,
    "flow_source": {"FARNEBACK", "PRECOMPUTED", "LUCAS_KANADE", "GROUND_TRUTH",
                    "RAFT"},
    "engine": {"BATCH", "SCAN"},
    "mode": None,
    "algorithm": None,
    "use_sparse_of": None,
    "debug": None,
    "batch_size": None,
    "foe_samples": None,
    "headless": None,
    "device": None,
}


def get_logger(debug: bool = False) -> logging.Logger:
    level = logging.DEBUG if debug else logging.INFO
    for name in ("main", "mav_detection_tpu_torch"):
        logging.getLogger(name).setLevel(level)
    logger = logging.getLogger("main")
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        logger.addHandler(logging.StreamHandler())
    return logger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Detects MAVs in the dataset using optical flow "
                    "(PyTorch/CUDA port).")
    parser.add_argument("--dataset", type=str, default="midgard",
                        help="dataset to process: midgard|simulation|"
                             "vis_drone|experiment|synthetic")
    parser.add_argument("--sequence", type=str, default="",
                        help="sequence to process")
    parser.add_argument("--mode", type=str, default="FLOW_UV",
                        help="mode to use, see core.config.Mode")
    parser.add_argument("--algorithm", type=str, default="ESSENTIAL",
                        help="ego-motion algorithm, see core.config.Algorithm")
    parser.add_argument("--flow-source", type=str, default="PRECOMPUTED",
                        help="dense flow source (ported: FARNEBACK|PRECOMPUTED|"
                             "LUCAS_KANADE|GROUND_TRUTH|RAFT)")
    parser.add_argument("--batch-size", type=int, default=8,
                        help="frame pairs per device batch")
    parser.add_argument("--devices", type=int, default=0,
                        help="shard frame batches over N devices")
    parser.add_argument("--engine", type=str, default="batch",
                        help="frame engine (ported: batch|scan)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--prepare-dataset", action="store_true")
    parser.add_argument("--validate", action="store_true")
    parser.add_argument("--headless", action="store_true",
                        help="do not use UIs")
    parser.add_argument("--run-all", action="store_true")
    parser.add_argument("--num-hosts", type=int, default=0)
    parser.add_argument("--host-index", type=int, default=None)
    parser.add_argument("--foe-samples", type=int, default=1000,
                        help="dense-FoE sampling budget (upstream N=1000)")
    parser.add_argument("--use-sparse-of", action="store_true")
    parser.add_argument("--data-to-yolo", action="store_true")
    parser.add_argument("--undistort", action="store_true")
    return parser


def check_ported(args: argparse.Namespace,
                 parser: argparse.ArgumentParser) -> None:
    """Raise for any flag set away from its default, or value, that the
    port does not run."""
    for name, value in vars(args).items():
        allowed = PORTED.get(name, ())
        if name in PORTED:
            if allowed is not None:
                norm = value.lower() if name == "dataset" else value.upper()
                if norm not in allowed:
                    raise NotImplementedError(
                        f"--{name.replace('_', '-')} {value} is not yet "
                        f"ported (ported: {', '.join(sorted(allowed))})")
        elif value != parser.get_default(name):
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not yet ported")


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    check_ported(args, parser)
    logger = get_logger(args.debug)
    config = RunConfig(
        logger=logger, dataset=args.dataset, sequence=args.sequence,
        mode=args.mode,
        algorithm=args.algorithm, flow_source=args.flow_source,
        debug=args.debug, batch_size=args.batch_size,
        foe_samples=args.foe_samples, use_sparse_of=args.use_sparse_of,
        engine=args.engine.lower(), headless=args.headless)
    logger.info(f"Starting: {config}")
    processor = Processor(config, device=args.device)
    try:
        results = processor.run_detection()
        logger.info(f"{len(results)} frame results")
    finally:
        processor.release()


if __name__ == "__main__":
    main()
