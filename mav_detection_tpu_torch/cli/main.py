"""Command-line entry point of the port.

The parser knows the reference's flag surface (``mav_detection_tpu.cli.
main``) plus ``--device``; every flag or value outside the ``PORTED`` table
raises "not yet ported" instead of being ignored. ``execute`` runs the
reference's branches: detection then validation (the Validator; in the NN
modes TinyYOLO over the mode imagery), validation alone with ``--validate``
in an NN mode, or one of the conversions (``--prepare-dataset``,
``--data-to-yolo``, ``--undistort``). ``--run-all`` validates every
validation sequence of ``settings.json``, sharded over hosts by
``--num-hosts`` / ``--host-index`` (or ``MAV_NUM_HOSTS`` /
``MAV_HOST_INDEX``).

The bare defaults run the FoE loop over a MIDGARD sequence (``MIDGARD_PATH``,
sequence ``countryside-natural/north-narrow`` unless ``--sequence`` names
another) on PRECOMPUTED flow, which falls back to Farneback on the card where
the sequence has no ``.flo`` files, then validate in mode FLOW_UV: TinyYOLO
on the flow imagery of every frame, on the card. Simulation sequences come
from the collector (``cli/collect.py``).

Usage:
    MIDGARD_PATH=<dir> python -m mav_detection_tpu_torch.cli.main --headless
    MIDGARD_PATH=<dir> python -m mav_detection_tpu_torch.cli.main --headless \
        --validate --mode FLOW_FOE_YOLO
    MIDGARD_PATH=<dir> YOLOv4_PATH=<dir> python -m \
        mav_detection_tpu_torch.cli.main --prepare-dataset --mode FLOW_FOE_YOLO
    MIDGARD_PATH=<dir> python -m mav_detection_tpu_torch.cli.main --data-to-yolo
    python -m mav_detection_tpu_torch.cli.main --run-all --headless
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
    python -m mav_detection_tpu_torch.cli.main --dataset synthetic \
        --flow-source FARNEBACK --devices 4 [--engine spatial|chunked] \
        --headless

``--devices N`` runs the detection on N ranks, one process per card (or,
with ``--device cpu``, N gloo processes); the Validator then runs once, in
the calling process.

``--dataset vis_drone`` reads ``VIS_DRONE_PATH``, ``--dataset experiment``
``EXPERIMENT_PATH``. With ``SYNTHETIC_PATH`` set, the synthetic sequence is
written there. The FrameResult JSON lands in the sequence's ``results/``
directory and the debug images (FoE branch: ``result-images/``,
``derotated/``, ``phi/``, ``processed/``, ``video.npz``; homography branch:
the ``processed/`` mosaics) beside it; the Validator writes
``validation.npy``, the box cache ``bounding-boxes/`` and, where matplotlib
can be imported, its figures.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional, Union

import torch

from mav_detection_tpu_torch.core.config import Mode, RunConfig
from mav_detection_tpu_torch.eval.validator import Validator
from mav_detection_tpu_torch.pipeline.processor import Processor

# flags the port runs, and the values it accepts where it restricts them
PORTED = {
    "dataset": {"synthetic", "midgard", "simulation", "vis_drone", "experiment"},
    "sequence": None,
    "flow_source": {"FARNEBACK", "PRECOMPUTED", "LUCAS_KANADE", "GROUND_TRUTH",
                    "RAFT"},
    "engine": {"BATCH", "SCAN", "CHUNKED", "SPATIAL"},
    "devices": None,
    "mode": None,
    "algorithm": None,
    "use_sparse_of": None,
    "debug": None,
    "batch_size": None,
    "foe_samples": None,
    "headless": None,
    "device": None,
    "validate": None,
    "prepare_dataset": None,
    "data_to_yolo": None,
    "undistort": None,
    "run_all": None,
    "num_hosts": None,
    "host_index": None,
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
                        help="shard frame batches over N devices (one process "
                             "each, NCCL on the cards, gloo with --device cpu)")
    parser.add_argument("--engine", type=str, default="batch",
                        help="frame engine: batch, scan, chunked (time chunks "
                             "over the devices; needs --devices), spatial (each "
                             "pair's Farneback solve row-sharded over the "
                             "devices; needs --devices)")
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


def execute(config: RunConfig, device: Union[str, torch.device] = "cuda") -> None:
    """The reference's ``execute``: validation alone with ``--validate`` in
    an NN mode, else a conversion, else detection then validation."""
    config.logger.info(f"Starting: {config}")
    if config.validate and config.uses_nn_for_detection():
        Validator(config, device=device).run_validation()
        return
    processor = Processor(config, device=device)
    try:
        if config.prepare_dataset:
            processor.convert(config.mode)
        elif config.data_to_yolo:
            processor.annotations_to_yolo()
        elif config.undistort:
            processor.undistort()
        else:
            results = processor.run_detection()
            config.logger.info(f"{len(results)} frame results")
            Validator(config, device=device).run_validation()
    finally:
        processor.release()


def run_all(logger: logging.Logger, args: argparse.Namespace) -> None:
    """Validation sweep over the validation sequences of ``settings.json``;
    each host takes ``sequences[host_index::num_hosts]``."""
    num_hosts = args.num_hosts or int(os.environ.get("MAV_NUM_HOSTS", "1"))
    host_index = (args.host_index if args.host_index is not None
                  else int(os.environ.get("MAV_HOST_INDEX", "0")))
    settings = RunConfig(logger=logger).settings
    sequences = list(settings.get("validation_sequences", []))
    mine = sequences[host_index::max(num_hosts, 1)]
    if num_hosts > 1:
        logger.info(f"run-all host {host_index}/{num_hosts}: "
                    f"{len(mine)}/{len(sequences)} sequences")
    for sequence in mine:
        config = RunConfig(
            logger=logger, dataset=args.dataset or "MIDGARD",
            sequence=sequence, mode=str(Mode.FLOW_FOE_CLUSTERING),
            debug=True, validate=True, headless=args.headless,
            flow_source=args.flow_source, batch_size=args.batch_size,
            devices=args.devices, engine=args.engine.lower(),
            foe_samples=args.foe_samples, use_sparse_of=args.use_sparse_of)
        execute(config, args.device)


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    check_ported(args, parser)
    logger = get_logger(args.debug)
    if args.run_all:
        run_all(logger, args)
        return
    config = RunConfig(
        logger=logger, dataset=args.dataset, sequence=args.sequence,
        mode=args.mode,
        algorithm=args.algorithm, flow_source=args.flow_source,
        debug=args.debug, batch_size=args.batch_size,
        foe_samples=args.foe_samples, use_sparse_of=args.use_sparse_of,
        engine=args.engine.lower(), headless=args.headless,
        devices=args.devices,
        prepare_dataset=args.prepare_dataset, validate=args.validate,
        data_to_yolo=args.data_to_yolo, undistort=args.undistort)
    execute(config, args.device)


if __name__ == "__main__":
    main()
