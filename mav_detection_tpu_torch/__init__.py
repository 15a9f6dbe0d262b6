"""PyTorch/CUDA port of the MAV detection framework, for NVIDIA Hopper.

A second package beside ``mav_detection_tpu`` (the JAX reference): the same
layout and function names, PyTorch tensors throughout, and every Pallas TPU
kernel of the reference rewritten by hand as CUDA C++ for ``sm_90a``
(sources under ``csrc/``, built with ``nvcc`` at first use by ``_build``).

Layering (bottom-up):
  core/      FrameResult, Rectangle, .flo codec, typed run config
  data/      dataset contract, the readers and the synthetic sequence
  ops/       device compute: Farneback flow (CUDA iterate kernels),
             geometry (derotation, FoE, thresholds), image metrics
  models/    the learned nets: SkyUNet, RAFT, TinyYOLO
  pipeline/  the fused detection step, the frame engines, NN mode imagery
  eval/      the Validator
  serve.py   the TinyYOLO REST inference server
  utils/     device resolution, per-stage tracing
  cli/       main.py-compatible command line, the server, the collector

Entry points run on the card (``device="cuda"``) and raise when none is
present; tests pass ``device="cpu"``, where every kernel wrapper takes its
plain PyTorch version. Nothing here imports ``jax`` or ``mav_detection_tpu``.
"""

__version__ = "0.1.0"
