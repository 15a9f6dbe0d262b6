"""The JAX package's numbers behind the eval gates of ``chip_smoke.py``'s
``train`` phase: the evals of ``mav_detection_tpu.cli.train`` on the shipped
checkpoints, on the CPU. Regenerate (about two minutes) with

    JAX_PLATFORMS=cpu python tests/train_reference_numbers.py

which prints the dict below as JSON. Each entry is the reference function's
return value, called with its defaults:

* ``eval_raft``: (EPE, drone-region EPE) in px on the held-out fixture
  (seed 777, 12 pairs at 240x320, ``PRODUCT_ITERS`` iterations);
* ``eval_raft_detection``: (TPR with RAFT flow, TPR with GT flow) of the
  fixed-threshold detection step on 8 pairs of the same fixture, FoE draws
  from ``jax.random.PRNGKey(i)``;
* ``eval_sky``: (net TPR, net FPR, precomputed-mask TPR, FPR) on seed 778;
* ``eval_yolo``: (mean IoU, detection rate) per mode on seed 779;
* ``shift_ladder_epe``: the worst interior EPE in px over uniform shifts of
  4, 8 and 12 px of a blurred-noise texture at 256x320.

Importing this module imports nothing of JAX: ``chip_smoke.py`` reads
``NUMBERS`` from it.
"""
import json
import os
import sys

YOLO_MODES = ("APPEARANCE_RGB", "FLOW_UV", "FLOW_RADIAL", "FLOW_FOE_YOLO")

# main()'s output on the CPU (JAX 0.9.0, Flax 0.12.3, the shipped checkpoints)
NUMBERS = {
    "eval_raft": [0.4964367523789406, 0.35710280016064644],
    "eval_raft_detection": [1.0, 1.0],
    "shift_ladder_epe": 13.5696439743042,
    "eval_sky": [1.0, 0.0, 0.9812988281249998, 0.0],
    "eval_yolo": {"APPEARANCE_RGB": [0.9622123362007927, 1.0],
                  "FLOW_UV": [0.92667033520879, 1.0],
                  "FLOW_RADIAL": [0.8345998659023738, 0.9166666666666666],
                  "FLOW_FOE_YOLO": [0.9191495874931479, 1.0]},
}


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from mav_detection_tpu.cli import train
    from mav_detection_tpu.models import pretrained

    raft = pretrained.load_raft_params()
    out = {"eval_raft": list(train.eval_raft(raft)),
           "eval_raft_detection": list(train.eval_raft_detection(raft)),
           "shift_ladder_epe": train.shift_ladder_epe(raft),
           "eval_sky": [float(v) for v in train.eval_sky(pretrained.load_sky_params())],
           "eval_yolo": {m: list(train.eval_yolo(pretrained.load_yolo_params(m), mode=m))
                         for m in YOLO_MODES}}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
