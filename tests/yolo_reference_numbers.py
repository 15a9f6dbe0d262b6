"""The JAX package's numbers behind the TinyYOLO gates of ``chip_smoke.py``'s
``yolo`` phase, with the shipped per-mode checkpoints. Runs on the CPU, about
a minute:

    JAX_PLATFORMS=cpu python tests/yolo_reference_numbers.py

For each NN mode (FLOW_UV, FLOW_RADIAL, FLOW_FOE_YOLO) and two fixtures, the
mean over frames of the best box's IoU against the annotation, and the
detection rate (IoU > 0.25), as ``mav_detection_tpu.cli.train.eval_yolo``
scores them: the mode imagery of each frame rendered from the fixture's GT
flow by ``mode_image_host``, then ``detect_boxes``. The fixtures: the
held-out one of ``eval_yolo`` (seed 779, 12 frames, a radius-11 drone from
(240, 70) at (-4, 3) px per frame) and the 24-frame default
``SyntheticDataset``. Then the same numbers from the port on the CPU, whose
FLOW_FOE_YOLO imagery fits on its own RANSAC draws.
"""
import json
import os
import sys

import numpy as np

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mav_detection_tpu.core.rectangle import Rectangle  # noqa: E402
from mav_detection_tpu.data.synthetic import SyntheticDataset, SyntheticParams  # noqa: E402
from mav_detection_tpu.models import pretrained  # noqa: E402
from mav_detection_tpu.models.yolo import detect_boxes  # noqa: E402
from mav_detection_tpu.pipeline.mode_imagery import mode_image_host  # noqa: E402

MODES = ("FLOW_UV", "FLOW_RADIAL", "FLOW_FOE_YOLO")
FIXTURES = {
    "holdout": dict(seed=779, n_frames=12, drone_radius=11,
                    drone_start=(240.0, 70.0), drone_velocity=(-4.0, 3.0)),
    "product": {},
}


def score(boxes_of, ds, mode, image_of):
    """(mean best IoU, detection rate) over the frames of ``ds``."""
    ious = []
    for i in range(ds.N):
        j = min(i, ds.N - 2)
        img = image_of(ds.get_frame(i), np.asarray(ds.flows[j], np.float32), mode, i)
        xywh, valid = boxes_of(img, mode)
        gt = ds.get_annotation(i)[0]
        best = 0.0
        for k in range(len(valid)):
            if valid[k]:
                x, y, bw, bh = (float(v) for v in xywh[k])
                best = max(best, Rectangle.calculate_iou_safe(
                    Rectangle((x - bw / 2, y - bh / 2), (bw, bh)), gt))
        ious.append(best)
    ious = np.asarray(ious)
    return float(ious.mean()), float((ious > 0.25).mean())


def main():
    from mav_detection_tpu_torch.models import pretrained as tp
    from mav_detection_tpu_torch.models import yolo as ty
    from mav_detection_tpu_torch.pipeline.mode_imagery import mode_image_host as t_mode

    def jax_boxes(img, mode):
        b = detect_boxes(pretrained.load_yolo_params(mode), jnp.asarray(img))
        return np.asarray(b.xywh), np.asarray(b.valid)

    def port_boxes(img, mode):
        b = ty.detect_boxes(tp.load_yolo(mode, "cpu"), img)
        return b.xywh.numpy(), b.valid.numpy()

    out = {"jax": {}, "port_cpu": {}}
    for fx, kw in FIXTURES.items():
        ds = SyntheticDataset(params=SyntheticParams(**kw))
        for mode in MODES:
            out["jax"][f"{fx} {mode}"] = score(
                jax_boxes, ds, mode, lambda f, fl, m, i: mode_image_host(f, fl, m, seed=i))
            out["port_cpu"][f"{fx} {mode}"] = score(
                port_boxes, ds, mode,
                lambda f, fl, m, i: t_mode(f, fl, m, seed=i, device="cpu"))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
