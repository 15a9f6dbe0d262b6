"""The JAX package's numbers behind ``tests/test_torch_eval_tools.py``: the
reference's evaluation tools (``tools/``) on the CPU at the tests' sizes,
on the same inputs the tests give the port. Regenerate (a few minutes)
with

    JAX_PLATFORMS=cpu python tests/eval_tools_reference_numbers.py

which prints the dict below as JSON. Each entry:

* ``bench``: ``tools/cross_domain_eval.bench_scene_metrics(240, 320,
  [1])`` (its cv2 scene, the shipped nets, the product's iterations);
* ``sim``: ``tools/cross_domain_eval.mock_sim_metrics()`` (128x96, 6 pairs);
* ``finetune_cross_domain``: ``tools/finetune_raft.cross_domain`` of the
  shipped RAFT;
* ``families``: ``tools/raft_advantage_probe``'s rows at 240x320 on its
  cv2 families: Farneback with ``tuned_flow_params`` and RAFT's EPE on each
  family's mask;
* ``hires``: ``tools/hires_eval``'s accuracy at a 480x256 capture: the sky
  net's TPR / FPR at 480x256 and 240x128, TinyYOLO's IoU at 480x256;
* ``foe``: ``tools/foe_reference_scale``'s pipeline at 160x120, 70
  frames, batch 2, each package on its own collection and GT flow files:
  ``Validator.compute_foe_stats``. At this cut the statistics are 1.2-3.2
  px (25x and more the tests' 0.05 px) and the validator's frames >= 56
  rule leaves 13 of the 69 flows; at 64x48 or 128x96 the GT FoE is within
  0.03 px of the truth, too close to zero to tell a wrong port apart.

Importing this module imports nothing of JAX.
"""
import json
import os
import sys

FOE_RUN = {"hw": (120, 160), "frames": 70, "batch": 2, "samples": 1000}
HIRES_HW = (256, 480)

# main()'s output on the CPU (JAX 0.9.0, Flax 0.12.3, the shipped checkpoints)
NUMBERS = {'bench': {'raft_epe': 0.22259394824504852,
           'raft_drone_epe': 0.4171565771102905,
           'fb_epe': 0.0834103599190712,
           'lk_epe': 0.14675991237163544,
           'sky_tpr': 1.0,
           'sky_fpr': 0.0,
           'yolo_iou': 0.7549179792404175},
 'sim': {'raft_epe': 0.3822418649991353,
         'raft_drone_epe': 0.5789864957332611,
         'fb_epe': 0.22803359478712082,
         'sky_tpr': 1.0,
         'sky_fpr': 0.002569597271329826,
         'yolo_iou': 0.7879436016082764},
 'finetune_cross_domain': {'bench_epe': 0.21679074317216873,
                           'bench_drone_epe': 0.33792151510715485,
                           'sim_epe': 0.3822418649991353,
                           'sim_drone_epe': 0.5789864957332611},
 'families': {'grating': [3.1622774600982666, 1.9028538465499878],
              'lowcontrast': [3.0411665439605713, 5.978023529052734],
              'boundary': [0.7567483186721802, 2.5907275676727295],
              'control': [0.0010497916955500841, 1.4639674425125122]},
 'hires': {'sky': [[1.0, 0.028228513418368184], [1.0, 0.017416168442942553]],
           'yolo_iou': 0.84541916847229},
 'foe': {'foe_mean': [1.252267103928786, -2.2039554302509012],
         'foe_std': [3.18811658681707, 2.7471835915086227],
         'frames': 70,
         'scoring_frames': 13}}


def _families():
    import jax.numpy as jnp
    import numpy as np

    from mav_detection_tpu.models import pretrained
    from mav_detection_tpu.models.raft import raft_flow
    from mav_detection_tpu.ops.flow import farneback_flow, tuned_flow_params
    from tools.raft_advantage_probe import make_families

    h, w = 240, 320
    params, raft = tuned_flow_params(h, w), pretrained.load_raft_params()
    rows = {}
    for name, (prev, curr, gt) in make_families(h, w).items():
        fb = np.asarray(farneback_flow(jnp.asarray(prev), jnp.asarray(curr), params))
        rf = np.asarray(raft_flow(raft, jnp.asarray(prev), jnp.asarray(curr)))
        mask = np.zeros((h, w), bool)
        if name == "boundary":
            mask[16:-16, w // 2 - 8:w // 2 + 8] = True
        else:
            mask[16:-16, 16:-16] = True
        rows[name] = [float(np.linalg.norm(fb - gt, axis=-1)[mask].mean()),
                      float(np.linalg.norm(rf - gt, axis=-1)[mask].mean())]
    return rows


def _hires():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mav_detection_tpu.core.rectangle import Rectangle
    from mav_detection_tpu.models import pretrained
    from mav_detection_tpu.models.sky_segmentation import sky_mask
    from mav_detection_tpu.models.yolo import detect_boxes
    from mav_detection_tpu.ops.image.boxes import get_simple_bounding_box
    from mav_detection_tpu.sim.client import MockSimClient, Vector3

    h, w = HIRES_HW
    c = MockSimClient(image_hw=(h, w), fov_deg=90, target_radius_m=0.7)
    c.set_pose("Drone1", Vector3(0.0, 0.0, -8.0), 0.0)
    c.set_pose("Drone2", Vector3(28.0, 2.0, -9.0), 0.0)
    for d in c.drones.values():
        d.landed = False
    resp = {r.image_type: r for r in c.capture("Drone1")}
    frame, sky_gt = resp["scene"].data, resp["depth"].data >= 9000.0
    sky_p, yolo_p = pretrained.load_sky_params(), pretrained.load_yolo_params()
    sky = []
    for sh, sw in ((h, w), (h // 2, w // 2)):
        img = jax.image.resize(jnp.asarray(frame, jnp.float32), (sh, sw, 3), "bilinear")
        gt = np.asarray(jax.image.resize(jnp.asarray(sky_gt, jnp.float32), (sh, sw),
                                         "nearest")) > 0.5
        est = np.asarray(sky_mask(sky_p, img))
        sky.append([float((est & gt).sum() / max(gt.sum(), 1)),
                    float((est & ~gt).sum() / max((~gt).sum(), 1))])
    wh, ww = 256, 480
    img = jax.image.resize(jnp.asarray(frame, jnp.float32), (wh, ww, 3), "bilinear")
    boxes = detect_boxes(yolo_p, img, score_threshold=0.5)
    gt_rect = get_simple_bounding_box(resp["segmentation"].data)
    sx, sy, best = w / ww, h / wh, 0.0
    valid = np.asarray(boxes.valid)
    for j in range(len(valid)):
        if valid[j]:
            x, y, bw, bh = np.asarray(boxes.xywh[j])
            rect = Rectangle(((x - bw / 2) * sx, (y - bh / 2) * sy), (bw * sx, bh * sy))
            best = max(best, Rectangle.calculate_iou_safe(rect, gt_rect))
    return {"sky": sky, "yolo_iou": float(best)}


def foe_draws():
    """The JAX processor's FoE draws for ``FOE_RUN`` (its key schedule)."""
    import jax
    import numpy as np

    (h, w), n, batch, samples = FOE_RUN["hw"], FOE_RUN["frames"], FOE_RUN["batch"], \
        FOE_RUN["samples"]
    key = jax.random.PRNGKey(0)
    out = []
    for _ in range(0, n - 1, batch):
        key, sub = jax.random.split(key)
        per = []
        for k in jax.random.split(sub, batch):
            ky, kx = jax.random.split(k)
            per.append(np.stack([
                np.asarray(jax.random.randint(ky, (2 * samples,), 0, h)),
                np.asarray(jax.random.randint(kx, (2 * samples,), 0, w))], -1))
        out.append(np.stack(per))
    return out


def _foe():
    import tempfile

    from mav_detection_tpu.core.config import FlowSource, RunConfig
    from mav_detection_tpu.data.sim_data import SimDataset
    from mav_detection_tpu.eval.validator import Validator
    from mav_detection_tpu.pipeline.processor import Processor
    from mav_detection_tpu.sim.client import MockSimClient
    from mav_detection_tpu.sim.control import SimDataCollector
    from tools.foe_reference_scale import COLLECTION

    (h, w), n, batch = FOE_RUN["hw"], FOE_RUN["frames"], FOE_RUN["batch"]
    with tempfile.TemporaryDirectory() as root:
        col = SimDataCollector(MockSimClient(image_hw=(h, w), fov_deg=90), COLLECTION,
                               root_data_dir=root, max_iterations=n)
        col.run()
        seq = os.path.relpath(col.get_base_dir(col.configs[0]), root)
        os.environ["SIMDATA_PATH"] = root
        SimDataset(sequence=seq)      # writes its own GT flow files
        cfg = RunConfig(dataset="simulation", sequence=seq, mode="FLOW_FOE_CLUSTERING",
                        flow_source=FlowSource.GROUND_TRUTH, batch_size=batch,
                        headless=True, foe_samples=FOE_RUN["samples"])
        Processor(cfg).run_detection()
        v = Validator(cfg)
        v.dataset = cfg.get_dataset()
        v.load_results()
        stats = v.compute_foe_stats()
    return {"foe_mean": [float(x) for x in stats["foe_mean"]],
            "foe_std": [float(x) for x in stats["foe_std"]],
            "frames": v.dataset.N, "scoring_frames": len(v.foe_error)}


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from mav_detection_tpu.models import pretrained
    from tools.cross_domain_eval import bench_scene_metrics, mock_sim_metrics
    from tools.finetune_raft import cross_domain

    out = {"bench": bench_scene_metrics(240, 320, [1]),
           "sim": mock_sim_metrics(),
           "finetune_cross_domain": cross_domain(pretrained.load_raft_params()),
           "families": _families(),
           "hires": _hires(),
           "foe": _foe()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
