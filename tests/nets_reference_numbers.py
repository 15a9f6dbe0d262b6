"""The JAX package's numbers behind the gates of ``chip_smoke.py``'s ``nets``
phase, on the scipy render of the bench scene (``mav_detection_tpu_torch.
data.scene``), with the shipped checkpoints. Runs on the CPU, a few minutes:

    JAX_PLATFORMS=cpu python tests/nets_reference_numbers.py

Prints one JSON object: RAFT's interior and drone-region EPE against the
analytic GT at 240x320 (8 iterations, the scene of
``tools/cross_domain_eval.py``), at 752x480 (the product 6 iterations) and
at 1920x1024 (through ``raft_flow_batch_tuned``'s quarter scale), and the
SkyUNet's TPR / FPR against the scene's sky band at 752x480. Then the FoE
loop on RAFT flow over the synthetic 752x480 sequence (12 frames, batch 8,
``chip_smoke.py``'s cell) through the JAX ``Processor`` and through the
port's on the CPU with the JAX draws: the medians of the FoE error and the
rates, and the largest difference of each field between the two.
"""
import json
import os
import sys

import numpy as np

import jax.numpy as jnp
from flax import serialization

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mav_detection_tpu.models import pretrained  # noqa: E402
from mav_detection_tpu.models import raft, sky_segmentation  # noqa: E402

from mav_detection_tpu_torch.data.scene import bench_scene, hires_scene_kwargs, make_scene  # noqa: E402


def _epes(flow, gt, drone):
    err = np.linalg.norm(np.asarray(flow) - gt, axis=-1)
    interior = np.zeros(gt.shape[:2], bool)
    interior[16:-16, 16:-16] = True
    return float(err[interior].mean()), float(err[drone].mean())


def main() -> None:
    root = pretrained.checkpoint_root()
    with open(os.path.join(root, "raft.msgpack"), "rb") as f:
        tree = pretrained._migrate_raft_state(serialization.msgpack_restore(f.read()))
    with open(os.path.join(root, "sky.msgpack"), "rb") as f:
        sky = serialization.msgpack_restore(f.read())
    out = {}
    for h, w, iters, seed in ((240, 320, 8, 1), (480, 752, 6, 0)):
        prev, curr, gt, drone = bench_scene(seed, h, w)
        flow = raft.raft_flow(tree, jnp.asarray(prev), jnp.asarray(curr), iters)
        out[f"raft {w}x{h} iters={iters} seed={seed}"] = _epes(flow, gt, drone)
        if h == 480:
            est = np.asarray(sky_segmentation.sky_mask(
                sky, jnp.asarray(np.repeat(prev[..., None], 3, -1))))
            band = np.zeros((h, w), bool)
            band[:int(0.35 * h)] = True
            out[f"sky {w}x{h} seed={seed} tpr,fpr"] = (
                float((est & band).sum() / band.sum()),
                float((est & ~band).sum() / (~band).sum()))
    h, w = 1024, 1920
    kw = hires_scene_kwargs(h, w)
    prev, curr, gt = make_scene(0, h=h, w=w, **kw)
    drone = ((np.arange(w)[None, :] - kw["drone_pos"][0]) ** 2
             + (np.arange(h)[:, None] - kw["drone_pos"][1]) ** 2 <= kw["drone_radius"] ** 2)
    flow = raft.raft_flow_batch_tuned(jnp.asarray(prev[None]), jnp.asarray(curr[None]),
                                      tree)[0]
    out[f"raft {w}x{h} tuned seed=0"] = _epes(flow, gt, drone)
    out["foe loop 752x480 RAFT"] = _foe_loop(tree, dict(height=480, width=752,
                                                         n_frames=12), 8)
    print(json.dumps(out))


def _foe_loop(tree, seq, batch):
    import torch

    import test_torch_processor as tp
    from mav_detection_tpu.core.config import RunConfig as JRunConfig
    from mav_detection_tpu.data.synthetic import SyntheticDataset as JSynth
    from mav_detection_tpu.data.synthetic import SyntheticParams as JParams
    from mav_detection_tpu.pipeline.processor import Processor as JProcessor

    from mav_detection_tpu_torch.core.config import RunConfig
    from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
    from mav_detection_tpu_torch.pipeline.processor import Processor

    torch.set_num_threads(os.cpu_count() or 1)
    pretrained._CACHE[("raft", raft.RAFTConfig())] = tree
    cfg = JRunConfig(dataset="synthetic", flow_source="RAFT", batch_size=batch)
    cfg.get_dataset = lambda: JSynth(params=JParams(**seq))
    jproc = JProcessor(cfg)
    jproc.save_images = False
    ref = jproc.run_detection_foe()
    pcfg = RunConfig(dataset="synthetic", flow_source="RAFT", batch_size=batch)
    pcfg.get_dataset = lambda: SyntheticDataset(params=SyntheticParams(**seq))
    pproc = Processor(pcfg, device="cpu")
    pproc.save_images = False
    syx = tp.jax_batch_samples(seq["n_frames"] - 1, batch, 1000, seq["height"],
                               seq["width"])
    got = pproc.run_detection_foe(sample_yx=syx)

    def medians(res):
        return {"foe_err_px": float(np.median([np.hypot(*np.subtract(fr.foe_dense, fr.foe_gt))
                                               for fr in res.values()])),
                **{k: float(np.nanmedian([getattr(fr, k) for fr in res.values()]))
                   for k in ("tpr", "fpr", "tpr_fixed", "fpr_fixed")}}

    diff = {}
    for i in ref:
        for k, v in ref[i].to_dict().items():
            d = np.nanmax(np.abs(np.subtract(got[i].to_dict()[k], v, dtype=np.float64)))
            diff[k] = max(diff.get(k, 0.0), float(d))
    return {"jax": medians(ref), "port_cpu": medians(got), "max_field_diff": diff}


if __name__ == "__main__":
    main()
