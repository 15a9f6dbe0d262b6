"""RAFT fine-tuning: resume the shipped checkpoint on the broadened
training generator (small intruders, the sinusoidal texture family and,
with ``--pan-max``, camera pans), select with the trainer's selector, then
gate the candidate against the shipped weights on the in-family eval
fixture, the detection step, the cross-domain scenes and the uniform-shift
ladder.

The port of ``tools/finetune_raft.py``; the gates keep the reference's keys
and thresholds. The candidate is written as a Flax msgpack file (the port's
writer), which the JAX package reads, under ``build/candidates/`` (git
ignored) unless ``--candidate``; ``--init`` resumes from such a file.
``--ship`` copies a candidate that passes every gate over
``pretrained.checkpoint_path("raft")``, and only under
``MAV_CHECKPOINT_PATH``: without it the tool raises before any training,
so the repository's ``checkpoints/raft.msgpack``, which both packages'
parity numbers read, is never overwritten::

    MAV_CHECKPOINT_PATH=<dir> python -m mav_detection_tpu_torch.tools.finetune_raft
        [--steps 2000] [--lr 8e-5] [--pan-max 0] [--ship]

``--device cpu`` trains and evaluates with the plain versions.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import time

from mav_detection_tpu_torch.cli.train import (
    eval_raft,
    eval_raft_detection,
    shift_ladder_epe,
    train_raft,
)
from mav_detection_tpu_torch.tools.common import dumps, parser
from mav_detection_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("mav_detection_tpu_torch.finetune")

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CANDIDATES = os.path.join(REPO, "build", "candidates")
SHIP_ENV = "MAV_CHECKPOINT_PATH"
CD_HW = (240, 320)      # the bench family of the cross-domain gate
CD_SEEDS = (1, 2)


def check_ship(ship: bool) -> None:
    """``--ship`` writes ``pretrained.checkpoint_path("raft")``: refuse it
    unless ``MAV_CHECKPOINT_PATH`` points away from the repository's
    checkpoints."""
    if ship and not os.environ.get(SHIP_ENV):
        raise RuntimeError(
            f"--ship copies the candidate over the RAFT checkpoint: set {SHIP_ENV} to a "
            "directory holding the checkpoints to replace (the repository's "
            "checkpoints/ stay as shipped)")


def cross_domain(model, scene=None) -> dict:
    """RAFT's EPE and drone-region EPE on the bench family at 240x320
    (seeds 1 and 2, the product's iterations) and on the mock-simulator
    captures."""
    import numpy as np

    from mav_detection_tpu_torch.models.raft import PRODUCT_ITERS, raft_flow
    from mav_detection_tpu_torch.tools import cross_domain_eval as cde

    if scene is None:
        from mav_detection_tpu_torch.data.scene import make_scene as scene
    h, w = CD_HW
    dev = model.mask_head.weight.device
    foe, pos, r, _ = cde.bench_geometry(h, w)
    drone = cde.disc(h, w, pos, r)
    epes, depes = [], []
    for seed in CD_SEEDS:
        # the reference's drone velocity here is (4, 2.5) x 0.5, not x scale
        prev8, curr8, gt = scene(seed, h=h, w=w, foe=foe, drone_pos=pos,
                                 drone_vel=(4.0 * 0.5, 2.5 * 0.5), drone_radius=r)
        fl = raft_flow(model, prev8[None], curr8[None], iters=PRODUCT_ITERS)[0].cpu().numpy()
        err = np.linalg.norm(fl - gt, axis=-1)
        epes.append(float(err[16:-16, 16:-16].mean()))
        depes.append(float(err[drone].mean()))
    sim = cde.mock_sim_metrics(iters=0, raft=model, device=dev)
    return {"bench_epe": sum(epes) / len(epes), "bench_drone_epe": sum(depes) / len(depes),
            "sim_epe": sim["raft_epe"], "sim_drone_epe": sim["raft_drone_epe"]}


def evaluate(model, scene=None, detection: bool = True) -> dict:
    """Every number the gates read: the eval fixture's EPE and drone EPE,
    the detection TPRs (RAFT flow, GT flow), the cross-domain EPEs and the
    shift ladder."""
    epe, depe = eval_raft(model)
    out = {"eval_epe": epe, "drone_epe": depe}
    if detection:
        out["det_tpr"], out["det_tpr_gt"] = eval_raft_detection(model)
    out.update(cross_domain(model, scene))
    out["shift_ladder"] = shift_ladder_epe(model)
    return out


def gates(base: dict, cand: dict, pan_max: float) -> dict:
    """The shipping gates of a candidate's evals against the shipped
    weights' (the reference's keys and thresholds)."""
    return {
        "eval_epe<=0.5": cand["eval_epe"] <= 0.5,
        "drone_epe<=0.5": cand["drone_epe"] <= 0.5,
        "det_tpr_within_0.05": abs(cand["det_tpr"] - cand["det_tpr_gt"]) <= 0.05,
        "bench_epe_improves": cand["bench_epe"] <= max(base["bench_epe"], 0.4),
        "bench_drone_improves": cand["bench_drone_epe"] <= base["bench_drone_epe"],
        "sim_epe_improves": cand["sim_epe"] <= max(base["sim_epe"], 0.7),
        # large motion: never regress the ladder; with the pan curriculum
        # demand it lands under the small-motion gate too
        "shift_ladder_improves": cand["shift_ladder"] <= base["shift_ladder"],
        **({"shift_ladder<=0.5": cand["shift_ladder"] <= 0.5} if pan_max > 0 else {}),
    }


def model_from_tree(tree, dev):
    """A ``models.raft.RAFT`` on ``dev`` with the weights of a Flax RAFT
    param tree (post-hoist layout)."""
    import torch

    from mav_detection_tpu_torch.convert import raft_state_dict_from_flax
    from mav_detection_tpu_torch.models.raft import RAFT

    with torch.device("meta"):
        model = RAFT()
    model.load_state_dict({k: v.to(dev) for k, v in raft_state_dict_from_flax(tree).items()},
                          assign=True)
    return model


def ship(path: str) -> str:
    """Copy ``path`` over the RAFT checkpoint (under ``MAV_CHECKPOINT_PATH``)
    and drop the loaders' cache."""
    from mav_detection_tpu_torch.models import pretrained

    check_ship(True)
    dst = pretrained.checkpoint_path("raft")
    shutil.copy(path, dst)
    pretrained.clear_cache()
    return dst


def main(argv=None, device=None, scene=None) -> dict:
    from mav_detection_tpu_torch.convert import flax_from_raft_state_dict, raft_state_dict_from_flax
    from mav_detection_tpu_torch.models import checkpoint, pretrained

    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=8e-5)
    ap.add_argument("--drone-weight", type=float, default=40.0)
    ap.add_argument("--sin-blend", type=float, default=0.6,
                    help="cap on the sinusoid texture blend in the training generator "
                         "(0 = pure in-family blurred noise)")
    ap.add_argument("--pan-max", type=float, default=0.0,
                    help="large-motion curriculum: per-axis camera pan up to this many px "
                         "added to every scene's flow; adds the shift ladder to selection "
                         "and gating")
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--candidate", default=os.path.join(CANDIDATES, "raft_candidate.msgpack"),
                    help="where to keep the trained-but-unshipped weights (default under "
                         "build/candidates/, git ignored)")
    ap.add_argument("--init", default="",
                    help="resume training from this msgpack instead of the shipped "
                         "checkpoint (gates still compare against shipped)")
    ap.add_argument("--ship", action="store_true",
                    help=f"overwrite the RAFT checkpoint under {SHIP_ENV} if all gates pass")
    args = ap.parse_args(argv)
    check_ship(args.ship)
    dev = resolve_device(device if device is not None else args.device)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    os.makedirs(os.path.dirname(os.path.abspath(args.candidate)), exist_ok=True)

    shipped = pretrained.load_raft(dev)
    if shipped is None:
        raise FileNotFoundError(f"no shipped checkpoint to resume from at "
                                f"{pretrained.checkpoint_path('raft')}")
    logger.info("=== shipped baseline ===")
    base = evaluate(shipped, scene, detection=False)
    logger.info(f"shipped: {json.dumps(base)}")

    init = pretrained.load_raft_params()
    if args.init:
        init = raft_state_dict_from_flax(checkpoint.load_msgpack(
            args.init, migrate=pretrained._migrate_raft_state))
        logger.info(f"resuming from {args.init}")
    t0 = time.perf_counter()
    model, losses = train_raft(steps=args.steps, chunk=args.chunk, peak_lr=args.lr,
                               init_params=init, drone_weight=args.drone_weight,
                               sin_blend=args.sin_blend, pan_max=args.pan_max,
                               save_best_to=args.candidate, device=dev)
    train_s = time.perf_counter() - t0
    checkpoint.save_msgpack(args.candidate, flax_from_raft_state_dict(model.state_dict()))

    logger.info("=== candidate ===")
    cand = evaluate(model, scene)
    logger.info(f"candidate: {json.dumps(cand)}")
    g = gates(base, cand, args.pan_max)
    logger.info(f"gates: {json.dumps(g)}")
    shipped_to = None
    if all(g.values()):
        logger.info("ALL GATES PASS")
        if args.ship:
            shipped_to = ship(args.candidate)
            logger.info(f"shipped to {shipped_to}")
    else:
        logger.info(f"gates failed — NOT shipping (candidate kept at {args.candidate})")
    res = {"device": str(dev), "steps": args.steps, "chunk": args.chunk,
           "pan_max": args.pan_max, "baseline": base, "candidate": cand, "gates": g,
           "all_pass": all(g.values()), "candidate_path": os.path.abspath(args.candidate),
           "shipped_to": shipped_to, "train_s": train_s,
           "ms_per_step_with_selection": train_s * 1e3 / max(args.steps, 1),
           "first_loss": float(losses[0]) if len(losses) else None,
           "last_loss": float(losses[-1]) if len(losses) else None}
    print(f"{res['ms_per_step_with_selection']:.2f} ms per step on {dev} (wall clock, "
          f"selection included)")
    print(dumps(res))
    return res


if __name__ == "__main__":
    main()
