"""Parameter soups between the shipped RAFT checkpoint and a fine-tune
candidate: each alpha's interpolated weights against the shipping gates
(in-family eval and drone EPE, detection TPR, cross-domain improvements,
the shift ladder), and optionally the best soup that passes shipped.

The port of ``tools/soup_raft.py``. A soup is ``(1 - alpha) * shipped +
alpha * candidate`` per leaf of the two Flax param trees, computed as the
reference's ``jax.tree_util.tree_map`` over numpy leaves computes it: in
numpy's fp32 arithmetic, a bfloat16 leaf (none is shipped: the shipped
file holds 92 fp32 leaves) widened exactly to fp32 first, as numpy does
with ml_dtypes' bfloat16, so every soup leaf is fp32. Both endpoints
descend from the same init, so the interpolation stays in one loss basin.
Among the soups that pass every gate the one with the lowest worst-case
drone EPE (eval fixture, bench family, mock simulator) wins; it is written to ``--out`` (under ``build/candidates/``,
git ignored), and ``--ship`` copies it over the RAFT checkpoint under
``MAV_CHECKPOINT_PATH`` only, raising without it before any evaluation::

    python -m mav_detection_tpu_torch.tools.soup_raft --candidate PATH
        [--alphas 0.3 0.5 0.7] [--ladder-gate 0.5] [--ship]

``--device cpu`` evaluates with the plain versions.
"""
from __future__ import annotations

import collections
import json
import logging
import os

from mav_detection_tpu_torch.tools import finetune_raft as ft
from mav_detection_tpu_torch.tools.common import dumps, parser
from mav_detection_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("mav_detection_tpu_torch.soup")


def read_tree(path: str):
    """A RAFT Flax param tree, older layouts migrated; the reader widens a
    bfloat16 leaf to fp32, exactly."""
    from mav_detection_tpu_torch.models import checkpoint, pretrained

    return checkpoint.load_msgpack(path, migrate=pretrained._migrate_raft_state)


def soup_leaf(a, b, alpha: float):
    """``(1 - alpha) * a + alpha * b`` as the reference computes it over
    numpy leaves: numpy (2, with ml_dtypes' bfloat16) widens a bfloat16
    leaf to fp32, exactly, and computes in fp32."""
    return (1.0 - alpha) * a + alpha * b


def soup_tree(shipped, cand, alpha: float):
    """``(1 - alpha) * shipped + alpha * cand`` leaf by leaf over two trees
    of the same keys."""
    if isinstance(shipped, dict):
        if set(shipped) != set(cand):
            raise ValueError(f"the trees' keys differ: {sorted(shipped)} / {sorted(cand)}")
        return {k: soup_tree(shipped[k], cand[k], alpha) for k in shipped}
    return soup_leaf(shipped, cand, alpha)


def leaf_dtypes(path: str) -> dict:
    """dtype name -> number of array leaves of a Flax msgpack file, read
    from the leaves' own headers."""
    from mav_detection_tpu_torch.models import checkpoint

    class Names(checkpoint._Reader):
        def ext(self, n: int) -> str:
            self.unpack(">b")
            return checkpoint._Reader(self.take(n)).value()[1]

    count = collections.Counter()

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            count[t] += 1
    with open(path, "rb") as f:
        walk(Names(f.read()).value())
    return dict(count)


def soup_gates(base: dict, cand: dict, ladder_gate: float) -> dict:
    """The soup's gates: the fine-tune's, with the shift ladder held under
    ``ladder_gate`` in place of "never regress"."""
    g = ft.gates(base, cand, pan_max=0.0)
    del g["shift_ladder_improves"]
    # the pan-curriculum candidate exists to fix the >= 4 px collapse: a
    # soup may never ship it away
    g["shift_ladder<=0.5"] = cand["shift_ladder"] <= max(ladder_gate, 1e-9)
    return g


def main(argv=None, device=None, scene=None) -> dict:
    from mav_detection_tpu_torch.models import checkpoint, pretrained

    ap = parser(__doc__)
    ap.add_argument("--candidate", required=True,
                    help="fine-tune candidate msgpack (the alpha=1 endpoint)")
    ap.add_argument("--alphas", type=float, nargs="+", default=[0.3, 0.5, 0.7])
    ap.add_argument("--ladder-gate", type=float, default=0.5,
                    help="max shift_ladder_epe a shippable soup may have")
    ap.add_argument("--out", default=os.path.join(ft.CANDIDATES, "raft_soup.msgpack"),
                    help="where the best passing soup is written")
    ap.add_argument("--ship", action="store_true")
    args = ap.parse_args(argv)
    ft.check_ship(args.ship)
    dev = resolve_device(device if device is not None else args.device)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")

    shipped_path = pretrained.checkpoint_path("raft")
    shipped_tree, cand_tree = read_tree(shipped_path), read_tree(args.candidate)
    dtypes = {"shipped": leaf_dtypes(shipped_path), "candidate": leaf_dtypes(args.candidate)}
    logger.info(f"leaf dtypes: {json.dumps(dtypes)}")
    base = ft.evaluate(ft.model_from_tree(shipped_tree, dev), scene, detection=False)
    logger.info(f"shipped: {json.dumps(base)}")

    rows, best = [], None
    for alpha in args.alphas:
        soup = soup_tree(shipped_tree, cand_tree, alpha)
        ev = ft.evaluate(ft.model_from_tree(soup, dev), scene)
        g = soup_gates(base, ev, args.ladder_gate)
        rows.append({"alpha": alpha, "evals": ev, "gates": g, "all_pass": all(g.values())})
        logger.info(f"alpha={alpha}: {json.dumps(ev)} | gates {json.dumps(g)}")
        if all(g.values()):
            # among passers the best worst-case drone-region EPE over the
            # three scene families: the detection-critical region
            score = max(ev["drone_epe"], ev["bench_drone_epe"], ev["sim_drone_epe"])
            if best is None or score < best[1]:
                best = (alpha, score, soup)
    res = {"device": str(dev), "candidate": os.path.abspath(args.candidate),
           "leaf_dtypes": dtypes, "baseline": base, "alphas": rows,
           "best_alpha": None, "soup_path": None, "shipped_to": None}
    if best is None:
        logger.info("no alpha passed all gates — nothing shipped")
    else:
        alpha, _, soup = best
        res["best_alpha"] = alpha
        res["soup_path"] = checkpoint.save_msgpack(args.out, soup)
        logger.info(f"ALL GATES PASS at alpha={alpha} (saved {args.out})")
        if args.ship:
            res["shipped_to"] = ft.ship(args.out)
            logger.info(f"shipped to {res['shipped_to']}")
    print(dumps(res))
    return res


if __name__ == "__main__":
    main()
