"""Demonstrate-or-demote RAFT: Farneback and RAFT head to head on the
failure modes of local least squares.

The port of ``tools/raft_advantage_probe.py``. Four scene families with
analytic GT:

* ``grating``     periodic texture (period 8 px) shifted (3, 1) px: the
                  local solve aliases to the nearest lattice displacement;
* ``lowcontrast`` +-2 gray levels of smooth texture: the normal equations
                  go singular;
* ``boundary``    two textured half-planes, the right one moving 4 px: the
                  box-blurred normal equations smear flow across the
                  discontinuity (scored in a +-8 px band around it);
* ``control``     the blurred-noise bench texture shifted (3, 1) px.

Each reports interior EPE for Farneback (``tuned_flow_params``, the fused
iteration kernel on the card) and RAFT (the shipped checkpoint, the
product's iterations); RAFT wins a family when its EPE is below 0.8x
Farneback's, and the verdict line states which. The families are rendered
without cv2: ``cv2.GaussianBlur(..., (0, 0), sigma)`` is
``cli.train.gaussian_blur_cv`` (OpenCV's kernel and reflect-101 borders),
and ``cv2.warpAffine`` by an integer shift with BORDER_REFLECT is an exact
shift over ``np.pad(mode="symmetric")``::

    python -m mav_detection_tpu_torch.tools.raft_advantage_probe [--size 240x320]

``--device cpu`` runs the plain versions.
"""
from __future__ import annotations

import numpy as np

from mav_detection_tpu_torch.tools.common import dumps, hw, masked_epe, parser
from mav_detection_tpu_torch.utils.device import resolve_device

WIN_RATIO = 0.8


def shift_reflect(img: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """``img`` moved by the integer (dx, dy): out[y, x] = img[y - dy, x - dx],
    reflected (edge pixel repeated) past the border, as ``cv2.warpAffine``
    with a translation and BORDER_REFLECT gives it."""
    if dx != int(dx) or dy != int(dy):
        raise ValueError(f"shift ({dx}, {dy}) is not whole pixels")
    dx, dy = int(dx), int(dy)
    h, w = img.shape
    pad = np.pad(img, ((abs(dy), abs(dy)), (abs(dx), abs(dx))), mode="symmetric")
    return pad[abs(dy) - dy:abs(dy) - dy + h, abs(dx) - dx:abs(dx) - dx + w]


def make_families(h: int, w: int, seed: int = 7) -> dict:
    """name -> (prev, curr, gt_flow (h, w, 2)), fp32 frames."""
    from mav_detection_tpu_torch.cli.train import gaussian_blur_cv

    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    fams = {}

    def uniform(prev, d):
        gt = np.broadcast_to(np.asarray(d, np.float32), (h, w, 2)).copy()
        return prev, shift_reflect(prev, d[0], d[1]), gt

    # period 8 px, true shift 3 px: the nearest alias is -5 px
    grat = (128.0 + 60.0 * np.sin(2 * np.pi * xs / 8.0)).astype(np.float32)
    fams["grating"] = uniform(grat, (3.0, 1.0))

    base = gaussian_blur_cv(rng.random((h, w)).astype(np.float32), 3.0)
    base = (base - base.mean()) / max(base.std(), 1e-9)
    fams["lowcontrast"] = uniform((128.0 + 2.0 * base).astype(np.float32), (3.0, 1.0))

    tex = gaussian_blur_cv(rng.random((h, w)).astype(np.float32), 1.5)
    tex = (tex - tex.min()) / max(np.ptp(tex), 1e-6) * 220 + 20
    moved = shift_reflect(tex, 4.0, 0.0)
    half = xs >= w / 2
    gt = np.zeros((h, w, 2), np.float32)
    gt[..., 0] = np.where(half, 4.0, 0.0)
    fams["boundary"] = (tex.astype(np.float32), np.where(half, moved, tex).astype(np.float32),
                        gt)

    fams["control"] = uniform(tex.astype(np.float32), (3.0, 1.0))
    return fams


def family_mask(name: str, h: int, w: int) -> np.ndarray:
    """The scored pixels: the 16-px interior, or for ``boundary`` the +-8 px
    band around the discontinuity within it."""
    mask = np.zeros((h, w), bool)
    if name == "boundary":
        bx = int(w / 2)
        mask[16:-16, max(bx - 8, 0):bx + 8] = True
    else:
        mask[16:-16, 16:-16] = True
    return mask


def main(argv=None, device=None) -> dict:
    from mav_detection_tpu_torch.models import pretrained
    from mav_detection_tpu_torch.models.raft import raft_flow
    from mav_detection_tpu_torch.ops.flow.farneback import farneback_flow, tuned_flow_params

    ap = parser(__doc__)
    ap.add_argument("--size", type=hw, default=(240, 320), metavar="HxW")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    h, w = args.size
    params = tuned_flow_params(h, w)
    model = pretrained.load_raft(dev)
    if model is None:
        raise RuntimeError("no shipped RAFT checkpoint: refusing to report untrained numbers")
    rows, wins = [], []
    for name, (prev, curr, gt) in make_families(h, w).items():
        fb = farneback_flow(prev, curr, params, device=dev).cpu().numpy()
        rf = raft_flow(model, prev[None], curr[None])[0].cpu().numpy()
        mask = family_mask(name, h, w)
        fb_epe, rf_epe = masked_epe(fb, gt, mask), masked_epe(rf, gt, mask)
        row = {"family": name, "farneback_epe": fb_epe, "raft_epe": rf_epe,
               "raft_wins": rf_epe < WIN_RATIO * fb_epe}
        if row["raft_wins"]:
            wins.append(name)
        rows.append(row)
        print(dumps(row))
    verdict = (f"RAFT wins {wins} by >20%" if wins else
               "RAFT wins no family — demote to the trainable/research path")
    print(dumps({"verdict": verdict}))
    res = {"device": str(dev), "size": f"{h}x{w}", "warp": params.warp, "rows": rows,
           "wins": wins, "verdict": verdict}
    print(dumps(res))
    return res


if __name__ == "__main__":
    main()
