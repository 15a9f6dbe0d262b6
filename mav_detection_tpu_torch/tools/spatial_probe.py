"""Probe: row-sharded (spatial) Farneback against the unsharded solver.

The port of ``tools/spatial_probe.py``. On the 1920x1024 bench scene with
the parameters the product's spatial engine runs (``tuned_flow_params``
with the separable warp: S 16 and the (2, 3, 8) schedule at this size) it
times, in ms per frame pair on the host clock around synchronised calls
(warmed up once):

  unsharded   the separable solver on one device, in this process;
  spatial P   ``farneback_flow_spatial`` on a mesh of P ranks spawned by
              ``parallel.mesh.launch`` (NCCL on the cards, gloo on the CPU),
              for the mesh of 1 and every P of ``--meshes`` that the
              devices allow and that divides H;

and for each mesh the largest difference from the unsharded flow (the
reference's gate is 1e-3 px), the halo hops a call makes (one
``exchange_rows`` per refit of each row-sharded level), the time of one hop
at each level's band (host clock, 20 after 3 warm-up) and their share of
the call. The tool ran random frames with S 8 and 6 iterations at every
layer. The work does not depend on the pixels, but the gate does: where the
shift the warp may take is shorter than the motion (S 8 against the hires
scene's ~12 px) or the flow is noise, the clipped separable warp jumps
where a coordinate crosses an integer, and the slab expansion's rounding
(``poly_exp`` on edge-replicated slabs against the fused matrices) then
moves the flow by up to 0.03 px on the H100 (0.09 px on the CPU); S 8 is
outside the hires GT gate besides (``hires_flow_sweep``)::

    python -m mav_detection_tpu_torch.tools.spatial_probe [H W] [--meshes 2,4,8]

(H must divide by every probed mesh size.) ``--device cpu`` runs the
ranks on the CPU with gloo.
"""
from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch

from mav_detection_tpu_torch.ops.flow.farneback import (
    FarnebackParams,
    _farneback_cf,
    _level_iter_count,
    _pyramid_scales,
    _refit_schedule,
    tuned_flow_params,
)
from mav_detection_tpu_torch.parallel.mesh import available_devices, backend_for, launch
from mav_detection_tpu_torch.tools.common import dumps, ints, parser, scene
from mav_detection_tpu_torch.utils.device import resolve_device
from mav_detection_tpu_torch.utils.timing import device_name

REPS = 5
HOP_REPS = 20
TOL_PX = 1e-3


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sync_ms(fn, dev: torch.device, reps: int, warm: int = 1) -> float:
    """Mean host-clock ms per call, the device synchronised before and
    after."""
    for _ in range(warm):
        fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def halo_hops(h: int, w: int, params: FarnebackParams, size: int) -> list:
    """[(band rows, hops)] of every row-sharded level of a call on ``size``
    ranks (``parallel.spatial._flow_spatial``'s rule: a level whose band
    holds the flow halo is sharded, and refits once before its iterations
    and once after each refit iteration)."""
    fh_r = params.max_shift + params.winsize // 2 + 2
    out = []
    for k, scale in enumerate(_pyramid_scales(h, w, params)):
        lh = int(round(h * scale))
        if lh % size == 0 and lh // size >= fh_r:
            n = _level_iter_count(params, k)
            out.append((lh // size, int(round(w * scale)),
                        1 + len(_refit_schedule(params, n))))
    return out


def spatial_rank(mesh, prev: np.ndarray, curr: np.ndarray, params: FarnebackParams,
                 reps: int):
    """One rank: the spatial flow, its ms per call, and one halo hop's ms at
    each sharded level's band. Rank 0 returns them."""
    from mav_detection_tpu_torch.parallel.halo import exchange_rows
    from mav_detection_tpu_torch.parallel.spatial import farneback_flow_spatial

    dev = mesh.device
    p = torch.as_tensor(prev, dtype=torch.float32).to(dev)
    c = torch.as_tensor(curr, dtype=torch.float32).to(dev)
    flow = farneback_flow_spatial(p, c, params, mesh)
    ms = sync_ms(lambda: farneback_flow_spatial(p, c, params, mesh), dev, reps)
    fh_r = params.max_shift + params.winsize // 2 + 2
    hops = []
    for rows, cols, n in halo_hops(p.shape[0], p.shape[1], params, mesh.size):
        band = torch.zeros((1, 2, rows, cols), device=dev)
        hop = sync_ms(lambda: exchange_rows(band, fh_r, fh_r, mesh), dev, HOP_REPS, warm=3)
        hops.append({"band": f"{rows}x{cols}", "hops": n, "hop_ms": hop})
    return {"flow": flow, "ms": ms, "hops": hops} if mesh.rank == 0 else None


def main(argv=None, device=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("H", type=int, nargs="?", default=1024)
    ap.add_argument("W", type=int, nargs="?", default=1920)
    ap.add_argument("--meshes", default="2,4,8", help="mesh sizes beyond 1 to probe")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    H, W = args.H, args.W
    params = replace(tuned_flow_params(H, W), warp="separable")
    reps = REPS if dev.type == "cuda" else 1
    prev, curr = (f.astype(np.float32) for f in scene(H, W, hires=True)[:2])
    name = device_name(dev)
    p = torch.from_numpy(prev).to(dev)[None]
    c = torch.from_numpy(curr).to(dev)[None]
    ref = _farneback_cf(p, c, params)[0]
    un_ms = sync_ms(lambda: _farneback_cf(p, c, params), dev, reps)
    ref = ref.cpu()
    print(f"unsharded {H}x{W} on {name} (S {params.max_shift}, schedule "
          f"{params.level_iters}): {un_ms:.2f} ms/frame")
    avail = available_devices(dev)
    res = {"device": name, "size": f"{W}x{H}", "max_shift": params.max_shift, "level_iters": params.level_iters,
           "backend": backend_for(dev),
           "devices_available": avail, "unsharded_ms": un_ms, "tol_px": TOL_PX,
           "meshes": []}
    sizes = [1] + [n for n in ints(args.meshes) if n > 1 and n <= avail and H % n == 0]
    skipped = [n for n in ints(args.meshes) if n not in sizes]
    for size in sizes:
        got = launch(spatial_rank, size, dev, prev, curr, params, reps)
        err = float((got["flow"] - ref).abs().max())
        hop_ms = sum(hp["hops"] * hp["hop_ms"] for hp in got["hops"])
        row = {"P": size, "ms": got["ms"], "speedup": un_ms / got["ms"],
               "max_abs_err_px": err, "within_tol": err <= TOL_PX, "hops": got["hops"],
               "hops_per_call": sum(hp["hops"] for hp in got["hops"]),
               "hop_ms_per_call": hop_ms, "hop_share": hop_ms / got["ms"]}
        res["meshes"].append(row)
        print(f"spatial P={size}: {got['ms']:.2f} ms/frame ({row['speedup']:.2f}x "
              f"unsharded), max |flow - unsharded| {err:.3g} px (tol {TOL_PX}), "
              f"{row['hops_per_call']} halo hops, {hop_ms:.3f} ms of them "
              f"(share {row['hop_share']:.3f})")
    if skipped:
        print(f"meshes not run (more than the {avail} devices, or not dividing H): {skipped}")
    res["skipped"] = skipped
    print(dumps(res))
    return res


if __name__ == "__main__":
    main()
