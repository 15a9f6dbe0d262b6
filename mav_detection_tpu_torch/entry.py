"""The port's entry points, the counterparts of the reference's
``__graft_entry__``: ``entry()`` returns the fused flow + detection step and
example arguments for it; ``dryrun_multichip(n)`` runs every multi-device
path once on ``n`` ranks at tiny shapes and prints one line per stage.

The step takes a grayscale frame pair plus IMU and aux inputs and runs the
Farneback solver and the whole detection math (derotation, FoE vote, phi,
threshold masks, pixel metrics) on the arguments' device. The reference's
PRNG key becomes the (2N, 2) (y, x) sample indices of the FoE vote, the last
argument. Flow parameters are the product's, ``tuned_flow_params(240, 320)``
with its (2, 3, 8) iteration schedule, so on the card the step launches the
fused iteration kernel.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from mav_detection_tpu_torch.ops.flow.farneback import (
    _farneback_cf,
    tuned_flow_params,
)
from mav_detection_tpu_torch.pipeline.detector import (
    DetectionStep,
    detect_frame_pair,
)
from mav_detection_tpu_torch.utils.device import resolve_device

ENTRY_SHAPE = (240, 320)
ENTRY_FOE_SAMPLES = 512


def entry(device: Union[str, torch.device] = "cuda"
          ) -> Tuple[Callable, Tuple[torch.Tensor, ...]]:
    """(fn, example_args) for the fused flow + detect step at 240x320 with
    512 FoE samples; ``fn(*example_args)`` returns ``foe, tpr_fixed,
    fpr_fixed, total_mask``. The example arguments are seeded numpy draws
    (the reference's, with the sample indices drawn last) on ``device``.
    Raises without a card unless ``device="cpu"``."""
    dev = resolve_device(device)
    h, w = ENTRY_SHAPE
    params = tuned_flow_params(h, w)
    config = DetectionStep(foe_samples=ENTRY_FOE_SAMPLES)

    def flow_detect_step(prev_gray, curr_gray, omega, dt, segmentation,
                         sky_mask, depth, gt_foe, sample_yx):
        flow = _farneback_cf(prev_gray[None], curr_gray[None], params)[0]
        out = detect_frame_pair(flow, torch.zeros_like(flow), omega, dt,
                                segmentation, sky_mask, depth, gt_foe,
                                sample_yx, config=config)
        return out.foe, out.tpr_fixed, out.fpr_fixed, out.total_mask

    rng = np.random.default_rng(0)
    n = 2 * ENTRY_FOE_SAMPLES
    host_args = (
        rng.random((h, w)).astype(np.float32) * 255,
        rng.random((h, w)).astype(np.float32) * 255,
        np.zeros(3, np.float32),
        np.asarray(0.05, np.float32),
        (rng.random((h, w)) > 0.99).astype(np.uint8) * 255,
        np.zeros((h, w), bool),
        np.ones((h, w), np.float32),
        np.asarray([w / 2.0, h / 2.0], np.float32),
        np.stack([rng.integers(0, h, n), rng.integers(0, w, n)], axis=-1),
    )
    return flow_detect_step, tuple(torch.from_numpy(a).to(dev)
                                   for a in host_args)


def _dryrun_rank(mesh) -> Optional[List[str]]:
    """The stages of ``dryrun_multichip`` as one rank: rank 0 returns the
    lines."""
    import logging

    from mav_detection_tpu_torch.core.config import RunConfig
    from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
    from mav_detection_tpu_torch.ops.flow.farneback import FarnebackParams
    from mav_detection_tpu_torch.parallel.halo import check_exchange, exchange_reference
    from mav_detection_tpu_torch.parallel.mesh import (
        aggregate_metrics_psum,
        detect_frames_sharded,
        shard_frame_batch,
    )
    from mav_detection_tpu_torch.parallel.spatial import farneback_flow_spatial
    from mav_detection_tpu_torch.pipeline.processor import Processor
    from mav_detection_tpu_torch.pipeline.temporal import detect_video_chunked

    n_dev, dev = mesh.size, mesh.device
    tag = f"dryrun_multichip({n_dev})"
    lines: List[str] = []
    rng = np.random.default_rng(0)

    # 1. the frame-batch data-parallel detection step, all-reduced metrics
    n, h, w = 2 * n_dev, 64, 96
    seg = torch.from_numpy((rng.random((n, h, w)) > 0.98).astype(np.uint8) * 255)
    flow = torch.from_numpy(rng.normal(size=(n, h, w, 2)).astype(np.float32))
    syx = torch.from_numpy(np.stack([rng.integers(0, h, (n, 256)),
                                     rng.integers(0, w, (n, 256))], -1))
    out = detect_frames_sharded(
        mesh, flow, torch.zeros_like(flow), torch.zeros((n, 3)),
        torch.full((n,), 0.05), seg, torch.zeros((n, h, w), dtype=torch.bool),
        torch.ones((n, h, w)), torch.tensor([[w / 2.0, h / 2.0]]).expand(n, 2),
        syx, DetectionStep(foe_samples=128))
    assert torch.isfinite(out.foe).all()
    tpr, fpr = aggregate_metrics_psum(
        mesh, shard_frame_batch(mesh, seg)[0].to(dev),
        (255 * out.estimate_fixed.to(torch.int32)).to(torch.uint8))
    assert torch.isfinite(fpr)
    lines.append(f"{tag}: detect ok — foe batch {(n, 2)}, global tpr="
                 f"{float(tpr):.3f} fpr={float(fpr):.5f}")

    # 2. the Processor's sharded loop, on-device Farneback included
    config = RunConfig(logger=logging.getLogger("dryrun"), dataset="synthetic",
                       mode="FLOW_FOE_CLUSTERING", flow_source="FARNEBACK",
                       batch_size=n_dev, devices=n_dev, headless=True)
    proc = Processor(config, device=dev, mesh=mesh, dataset=SyntheticDataset(
        params=SyntheticParams(height=96, width=128, n_frames=n_dev + 1)))
    proc.save_images = False
    results = proc.run_detection_foe()
    if mesh.rank == 0:
        assert len(results) == n_dev
        assert all(np.isfinite(r.foe_dense).all() for r in results.values())
        assert proc._psum_metrics, "psum metric reduction did not run"
        lines.append(f"{tag}: Processor sharded detection ok — {len(results)} "
                     f"FrameResults, psum TPR {proc._psum_metrics[0][0]:.3f}")

    # 3. chunked video: a time chunk per rank, a one-frame halo
    T = 2 * n_dev
    frames_t = torch.from_numpy((rng.random((T, 48, 64)) * 255).astype(np.float32))
    scal = detect_video_chunked(
        mesh, frames_t, torch.zeros((T, 3)), torch.full((T,), 0.05),
        torch.zeros((T, 48, 64), dtype=torch.uint8),
        torch.zeros((T, 48, 64), dtype=torch.bool), torch.ones((T, 48, 64)),
        torch.tensor([[32.0, 24.0]]).expand(T, 2),
        params=FarnebackParams(warp="separable", fast=True, max_shift=8),
        config=DetectionStep(foe_samples=64))
    assert torch.isfinite(scal.foe).all()
    lines.append(f"{tag}: chunked-video scan ok — {scal.foe.shape[0]} "
                 f"transitions over {n_dev} time chunks")

    # 4. spatial (row-sharded) Farneback: halo exchanges per refit
    hs = n_dev * 24
    prev_s = torch.from_numpy((rng.random((hs, 96)) * 255).astype(np.float32))
    curr_s = torch.from_numpy((rng.random((hs, 96)) * 255).astype(np.float32))
    sp = farneback_flow_spatial(prev_s, curr_s, FarnebackParams(
        warp="separable", levels=1, iterations=3, max_shift=8), mesh)
    assert tuple(sp.shape) == (hs, 96, 2) and torch.isfinite(sp).all()
    lines.append(f"{tag}: spatial row-sharded Farneback ok — {hs}x96 over "
                 f"{n_dev} row bands")

    # 5. the row-halo exchange and its backward against the whole tensor
    x = torch.from_numpy(rng.normal(size=(2, 6 * n_dev, 8)).astype(np.float32))
    wts = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    slab, grad = check_exchange(mesh, x, 3, 2, wts)
    ref_slabs, ref_grads = exchange_reference(x, wts, n_dev, 3, 2)
    err = max(float((slab.cpu() - ref_slabs[mesh.rank]).abs().max()),
              float((grad.cpu() - ref_grads[mesh.rank]).abs().max()))
    assert err < 1e-5, err
    lines.append(f"{tag}: row-halo exchange ok — forward and backward within "
                 f"{err:.1e} of the whole tensor's")

    # 6. the RAFT train step on a 2-D (data x rows) layout
    from mav_detection_tpu_torch.models.raft import RAFTConfig, create_raft

    d_sz = max(n_dev // 2, 1)
    s_sz = 2 if n_dev >= 2 else 1
    tiny = RAFTConfig(feature_dim=32, hidden_dim=32, context_dim=32,
                      corr_levels=2, corr_radius=2, iters=2)
    model = create_raft(torch.Generator().manual_seed(0), tiny).to(dev)
    bsz, hr, wr = d_sz * 2, 32 * s_sz, 48
    img = torch.from_numpy((rng.random((bsz, hr, wr, 3)) * 255).astype(np.float32))
    loss = raft_train_step_2d(mesh, d_sz, s_sz, model, img, img,
                              torch.zeros((bsz, hr, wr, 2)), config=tiny)
    if loss is not None:
        assert np.isfinite(loss)
        lines.append(f"{tag}: raft train step ok on {d_sz}x{s_sz} (data,rows) "
                     f"layout — loss={loss:.4f}")
    return lines if mesh.rank == 0 else None


def raft_train_step_2d(mesh, data: int, rows: int, model, images1, images2,
                       flow_gt, iters: int = 2, lr: float = 1e-4, config=None):
    """One RAFT training step (the sequence loss, then Adam) on a 2-D
    (data x rows) layout of the mesh's first ``data * rows`` ranks: the
    batch split over ``data``, the image rows over ``rows`` (the net runs
    row sharded, its halo gradients through ``exchange_rows``' backward),
    the gradient all-reduced over both axes. Every input is the whole
    batch, replicated; ``model`` is updated in place. Returns the global
    loss (the mean over the batch, as unsharded), or None on a rank outside
    the layout."""
    from mav_detection_tpu_torch.models.layers import row_sharded
    from mav_detection_tpu_torch.models.raft import raft_loss
    from mav_detection_tpu_torch.parallel.halo import band
    from mav_detection_tpu_torch.parallel.mesh import all_reduce_mean_, grid

    data_mesh, rows_mesh = grid(mesh, data, rows)
    if data_mesh is None:
        return None
    dev = mesh.device
    per = images1.shape[0] // data
    lanes = slice(data_mesh.rank * per, (data_mesh.rank + 1) * per)

    def mine(t: torch.Tensor) -> torch.Tensor:
        # (b, H, W, c): this rank's lanes and rows
        return band(t[lanes], rows_mesh, dim=1).to(dev)

    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    opt.zero_grad()
    with row_sharded(rows_mesh):
        loss = raft_loss(model, mine(images1), mine(images2), mine(flow_gt),
                         iters=iters, config=config).mean()
        loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in model.parameters()]
    for p, g in zip(model.parameters(), grads):
        p.grad = g
    # equal bands and lanes: the global mean loss is the mean of the local
    # ones, and its gradient the mean of the ranks' gradients
    loss = loss.detach().reshape(1).clone()
    for axis in (rows_mesh, data_mesh):
        all_reduce_mean_(grads + [loss], axis)
    opt.step()
    return float(loss[0])


def raft_train_step_2d_rank(mesh, data: int, rows: int, model, images1, images2,
                            flow_gt, iters: int = 2, config=None):
    """``raft_train_step_2d`` as a launch's rank function: (loss, the
    updated weights, the all-reduced gradients by parameter name) from rank
    0."""
    model = model.to(mesh.device)
    loss = raft_train_step_2d(mesh, data, rows, model, images1, images2, flow_gt,
                              iters=iters, config=config)
    if mesh.rank:
        return None
    return loss, model.state_dict(), {k: p.grad for k, p in model.named_parameters()}


def dryrun_multichip(n_devices: int,
                     device: Union[str, torch.device] = "cuda") -> List[str]:
    """Run the port's multi-device paths once over ``n_devices`` ranks (one
    process per card with NCCL, or gloo processes with ``device="cpu"``) on
    tiny shapes, printing one line per stage: the data-parallel detection
    step with its all-reduced metrics, the Processor's sharded loop, chunked
    video, spatial Farneback, the row-halo exchange, and the RAFT train step
    on a 2-D (data x rows) layout. Under a process
    group of ``n_devices`` ranks it runs as this rank; otherwise it spawns
    them. Returns rank 0's lines."""
    import torch.distributed as dist

    from mav_detection_tpu_torch.parallel.mesh import launch, make_mesh

    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        lines = _dryrun_rank(make_mesh(n_devices, dev)) or []
    else:
        lines = launch(_dryrun_rank, n_devices, dev)
    for line in lines:
        print(line)
    return lines
