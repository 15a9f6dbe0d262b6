"""Training of the three learned nets (``mav_detection_tpu.cli.train``):
RAFT, the sky UNet and TinyYOLO, on the card.

Scenes are rendered on the device (``data/synthgen``) and fed to the loss in
the same step. A "chunk" is the reference's jitted ``lax.scan`` over steps:
here a Python loop of steps whose losses stay on the card, pulled to the host
once per chunk (the reference's one round trip per chunk). Between chunks an
optional selector scores the weights on a held-out host fixture
(``data/synthetic``) and keeps the best, saving every new best at once.

Usage::

    python -m mav_detection_tpu_torch.cli.train --model all
    python -m mav_detection_tpu_torch.cli.train --model raft --steps 4000
    python -m mav_detection_tpu_torch.cli.train --model raft --eval-only

Checkpoints are written as Flax msgpack files (``models/checkpoint.py``,
``convert.flax_from_*_state_dict``) to ``checkpoints/<name>.msgpack`` under
``MAV_CHECKPOINT_PATH`` when set (``models/pretrained.py``), so the JAX
package reads what the port trains. Entry points train on the card and raise
without one unless given ``device="cpu"`` (``--device cpu``).

Random draws cannot match across frameworks: each trainer takes ``draws``,
a callable giving the ``SceneDraws`` of a step, and draws from a
``torch.Generator`` seeded ``seed + 1`` when none is given.

``--devices N`` trains RAFT data parallel, one process per device
(``parallel/mesh.py``: NCCL on the cards, gloo with ``--device cpu``): every
rank draws the whole batch's ``SceneDraws`` from the same seed and renders
its own slice of it, the gradients are averaged with one all-reduce before
the global-norm clip (which then sees the global gradient, as optax does
under GSPMD), Adam runs replicated, and the selector and the saves run on
rank 0, whose weights every rank takes at the end.
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from mav_detection_tpu_torch.data.synthgen import SceneDraws, draw_scenes, generate_batch
from mav_detection_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("mav_detection_tpu_torch.train")
Device = Union[str, torch.device]
DrawsFn = Callable[[int], SceneDraws]


def _gray3(img: torch.Tensor) -> torch.Tensor:
    """(B, h, w) grayscale -> (B, h, w, 3) like the fixture's RGB frames."""
    return img[..., None].expand(*img.shape, 3)


def _snapshot(params: Any) -> Any:
    """A copy of the weights that later steps do not change: a module's
    state_dict cloned, anything else as it is."""
    if isinstance(params, torch.nn.Module):
        return {k: v.detach().clone() for k, v in params.state_dict().items()}
    return params


def _scan_chunks(run_chunk, params, opt_state, key, steps: int, chunk: int,
                 label: str, selector=None, select_every: int = 1,
                 save_best_to: str = "", to_tree: Optional[Callable] = None):
    """Drive ``run_chunk(params, opt_state, key, n) -> (params, opt_state,
    key, losses)`` over ``steps`` steps in chunks of ``chunk``, pulling each
    chunk's losses once and logging them.

    ``selector(params) -> float`` scores the weights on a held-out fixture
    after every ``select_every`` chunks and at the end; the best-scoring
    weights are returned instead of the last ones, and the initial weights'
    score is the bar to beat (a resumed run never regresses its checkpoint).
    With ``save_best_to`` every new best is written at once (crash
    insurance) as ``to_tree(snapshot)``. For a module the best weights are
    loaded back into it."""
    from mav_detection_tpu_torch.models import checkpoint

    t0 = time.time()
    all_losses = []
    done = 0
    n_chunks = 0
    best_score = selector(params) if selector is not None else -np.inf
    best = _snapshot(params) if selector is not None else None
    if selector is not None:
        logger.info(f"[{label}] initial holdout {best_score:.4f}")
    while done < steps:
        n = min(chunk, steps - done)
        params, opt_state, key, losses = run_chunk(params, opt_state, key, n)
        losses = np.asarray(losses.cpu() if isinstance(losses, torch.Tensor)
                            else losses)
        all_losses.append(losses)
        done += n
        n_chunks += 1
        msg = (f"[{label}] step {done}/{steps} loss {losses[-10:].mean():.4f} "
               f"({done / max(time.time() - t0, 1e-9):.1f} steps/s)")
        if selector is not None and (n_chunks % select_every == 0 or done >= steps):
            score = selector(params)
            if score > best_score:
                best_score = score
                best = _snapshot(params)
                if save_best_to:
                    checkpoint.save_msgpack(
                        save_best_to, to_tree(best) if to_tree is not None else best)
            msg += f" holdout {score:.4f} (best {best_score:.4f})"
        logger.info(msg)
    if selector is not None:
        if isinstance(params, torch.nn.Module):
            params.load_state_dict(best)
        else:
            params = best
    return params, np.concatenate(all_losses) if all_losses else np.zeros(0)


def _check_devices(devices: int, batch: int, device: Device) -> None:
    """The reference's ``--devices`` checks, in its order and words (on the
    CPU the available count is the gloo ranks ``parallel.mesh`` offers)."""
    from mav_detection_tpu_torch.parallel.mesh import available_devices

    if devices <= 1:
        return
    avail = available_devices(device)
    if devices > avail:
        raise ValueError(f"--devices {devices} > {avail} available devices")
    if batch % devices:
        raise ValueError(f"--batch {batch} must divide by --devices {devices}")


class _StepDraws:
    """``draws`` fixed up front for every step, on the CPU: a callable that
    pickles into spawned ranks."""

    def __init__(self, draws: DrawsFn, steps: int) -> None:
        self.per_step = [SceneDraws(*(t.cpu() for t in draws(s))) for s in range(steps)]

    def __call__(self, step: int) -> SceneDraws:
        return self.per_step[step]


def _draws_fn(draws: Optional[DrawsFn], batch: int, h: int, w: int,
              pan_max: float, seed: int, dev: torch.device) -> DrawsFn:
    if draws is not None:
        return draws
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    return lambda step: draw_scenes(batch, h, w, pan_max, gen, dev)


def _make_run_chunk(step_fn: Callable[[int], torch.Tensor]):
    """A ``run_chunk`` over ``step_fn(step) -> loss`` (one optimizer step,
    the loss a device scalar); ``key`` is the step counter. Nothing in the
    chunk reads a device value."""

    def run_chunk(params, opt_state, key, n):
        losses = [step_fn(key + i) for i in range(n)]
        return params, opt_state, key + n, torch.stack(losses)

    return run_chunk


def _step(opt, loss_of: Callable[[], torch.Tensor], mesh=None) -> torch.Tensor:
    """One update; with ``mesh`` the gradients (and the reported loss) are
    averaged over the ranks with one all-reduce before the optimizer's clip."""
    opt.zero_grad()
    loss = loss_of()
    loss.backward()
    loss = loss.detach()
    if mesh is not None:
        from mav_detection_tpu_torch.parallel.mesh import all_reduce_mean_

        for p in opt.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss = loss.reshape(1).clone()
        all_reduce_mean_([p.grad for p in opt.params] + [loss], mesh)
        loss = loss[0]
    opt.step()
    return loss


def _selection_fixture(**kw):
    from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams

    return SyntheticDataset(params=SyntheticParams(**kw))


def _frames(ds, idx, dev) -> torch.Tensor:
    return torch.as_tensor(np.stack([ds.get_frame(i) for i in idx])).to(dev)


# ------------------------------------------------------------------- RAFT
def drone_weight_map(seg: torch.Tensor, drone_weight: float) -> torch.Tensor:
    """(b, h, w) drone masks -> pixel weights ``1 + drone_weight * dil``,
    ``dil`` the 5x5 max-pool (SAME) of the mask."""
    m = seg.to(torch.float32)[:, None]
    dil = F.max_pool2d(m, 5, stride=1, padding=2)
    return 1.0 + drone_weight * dil[:, 0]


def raft_batch_loss(model, sc, iters: int, drone_weight: float = 40.0,
                    config=None) -> torch.Tensor:
    """The RAFT trainer's loss of one batch of scenes: the mean over the
    batch of the sequence loss on the gray frames, the drone upweighted."""
    from mav_detection_tpu_torch.models.raft import raft_loss

    return raft_loss(model, _gray3(sc.img1), _gray3(sc.img2), sc.flow, iters=iters,
                     pixel_weight=drone_weight_map(sc.seg, drone_weight),
                     config=config).mean()


def train_raft(steps: int = 4000, batch: int = 8,
               hw: Tuple[int, int] = (128, 160), iters: int = 8,
               peak_lr: float = 2.5e-4, chunk: int = 100, seed: int = 0,
               init_params: Optional[Dict[str, torch.Tensor]] = None,
               save_best_to: str = "", drone_weight: float = 40.0,
               sin_blend: float = 0.6, pan_max: float = 0.0, devices: int = 0,
               config=None, use_selector: bool = True, device: Device = "cuda",
               draws: Optional[DrawsFn] = None, mesh=None):
    """Train RAFT on generated scenes -> (model, losses). ``init_params`` (a
    state_dict) resumes; ``config`` (the full ``RAFTConfig``, bf16, by
    default) and ``use_selector`` exist for tests. ``devices > 1`` trains
    data parallel: on spawned ranks when there is no process group (rank
    0's weights come back), else as this process's rank (or ``mesh``'s)."""
    from mav_detection_tpu_torch.convert import flax_from_raft_state_dict
    from mav_detection_tpu_torch.models.optim import TrainOptimizer, train_schedule
    from mav_detection_tpu_torch.models.raft import RAFTConfig, create_raft
    from mav_detection_tpu_torch.parallel import mesh as pmesh

    _check_devices(devices, batch, device)
    dev = resolve_device(device)
    if devices > 1 and mesh is None:
        if not torch.distributed.is_initialized():
            return _train_raft_spawned(
                devices, dev, draws, steps=steps, batch=batch, hw=hw, iters=iters,
                peak_lr=peak_lr, chunk=chunk, seed=seed, init_params=init_params,
                save_best_to=save_best_to, drone_weight=drone_weight,
                sin_blend=sin_blend, pan_max=pan_max, config=config,
                use_selector=use_selector)
        mesh = pmesh.make_mesh(devices, dev)
    lead = mesh is None or mesh.rank == 0
    if mesh is not None:
        dev = mesh.device
        logger.info(f"[raft] data-parallel over {mesh.size} devices "
                    f"(per-device batch {batch // mesh.size})")
    h, w = hw
    config = config or RAFTConfig()
    model = create_raft(torch.Generator().manual_seed(seed), config)
    if init_params is not None:
        model.load_state_dict(init_params)
    model = model.to(dev)
    opt = TrainOptimizer(model.parameters(), train_schedule(peak_lr, steps, 200),
                         weight_decay=1e-5)
    draw = _draws_fn(draws, batch, h, w, pan_max, seed, dev)
    # every rank draws the whole batch and renders its slice
    local = batch if mesh is None else batch // mesh.size
    mine = slice(0, batch) if mesh is None else slice(mesh.rank * local,
                                                      (mesh.rank + 1) * local)

    def loss_of(step: int) -> torch.Tensor:
        d = SceneDraws(*(t[mine] for t in draw(step)))
        sc = generate_batch(local, h, w, pan_max, sin_blend, d, device=dev)
        return raft_batch_loss(model, sc, iters, drone_weight, config)

    sel_sets = [
        _selection_fixture(seed=782, n_frames=4, foe=(140.0, 150.0), expansion=0.013,
                           drone_start=(230.0, 90.0), drone_velocity=(-3.0, 2.5)),
        _selection_fixture(seed=783, n_frames=4, foe=(180.0, 110.0), expansion=0.018,
                           drone_radius=4, drone_start=(90.0, 150.0),
                           drone_velocity=(4.0, -3.0)),
    ] if use_selector else []

    def selector(m) -> float:
        # the worst of overall and drone EPE on both fixtures (and, with a
        # pan, the shift ladder), plus a small sum term for ties
        from mav_detection_tpu_torch.models.raft import raft_flow

        worst, total = 0.0, 0.0
        if pan_max > 0.0:
            ladder = shift_ladder_epe(m, iters=iters)
            worst = max(worst, ladder)
            total += ladder
        for ds in sel_sets:
            n = ds.N - 1
            fl = raft_flow(m, _frames(ds, range(n), dev), _frames(ds, range(1, n + 1), dev),
                           iters=iters).cpu().numpy()
            err = np.linalg.norm(fl - ds.flows[:n], axis=-1)
            epes = [err[i].mean() for i in range(n)]
            depes = [err[i][ds.segs[i] > 0].mean() for i in range(n) if (ds.segs[i] > 0).any()]
            epe = float(np.mean(epes))
            depe = float(np.mean(depes or [0.0]))
            worst = max(worst, epe, depe)
            total += epe + depe
        return -(worst + 0.05 * total)

    run_chunk = _make_run_chunk(lambda s: _step(opt, lambda: loss_of(s), mesh))
    model, losses = _scan_chunks(
        run_chunk, model, opt, 0, steps, chunk, "raft",
        selector=selector if use_selector and lead else None, select_every=10,
        save_best_to=save_best_to if lead else "", to_tree=flax_from_raft_state_dict)
    if mesh is not None and use_selector:
        # rank 0's selection is every rank's
        pmesh.broadcast_(list(model.state_dict().values()), mesh)
    return model, losses


def _train_raft_rank(mesh, draws, kwargs):
    """A spawned rank of ``train_raft``: rank 0 returns its weights and
    losses."""
    model, losses = train_raft(**kwargs, devices=mesh.size, device=mesh.device,
                               draws=draws, mesh=mesh)
    return (model.state_dict(), losses) if mesh.rank == 0 else None


def _train_raft_spawned(devices: int, dev: torch.device, draws: Optional[DrawsFn],
                        **kwargs):
    """``train_raft`` on ``devices`` spawned ranks; rank 0's weights come
    back as a model on ``dev``. Given ``draws`` are fixed up front (they
    must reach the ranks)."""
    from mav_detection_tpu_torch.models.raft import RAFT, RAFTConfig
    from mav_detection_tpu_torch.parallel import mesh as pmesh

    if draws is not None:
        draws = _StepDraws(draws, kwargs["steps"])
    state, losses = pmesh.launch(_train_raft_rank, devices, dev, draws, kwargs)
    with torch.device("meta"):
        model = RAFT(kwargs["config"] or RAFTConfig())
    model.load_state_dict({k: v.to(dev) for k, v in state.items()}, assign=True)
    return model, losses


def gaussian_blur_cv(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` of a float32 (h, w) image:
    OpenCV's kernel size for float images (``round(8 * sigma + 1) | 1``
    taps), its normalised Gaussian and BORDER_REFLECT_101 borders, as two
    banded fp32 matmuls."""
    from mav_detection_tpu_torch.ops.flow.farneback import _gaussian_kernel, _sep_correlate

    k = _gaussian_kernel(int(round(sigma * 4 * 2 + 1)) | 1, sigma)
    t = torch.as_tensor(np.asarray(img, np.float32))
    return _sep_correlate(t, k, k, "reflect").numpy()


def shift_ladder_epe(model, shifts: Tuple[int, ...] = (4, 8, 12),
                     hw: Tuple[int, int] = (256, 320), seed: int = 3,
                     iters: int = 0) -> float:
    """Worst interior EPE over uniform-shift pairs: a blurred-noise texture
    translated k px in x; EPE is the mean of |f - (k, 0)| 24 px inside the
    borders. All shifts run as one batch on the model's device."""
    from mav_detection_tpu_torch.models.raft import PRODUCT_ITERS, raft_flow

    iters = iters or PRODUCT_ITERS
    h, w = hw
    rng = np.random.default_rng(seed)
    base = gaussian_blur_cv(rng.random((h + 64, w + 64)).astype(np.float32), 1.5)
    base = (base - base.min()) / max(np.ptp(base), 1e-6) * 220 + 20
    prev = np.stack([base[32:32 + h, 32:32 + w]] * len(shifts))
    curr = np.stack([base[32:32 + h, 32 - k:32 - k + w] for k in shifts])
    dev = model.mask_head.weight.device
    f = raft_flow(model, torch.as_tensor(prev[..., None]).to(dev),
                  torch.as_tensor(curr[..., None]).to(dev), iters=iters).cpu().numpy()
    k = np.asarray(shifts, np.float32)[:, None, None]
    err = np.hypot(f[..., 0] - k, f[..., 1])[:, 24:-24, 24:-24].mean(axis=(1, 2))
    return float(max(0.0, float(err.max())))


def _eval_fixture(n_frames: int):
    return _selection_fixture(seed=777, n_frames=n_frames, foe=(150.0, 130.0),
                              expansion=0.015, drone_start=(220.0, 80.0),
                              drone_velocity=(-3.5, 2.0))


def eval_raft(model, n_pairs: int = 12, iters: int = 0) -> Tuple[float, float]:
    """(overall EPE, drone-region EPE) on the held-out host fixture (seed
    777, 240x320); ``iters=0`` is the product default. All pairs run as one
    batch on the model's device."""
    from mav_detection_tpu_torch.models.raft import PRODUCT_ITERS, raft_flow

    iters = iters or PRODUCT_ITERS
    ds = _eval_fixture(n_pairs + 1)
    dev = model.mask_head.weight.device
    flow = raft_flow(model, _frames(ds, range(n_pairs), dev),
                     _frames(ds, range(1, n_pairs + 1), dev), iters=iters).cpu().numpy()
    err = np.linalg.norm(flow - ds.flows[:n_pairs], axis=-1)
    epes = [float(err[i].mean()) for i in range(n_pairs)]
    depes = [float(err[i][ds.segs[i] > 0].mean()) for i in range(n_pairs)
             if (ds.segs[i] > 0).any()]
    return float(np.mean(epes)), float(np.mean(depes or [0.0]))


def eval_raft_detection(model, n_pairs: int = 8, iters: int = 0) -> Tuple[float, float]:
    """(RAFT-flow TPR, GT-flow TPR) of the fixed-threshold detection step on
    the held-out fixture; the FoE vote's draws come from a generator seeded
    0, the same for both flows."""
    from mav_detection_tpu_torch.models.raft import PRODUCT_ITERS, raft_flow
    from mav_detection_tpu_torch.ops.geometry.foe import sample_points
    from mav_detection_tpu_torch.pipeline.detector import DetectionStep, detect_frame_batch

    iters = iters or PRODUCT_ITERS
    ds = _eval_fixture(n_pairs + 1)
    dev = model.mask_head.weight.device
    config = DetectionStep(foe_samples=512)
    h, w = ds.flows.shape[1:3]
    sample_yx = sample_points(n_pairs, config.foe_samples, h, w,
                              torch.Generator(device=dev).manual_seed(0), dev)
    idx = range(n_pairs)
    flows = {"raft": raft_flow(model, _frames(ds, idx, dev),
                               _frames(ds, range(1, n_pairs + 1), dev), iters=iters),
             "gt": torch.as_tensor(ds.flows[:n_pairs]).to(dev)}

    def col(fn, dtype=torch.float32):
        return torch.as_tensor(np.stack([np.asarray(fn(i)) for i in idx])).to(dev, dtype)

    dt = col(lambda i: ds.get_delta_time(i + 1))
    common = (col(lambda i: ds.get_angular_difference(i, i + 1)) / dt[:, None], dt,
              col(lambda i: ds.get_segmentation(i)[..., 0], torch.uint8),
              col(lambda i: ds.get_sky_segmentation(i), torch.bool),
              col(ds.get_depth), col(ds.get_gt_foe))
    tprs = {}
    for name, fl in flows.items():
        out = detect_frame_batch(fl, torch.zeros_like(fl), *common,
                                 sample_yx=sample_yx, config=config)
        tprs[name] = float(out.tpr_fixed.mean())
    return tprs["raft"], tprs["gt"]


# -------------------------------------------------------------------- sky
def sky_batch_loss(model, sc, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The sky trainer's loss of one batch: the mean balanced cross-entropy
    of the gray frames against the sky band."""
    from mav_detection_tpu_torch.models.sky_segmentation import sky_loss

    return sky_loss(model, _gray3(sc.img1), sc.sky, dtype).mean()


def train_sky(steps: int = 1500, batch: int = 8, hw: Tuple[int, int] = (240, 320),
              peak_lr: float = 1e-3, chunk: int = 100, seed: int = 0,
              init_params: Optional[Dict[str, torch.Tensor]] = None,
              use_selector: bool = True, device: Device = "cuda",
              draws: Optional[DrawsFn] = None, save_best_to: str = "",
              dtype: torch.dtype = torch.bfloat16):
    """Train the sky UNet on generated scenes -> (model, losses)."""
    from mav_detection_tpu_torch.convert import flax_from_sky_state_dict
    from mav_detection_tpu_torch.models.optim import TrainOptimizer, train_schedule
    from mav_detection_tpu_torch.models.sky_segmentation import create_sky_model, sky_logits

    dev = resolve_device(device)
    h, w = hw
    model = create_sky_model(torch.Generator().manual_seed(seed))
    if init_params is not None:
        model.load_state_dict(init_params)
    model = model.to(dev)
    opt = TrainOptimizer(model.parameters(), train_schedule(peak_lr, steps, 100))
    draw = _draws_fn(draws, batch, h, w, 0.0, seed, dev)

    def loss_of(step: int) -> torch.Tensor:
        return sky_batch_loss(model, generate_batch(batch, h, w, draws=draw(step),
                                                    device=dev), dtype)

    sel_ds = _selection_fixture(seed=780, n_frames=4, horizon=0.32) if use_selector else None

    def selector(m) -> float:
        gt = sel_ds.sky_gt
        est = (sky_logits(m, _frames(sel_ds, range(sel_ds.N), dev)) > 0.0).cpu().numpy()
        tpr = (est & gt).sum((1, 2)) / max(gt.sum(), 1)
        fpr = (est & ~gt).sum((1, 2)) / max((~gt).sum(), 1)
        return float(np.sum(tpr - 10.0 * fpr) / sel_ds.N)

    run_chunk = _make_run_chunk(lambda s: _step(opt, lambda: loss_of(s)))
    return _scan_chunks(run_chunk, model, opt, 0, steps, chunk, "sky",
                        selector=selector if use_selector else None,
                        save_best_to=save_best_to, to_tree=flax_from_sky_state_dict)


def eval_sky(model, n_frames: int = 12) -> Tuple[float, float, float, float]:
    """(net TPR, net FPR, precomputed-mask TPR, precomputed-mask FPR) against
    the depth-band ground truth of the held-out fixture (seed 778)."""
    from mav_detection_tpu_torch.models.sky_segmentation import sky_logits

    ds = _selection_fixture(seed=778, n_frames=n_frames, horizon=0.4)
    gt = ds.sky_gt
    dev = model.head.weight.device
    est = (sky_logits(model, _frames(ds, range(n_frames), dev)) > 0.0).cpu().numpy()
    stats = np.zeros(4)
    for i in range(n_frames):
        pre = np.asarray(ds.get_sky_segmentation(i))
        stats += [(est[i] & gt).sum() / max(gt.sum(), 1),
                  (est[i] & ~gt).sum() / max((~gt).sum(), 1),
                  (pre & gt).sum() / max(gt.sum(), 1),
                  (pre & ~gt).sum() / max((~gt).sum(), 1)]
    return tuple(stats / n_frames)  # type: ignore[return-value]


# ------------------------------------------------------------------- yolo
def _best_iou(boxes, gt) -> float:
    from mav_detection_tpu_torch.core.rectangle import Rectangle

    best = 0.0
    for j in range(len(boxes.valid)):
        if boxes.valid[j]:
            x, y, bw, bh = (float(v) for v in boxes.xywh[j])
            best = max(best, Rectangle.calculate_iou_safe(
                Rectangle((x - bw / 2, y - bh / 2), (bw, bh)), gt))
    return best


def _fixture_ious(model, ds, mode: str, score_threshold: float = 0.5) -> list:
    """Best-box IoU of every frame of ``ds`` rendered through the mode's
    inference transform, the frames in one batch of detection."""
    from mav_detection_tpu_torch.models.yolo import Boxes, boxes_to_host, detect_boxes
    from mav_detection_tpu_torch.pipeline.mode_imagery import mode_image_host

    dev = model.head.weight.device
    imgs = []
    for i in range(ds.N):
        frame = ds.get_frame(i)
        if mode != "APPEARANCE_RGB":
            j = min(i, ds.N - 2)
            frame = mode_image_host(frame, np.asarray(ds.flows[j], np.float32), mode,
                                    seed=i, device=dev)
        imgs.append(frame)
    boxes = boxes_to_host(detect_boxes(model, np.stack(imgs),
                                       score_threshold=score_threshold))
    return [_best_iou(Boxes(*(a[i] for a in boxes)), ds.get_annotation(i)[0])
            for i in range(ds.N)]


def yolo_batch_loss(model, sc, mode: str, dtype: torch.dtype = torch.bfloat16,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The TinyYOLO trainer's loss of one batch: each scene's mode imagery
    (``mode_image_device``; FLOW_FOE_YOLO draws from ``generator``), then
    the mean single-target loss at the scenes' boxes."""
    from mav_detection_tpu_torch.models.yolo import yolo_loss
    from mav_detection_tpu_torch.pipeline.mode_imagery import mode_image_device

    imgs = torch.stack([mode_image_device(sc.img1[i], sc.flow[i], mode, generator=generator)
                        for i in range(sc.img1.shape[0])])
    return yolo_loss(model, imgs, sc.box, dtype=dtype).mean()


def train_yolo(steps: int = 2500, batch: int = 8, hw: Tuple[int, int] = (240, 320),
               peak_lr: float = 1e-3, chunk: int = 100, seed: int = 0,
               mode: str = "APPEARANCE_RGB",
               init_params: Optional[Dict[str, torch.Tensor]] = None,
               use_selector: bool = True, device: Device = "cuda",
               draws: Optional[DrawsFn] = None, save_best_to: str = "",
               dtype: torch.dtype = torch.bfloat16):
    """Train TinyYOLO on the mode's imagery of generated scenes (rendered on
    the device by ``mode_image_device`` inside the step) -> (model, losses);
    selection scores two host fixtures through the inference transform and
    keeps the worse of their mean IoUs."""
    from mav_detection_tpu_torch.convert import flax_from_yolo_state_dict
    from mav_detection_tpu_torch.models.optim import TrainOptimizer, train_schedule
    from mav_detection_tpu_torch.models.yolo import create_yolo

    dev = resolve_device(device)
    h, w = hw
    model = create_yolo(torch.Generator().manual_seed(seed))
    if init_params is not None:
        model.load_state_dict(init_params)
    model = model.to(dev)
    opt = TrainOptimizer(model.parameters(), train_schedule(peak_lr, steps, 100))
    draw = _draws_fn(draws, batch, h, w, 0.0, seed, dev)
    mode_gen = torch.Generator(device=dev).manual_seed(seed + 2)

    def loss_of(step: int) -> torch.Tensor:
        return yolo_batch_loss(model, generate_batch(batch, h, w, draws=draw(step),
                                                     device=dev), mode, dtype, mode_gen)

    sel_fixtures = [
        _selection_fixture(seed=781, n_frames=6, drone_radius=8,
                           drone_start=(250.0, 170.0), drone_velocity=(-5.0, -2.0)),
        _selection_fixture(seed=787, n_frames=6, drone_radius=12,
                           drone_start=(70.0, 60.0), drone_velocity=(4.5, 2.5)),
    ] if use_selector else []

    def selector(m) -> float:
        return min(float(np.mean(_fixture_ious(m, ds, mode))) for ds in sel_fixtures)

    run_chunk = _make_run_chunk(lambda s: _step(opt, lambda: loss_of(s)))
    return _scan_chunks(run_chunk, model, opt, 0, steps, chunk, f"yolo[{mode}]",
                        selector=selector if use_selector else None,
                        save_best_to=save_best_to, to_tree=flax_from_yolo_state_dict)


def eval_yolo(model, n_frames: int = 12, score_threshold: float = 0.5,
              mode: str = "APPEARANCE_RGB") -> Tuple[float, float]:
    """(mean IoU of the best box against the annotation, detection rate) on
    the held-out fixture (seed 779) in the mode's imagery."""
    ds = _selection_fixture(seed=779, n_frames=n_frames, drone_radius=11,
                            drone_start=(240.0, 70.0), drone_velocity=(-4.0, 3.0))
    ious = _fixture_ious(model, ds, mode, score_threshold)
    return float(np.mean(ious)), sum(v > 0.25 for v in ious) / n_frames


# --------------------------------------------------------------------- cli
def _save(name: str, tree: Any) -> str:
    from mav_detection_tpu_torch.models import checkpoint, pretrained

    path = pretrained.checkpoint_path(name)
    checkpoint.save_msgpack(path, tree)
    logger.info(f"wrote {path}")
    return path


def main(argv=None) -> None:
    from mav_detection_tpu_torch import convert
    from mav_detection_tpu_torch.models import pretrained

    parser = argparse.ArgumentParser(description="train the learned models")
    parser.add_argument("--model", choices=["raft", "sky", "yolo", "all"], default="all")
    parser.add_argument("--steps", type=int, default=0,
                        help="override the per-model default step count")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--chunk", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--hw", type=str, default="",
                        help="HxW training resolution override, e.g. 240x320")
    parser.add_argument("--drone-weight", type=float, default=40.0,
                        help="loss upweight inside the (dilated) drone mask")
    parser.add_argument("--lr", type=float, default=0.0,
                        help="override peak LR (e.g. lower it when resuming)")
    parser.add_argument("--yolo-mode", default="APPEARANCE_RGB",
                        choices=["APPEARANCE_RGB", "FLOW_UV", "FLOW_RADIAL",
                                 "FLOW_FOE_YOLO"],
                        help="detection mode whose imagery TinyYOLO trains on; the "
                        "checkpoint is written as yolo_<mode>.msgpack")
    parser.add_argument("--devices", type=int, default=0,
                        help="data-parallel RAFT training over N devices (one "
                             "process each; gloo ranks with --device cpu)")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--resume", action="store_true",
                        help="initialize RAFT from the existing checkpoint")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or 'cpu'")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    wanted = ["raft", "sky", "yolo"] if args.model == "all" else [args.model]
    kw: Dict[str, Any] = {}
    if args.hw:
        h, w = args.hw.lower().split("x")
        kw["hw"] = (int(h), int(w))
    if args.lr:
        kw["peak_lr"] = args.lr
    if "raft" in wanted and not args.eval_only:
        _check_devices(args.devices, args.batch, args.device)
    dev = resolve_device(args.device)

    if "raft" in wanted:
        if args.eval_only:
            model = pretrained.load_raft(dev)
            if model is None:
                raise FileNotFoundError(f"no RAFT checkpoint at {pretrained.checkpoint_path('raft')}")
        else:
            init = pretrained.load_raft_params() if args.resume else None
            model, _ = train_raft(steps=args.steps or 4000, batch=args.batch,
                                  chunk=args.chunk, seed=args.seed, init_params=init,
                                  drone_weight=args.drone_weight,
                                  save_best_to=pretrained.checkpoint_path("raft"),
                                  devices=args.devices, device=dev, **kw)
            _save("raft", convert.flax_from_raft_state_dict(model.state_dict()))
        epe, depe = eval_raft(model)
        logger.info(f"[raft] held-out fixture EPE: {epe:.4f} px (gate < 0.5), "
                    f"drone-region EPE {depe:.4f} px")
        rtpr, gtpr = eval_raft_detection(model)
        logger.info(f"[raft] detection TPR (fixed threshold): RAFT flow {rtpr:.4f} "
                    f"vs GT flow {gtpr:.4f} (gate: within 0.05)")

    if "sky" in wanted:
        if args.eval_only:
            model = pretrained.load_sky(dev)
            if model is None:
                raise FileNotFoundError(f"no sky checkpoint at {pretrained.checkpoint_path('sky')}")
        else:
            model, _ = train_sky(steps=args.steps or 1500, batch=args.batch,
                                 chunk=args.chunk, seed=args.seed, device=dev, **kw)
            _save("sky", convert.flax_from_sky_state_dict(model.state_dict()))
        tpr, fpr, ptpr, pfpr = eval_sky(model)
        logger.info(f"[sky] net TPR {tpr:.4f} FPR {fpr:.4f} | "
                    f"precomputed TPR {ptpr:.4f} FPR {pfpr:.4f}")

    if "yolo" in wanted:
        mode = args.yolo_mode
        name = pretrained.yolo_checkpoint_name(mode)
        if args.eval_only:
            model = pretrained.load_yolo(mode, dev)
            if model is None:
                raise FileNotFoundError(f"no yolo checkpoint at {pretrained.checkpoint_path(name)}")
        else:
            model, _ = train_yolo(steps=args.steps or 2500, batch=args.batch,
                                  chunk=args.chunk, seed=args.seed, mode=mode,
                                  device=dev, **kw)
            _save(name, convert.flax_from_yolo_state_dict(model.state_dict()))
        iou, rate = eval_yolo(model, mode=mode)
        logger.info(f"[yolo:{mode}] held-out mean IoU {iou:.3f}, detection rate {rate:.2f}")


if __name__ == "__main__":
    main()
