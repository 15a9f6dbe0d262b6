"""The frame engines: host IO around the device detection steps
(``mav_detection_tpu.pipeline.processor.Processor`` on the batch and scan
engines).

FoE branch (``run_detection_foe``): frames are staged in host batches on a
background thread, flow and the fused detection step run the whole batch on
the card, and only a packed (B, 12) block of per-frame scalars comes back;
FrameResult JSON goes to ``results/image_%05d.json`` when the dataset has a
sequence directory. With ``save_images`` (the default) the full detection
step runs instead and the per-frame debug images (``result-images/``,
``derotated/``, ``phi/``, ``processed/`` overlays) are written, from one
device-to-host copy per image kind per batch, then ``video.npz`` (and
``processed.mp4`` where ``ffmpeg`` is on the path).

Homography branch (``run_detection_homography``): flow in device batches;
per frame a homography fit on 1000 sampled correspondences (or sparse LK
tracks with ``use_sparse_of``), the global-motion residual, k-means on its
magnitude, the pyramid window search and the window hill climb, all on the
card; the box comes back, and with a sequence directory the 2x3 mosaic's
images.

Scan engine (``run_detection_foe_scan``, ``--engine scan``): the whole
sequence goes up in one pinned upload, ``detect_sequence_scan`` runs the
Farneback solver and the detection step per transition with carried state
and no look from the host, and one packed (T-1, 12) block comes back; with
``use_sparse_of`` also the trace-based sparse FoE, saved as
``results/foe_sparse.npy``. No debug images in this mode.

Ported: flow sources FARNEBACK, PRECOMPUTED (with its FARNEBACK fallback),
LUCAS_KANADE, GROUND_TRUTH and RAFT (batch engine; ``models/raft.py``
through its resolution-keyed entry points, with the coverage ladder decided
on a padded tail's real lanes only); staging with pinned-memory uploads of
B+1 unique frames per full batch (gray, or for RAFT the frames as they
come); ``.flo`` files through the native in-order prefetcher (numpy where
its library cannot be built, said once in the log); static-shape tail
padding; one scalar pull per batch.

Conversions: ``annotations_to_yolo`` (``--data-to-yolo``), ``convert``
(``--prepare-dataset``: mode imagery through ``pipeline/mode_imagery.py``)
and ``undistort`` (the ``UNDISTORT_PATH`` passthrough).

Multi-device engines (``devices > 1``; one process per device,
``parallel/mesh.py``): without a process group the Processor spawns its
ranks at run time (NCCL on the cards, gloo with ``device="cpu"``) and hands
back rank 0's FrameResults; under a group that exists already it runs as
its rank. The batch engine shards every batch's lanes: each rank stages
and uploads its own lanes on its own thread, runs flow and detection on
them, the fixed-threshold TPR/FPR of the batch is one all-reduce of four
counts (padded lanes masked out), and rank 0 gathers the packed scalars
into FrameResults and JSON. ``--engine spatial`` row-shards each pair's
Farneback solve (``parallel/spatial.py``) and then detects as the batch
engine does; ``--engine chunked`` splits the sequence into time chunks
(``detect_video_chunked``). Not ported: the ``cv2.VideoWriter`` mp4
fallback (the port has no OpenCV).
"""
from __future__ import annotations

import glob
import logging
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass, fields
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mav_detection_tpu_torch.core.config import Algorithm, FlowSource, Mode, RunConfig
from mav_detection_tpu_torch.core.flo import read_flow_batch
from mav_detection_tpu_torch.core.frame_result import FrameResult
from mav_detection_tpu_torch.core.rectangle import Rectangle
from mav_detection_tpu_torch.data.dataset import (
    create_if_not_exists,
    imread,
    imwrite,
)
from mav_detection_tpu_torch.models.raft import (
    raft_flow_batch_tuned,
    raft_flow_video_tuned,
)
from mav_detection_tpu_torch.ops.flow.farneback import (
    _farneback_cf,
    tuned_flow_params,
)
from mav_detection_tpu_torch.ops.geometry.foe import sample_points
from mav_detection_tpu_torch.ops.flow.lucas_kanade import (
    lk_dense_flow,
    lucas_kanade_track,
    shi_tomasi_corners,
)
from mav_detection_tpu_torch.ops.geometry.boxsearch import (
    analyze_pyramid,
    optimize_window,
)
from mav_detection_tpu_torch.ops.geometry.global_motion import (
    homography_motion_field,
    subtract_global_motion,
)
from mav_detection_tpu_torch.ops.geometry.kmeans import cluster_image
from mav_detection_tpu_torch.ops.geometry.ransac_fits import fit_homography_lstsq
from mav_detection_tpu_torch.ops.image.color import bgr_to_gray_host
from mav_detection_tpu_torch.ops.image.visualize import (
    apply_colormap,
    flow_to_color,
    to_rgb,
)
from mav_detection_tpu_torch.pipeline.detector import (
    DetectionStep,
    _to_scalars,
    detect_frame_batch,
    detect_frame_batch_scalars,
    pack_frame_scalars,
)
from mav_detection_tpu_torch.parallel import mesh as pmesh
from mav_detection_tpu_torch.parallel.spatial import farneback_flow_spatial
from mav_detection_tpu_torch.pipeline.temporal import (
    SCAN_SEED,
    detect_sequence_scan,
    detect_video_chunked,
)
from mav_detection_tpu_torch.runtime import native_loader
from mav_detection_tpu_torch.utils.device import resolve_device
from mav_detection_tpu_torch.utils.tracing import Tracer

# seed of the per-run generators (FoE samples, k-means initial centers)
SAMPLE_SEED = 0
# the homography branch samples its correspondences this far from the edges
HOMOGRAPHY_BORDER = 20
HOMOGRAPHY_SAMPLES = 1000


def _pull_debug_images(out, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The first ``n`` lanes' fixed-threshold masks, phi maps and derotated
    flow of a detection step's outputs, on the host: one pull per kind."""
    return (out.estimate_fixed[:n].cpu().numpy(), out.phi[:n].cpu().numpy(),
            out.flow_derotated[:n].cpu().numpy())


def _edge_pad_batch(arr, pad: int):
    """Repeat the trailing element ``pad`` times along axis 0 (tail-batch
    padding: the extra lanes are real, finite inputs — last frame against
    itself — so every downstream op stays NaN-free; their results are never
    read back)."""
    return pmesh.pad_to(arr, arr.shape[0] + pad)


# Processor settings a spawned rank takes from the caller's Processor
_RANK_ATTRS = ("save_images", "batch_size", "_farneback")


@dataclass
class _RankJob:
    """What a spawned rank needs to run a Processor method as the caller's."""
    config: RunConfig
    dataset: Any
    attrs: Dict[str, Any]
    method: str
    kwargs: Dict[str, Any]


def _portable_config(config: RunConfig) -> RunConfig:
    """A copy of ``config`` from its fields alone (no per-instance
    attributes, no results), which pickles into a spawned rank."""
    return RunConfig(**{f.name: getattr(config, f.name) for f in fields(config)
                        if f.name != "results"})


def _processor_rank(mesh: pmesh.Mesh, job: _RankJob):
    """A spawned rank: a Processor on this rank's device and the job's
    dataset runs the job's method; rank 0 returns its FrameResults and
    all-reduced metrics."""
    proc = Processor(job.config, device=mesh.device, mesh=mesh,
                     dataset=job.dataset)
    proc._spawned = True
    for key, value in job.attrs.items():
        setattr(proc, key, value)
    try:
        results = getattr(proc, job.method)(**job.kwargs)
    finally:
        proc._close_flo_prefetcher()
    return (results, proc._psum_metrics) if mesh.rank == 0 else None


class Processor:
    """Detection runner (FoE and homography branches; batch and scan
    engines)."""

    def __init__(self, config: RunConfig,
                 device: Union[str, torch.device] = "cuda",
                 mesh: Optional[pmesh.Mesh] = None,
                 dataset=None) -> None:
        """``mesh``: run as that rank of a process group (a spawned rank, or
        a caller under a group of its own); ``dataset``: use it in place of
        ``config.get_dataset``."""
        self.device = resolve_device(device)
        self.config = config
        self.logger = config.logger or logging.getLogger("mav_detection_tpu_torch")
        self.batch_size = max(1, config.batch_size)
        # frame-batch data parallelism: the mesh of a process group, or the
        # number of ranks to spawn at run time when there is no group
        self.mesh = mesh
        self._ranks = 0
        self._spawned = False
        self._psum_metrics: List[tuple] = []
        if mesh is None and config.devices and config.devices > 1:
            avail = pmesh.available_devices(self.device)
            if avail < config.devices:
                self.logger.warning(
                    f"--devices {config.devices} requested but only {avail} "
                    f"available; running unsharded")
            elif torch.distributed.is_available() and torch.distributed.is_initialized():
                self.mesh = pmesh.make_mesh(config.devices, self.device)
            else:
                self._ranks = config.devices
        if self.mesh is not None:
            self.device = self.mesh.device
        n_shards = self.mesh.size if self.mesh is not None else self._ranks
        if n_shards:
            # each rank needs at least one frame of every batch
            self.batch_size = max(self.batch_size, n_shards)
        if config.engine == "spatial" and not n_shards:
            raise ValueError("--engine spatial row-shards each frame's flow "
                             "solve over the mesh; it requires --devices > 1")
        if (config.engine == "spatial"
                and config.flow_source not in (FlowSource.FARNEBACK,)):
            raise ValueError(
                f"--engine spatial shards the Farneback solver; "
                f"--flow-source {config.flow_source.name} is not supported "
                "there — use the batch engine")
        # the SkyUNet of frames without a precomputed sky mask runs here too,
        # and a SimDataset's GT flow is synthesised here
        self.dataset = (config.get_dataset(device=self.device) if dataset is None
                        else dataset)
        self.dataset.device = self.device   # also for a dataset made elsewhere
        self.detection_results: Dict[int, FrameResult] = {}
        self._stage_host_seconds = 0.0
        self._flo_prefetcher: Optional[native_loader.FloPrefetcher] = None
        self.is_exiting = False
        # the reference's product flow configuration, keyed by frame size
        w, h = (int(v) for v in self.dataset.resolution)
        self._farneback = tuned_flow_params(h, w)
        self.tracer = Tracer()
        # write per-frame debug images (result/derotated/phi/overlay); JSON
        # results are always written. Disable for throughput runs.
        self.save_images = True
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    # ------------------------------------------------------------ helpers
    def _detection_step(self) -> DetectionStep:
        return DetectionStep(foe_samples=self.config.foe_samples)

    def _effective_flow_source(self) -> FlowSource:
        src = self.config.flow_source
        if src == FlowSource.PRECOMPUTED and not self.dataset.has_precomputed_flow():
            self.logger.info("no precomputed flow found; using on-device Farneback")
            src = FlowSource.FARNEBACK
        return src

    @staticmethod
    def _gray(img) -> np.ndarray:
        # host-side BT.601, kept uint8: 4x less host->device traffic
        return bgr_to_gray_host(img, np.uint8)

    def _flow_frame(self, src: FlowSource, i: int) -> np.ndarray:
        """Frame ``i`` as the flow source takes it: RAFT the frame as it
        comes (BGR uint8, as its checkpoint was trained), the others gray."""
        img = self.dataset.get_frame(i)
        return np.asarray(img) if src == FlowSource.RAFT else self._gray(img)

    def _upload(self, arr: np.ndarray):
        """Pinned host copy + asynchronous upload on the copy stream; the
        consumer waits on the returned event before use."""
        host = torch.from_numpy(arr).pin_memory()
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return dev, event, host

    def _await_upload(self, upload) -> torch.Tensor:
        """The tensor of an ``_upload``, once the main stream waits for its
        copy."""
        tensor, event, _host = upload
        main = torch.cuda.current_stream(self.device)
        main.wait_event(event)
        tensor.record_stream(main)
        return tensor

    def _stage_batch(self, idx: List[int], src: FlowSource,
                     lanes: Optional[int] = None) -> Dict[str, object]:
        """Host staging of one frame batch (gray conversion, .flo reads, aux
        arrays) for flow source ``src``. Runs on a background thread so it
        overlaps the card computing the previous batch. ``lanes``: the
        lanes of a full batch (``batch_size`` by default; a rank's share of
        it on a mesh)."""
        t0 = time.time()
        ds = self.dataset
        h, w = ds.capture_shape[:2]
        staged: Dict[str, object] = {}
        if src in (FlowSource.PRECOMPUTED, FlowSource.GROUND_TRUTH):
            if self._flo_prefetcher is not None:
                # reads run ahead on the prefetcher's native threads across
                # batch boundaries (this one staging thread consumes the
                # batches strictly in order)
                staged["flow_host"] = np.stack(
                    [next(self._flo_prefetcher) for _ in idx])
            else:
                staged["flow_host"] = self._read_flow(idx, src)
        elif idx == list(range(idx[0], idx[0] + len(idx))):
            # contiguous transitions stage B+1 UNIQUE frames (video is a
            # chain); the device slices prevs/currs out of one upload (RAFT
            # encodes each of them once)
            g = np.stack([self._flow_frame(src, i)
                          for i in range(idx[0], idx[-1] + 2)])
            if self._copy_stream is not None and len(idx) == (lanes or self.batch_size):
                # full batches upload HERE, overlapping the previous batch;
                # tail batches stay host-side for the padding step
                staged["frames_dev"] = self._upload(g)
            else:
                staged["frames"] = g
        else:
            staged["prevs"] = np.stack([self._flow_frame(src, i) for i in idx])
            staged["currs"] = np.stack([self._flow_frame(src, i + 1) for i in idx])

        gts = [ds.get_gt_of(i) for i in idx]
        if any(g is not None for g in gts):
            staged["gt_flow"] = np.stack([
                np.asarray(g, np.float32) if g is not None
                else np.zeros((h, w, 2), np.float32) for g in gts])
        staged["omegas"] = np.stack([
            np.asarray(ds.get_angular_difference(i, i + 1), np.float64)
            / max(ds.get_delta_time(i + 1), 1e-9)
            for i in idx]).astype(np.float32)
        staged["dts"] = np.array([ds.get_delta_time(i + 1) for i in idx],
                                 np.float32)
        staged["segs"] = np.stack([
            np.asarray(ds.get_segmentation(i))[..., 0] for i in idx])
        staged["skys"] = np.stack([
            np.asarray(ds.get_sky_segmentation(i)) for i in idx])
        staged["depths"] = np.stack([
            np.asarray(ds.get_depth(i), np.float32)
            if ds.get_depth(i) is not None else np.ones((h, w), np.float32)
            for i in idx])
        staged["gt_foes"] = np.stack([
            np.asarray(ds.get_gt_foe(i), np.float32)
            if ds.get_gt_foe(i) is not None else np.full(2, np.nan, np.float32)
            for i in idx])
        self._stage_host_seconds += time.time() - t0
        return staged

    def _flo_paths(self, idx: Sequence[int], src: FlowSource) -> List[str]:
        """The ``.flo`` files of a file-backed source for pairs ``idx``, or
        [] where the dataset keeps its flow in memory or a file is missing."""
        ds = self.dataset
        precomputed = src == FlowSource.PRECOMPUTED
        # in-memory datasets have no .flo directories
        if not getattr(ds, "flow_path" if precomputed else "gt_of_path", None):
            return []
        path_of = ds.get_flow_path if precomputed else ds.get_gt_of_path
        paths = [path_of(i) for i in idx]
        return paths if all(paths) else []

    def _close_flo_prefetcher(self) -> None:
        if self._flo_prefetcher is not None:
            self._flo_prefetcher.close()
            self._flo_prefetcher = None

    def _open_flo_prefetcher(self, n_pairs: int, src: FlowSource,
                             pairs: Optional[Sequence[int]] = None) -> None:
        """Arm the native bounded in-order ``.flo`` prefetcher for a
        file-backed flow source: its threads read ahead of the staging
        thread across batch boundaries. Without files on disk, or where the
        native library cannot be built (``native_loader.available`` says so
        in the log), the batches are read by ``_read_flow``."""
        # a prior run that stopped mid-sequence: release its reader threads
        # before re-arming
        self._close_flo_prefetcher()
        if src not in (FlowSource.PRECOMPUTED, FlowSource.GROUND_TRUTH):
            return
        paths = self._flo_paths(range(n_pairs) if pairs is None else pairs, src)
        if paths and native_loader.available():
            self._flo_prefetcher = native_loader.FloPrefetcher(
                paths, depth=max(2 * self.batch_size, 4), n_threads=2)

    def _read_flow(self, idx: List[int], src: FlowSource) -> np.ndarray:
        """Host flow (n, h, w, 2) of a file-backed source: the measured
        ``.flo`` files (PRECOMPUTED) or the ground-truth ones."""
        ds = self.dataset
        precomputed = src == FlowSource.PRECOMPUTED
        paths = self._flo_paths(idx, src)
        if paths:
            return read_flow_batch(paths)
        getter = ds.get_flow_uv if precomputed else ds.get_gt_of
        return np.stack([np.asarray(getter(i), np.float32) for i in idx])

    def _to_dev(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr).to(self.device)

    def _flow_pairs(self, prevs: torch.Tensor, currs: torch.Tensor,
                    src: FlowSource, n_real: Optional[int] = None
                    ) -> torch.Tensor:
        """Device flow (n, h, w, 2) from frame pairs (gray; RAFT: as they
        come). LUCAS_KANADE runs frame by frame; of a padded tail it computes
        only the first ``n_real`` lanes and repeats the last (padded lanes
        are never read); RAFT decides its coverage ladder on those lanes."""
        if src == FlowSource.FARNEBACK:
            return _farneback_cf(prevs, currs, self._farneback)
        if src == FlowSource.RAFT:
            return raft_flow_batch_tuned(prevs, currs, device=self.device,
                                         n_real=n_real, mesh=self.mesh)
        n = prevs.shape[0]
        n_real = n if n_real is None else n_real
        flows = torch.stack([
            lk_dense_flow(prevs[j].to(torch.float32), currs[j].to(torch.float32))
            for j in range(n_real)])
        return _edge_pad_batch(flows, n - n_real)

    def _staged_frames(self, staged: Dict[str, object]) -> Optional[torch.Tensor]:
        """The device frames of a staged chain of contiguous pairs, or None
        where the pairs were staged apart."""
        if "frames_dev" in staged:
            return self._await_upload(staged["frames_dev"])
        if "frames" in staged:
            return self._to_dev(staged["frames"])
        return None

    def _flow_from_staged(self, staged: Dict[str, object], src: FlowSource,
                          n_real: Optional[int] = None) -> torch.Tensor:
        """Device flow (n, h, w, 2) for a staged batch of flow source
        ``src``, of which the first ``n_real`` lanes are real frames."""
        if "flow_host" in staged:
            return self._to_dev(staged["flow_host"])
        frames = self._staged_frames(staged)
        if frames is None:
            return self._flow_pairs(self._to_dev(staged["prevs"]),
                                    self._to_dev(staged["currs"]), src, n_real)
        if src == FlowSource.RAFT:
            # the chain's shared encoding: each frame through fnet once
            return raft_flow_video_tuned(frames, device=self.device, n_real=n_real,
                                         mesh=self.mesh)
        return self._flow_pairs(frames[:-1], frames[1:], src, n_real)

    def _flow_batch(self, indices: List[int]) -> torch.Tensor:
        """Device flow (n, h, w, 2) for frame pairs (i, i+1), unstaged (the
        homography branch's source of flow)."""
        src = self._effective_flow_source()
        if src in (FlowSource.PRECOMPUTED, FlowSource.GROUND_TRUTH):
            return self._to_dev(self._read_flow(indices, src))
        prevs = np.stack([self._flow_frame(src, i) for i in indices])
        currs = np.stack([self._flow_frame(src, i + 1) for i in indices])
        return self._flow_pairs(self._to_dev(prevs), self._to_dev(currs), src)

    # ------------------------------------------------------------- detect
    def run_detection(self) -> Dict[int, FrameResult]:
        if self.config.algorithm == Algorithm.HOMOGRAPHY:
            return self.run_detection_homography()
        return self.run_detection_foe()

    def run_detection_homography(self, kmeans_init: Optional[Sequence] = None
                                 ) -> Dict[int, FrameResult]:
        """Homography-branch detection: fit the transform on sampled flow,
        synthesize + subtract global motion, cluster the residual magnitude,
        box-search the brightest window, and report IoU against the
        ground-truth annotation (as ``tpr``). Flow computes in device
        batches; the fit/cluster/box stages run per frame, on the card.

        ``kmeans_init``: optional initial k-means centers, one (attempts, k)
        array of pixel indices per frame pair, in place of the draw from the
        run's generator (seeded with ``SAMPLE_SEED``)."""
        ds = self.dataset
        rng = np.random.default_rng(0)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(SAMPLE_SEED)

        out_dir = os.path.join(ds.seq_path, "processed") if ds.seq_path else ""
        if out_dir:
            create_if_not_exists(out_dir)
            create_if_not_exists(ds.results_path)

        for b0 in range(0, ds.N - 1, self.batch_size):
            batch_idx = list(range(b0, min(b0 + self.batch_size, ds.N - 1)))
            with self.tracer.stage("flow"):
                flows = self._flow_batch(batch_idx)
            self._homography_frame_batch(batch_idx, flows, rng, gen,
                                         kmeans_init, out_dir)
        self.logger.info("stage timing:\n" + self.tracer.summary())
        return self.detection_results

    def _sparse_correspondences(self, i: int, p0: torch.Tensor,
                                p1: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sparse-LK transform-fit correspondences (the ``use_sparse_of``
        flag): Shi-Tomasi corners on frame ``i`` tracked to ``i+1``. Slots
        whose track fails keep the grid-flow correspondence passed in (both
        are true correspondences, so the least-squares fit stays sound and
        every shape stays static); when no track survives that is all of
        them, upstream's fallback to the sampled coordinates."""
        ds = self.dataset
        g0 = self._to_dev(self._gray(ds.get_frame(i))).to(torch.float32)
        g1 = self._to_dev(self._gray(ds.get_frame(i + 1))).to(torch.float32)
        corners = shi_tomasi_corners(g0, max_corners=p0.shape[0],
                                     quality_level=0.01)
        tracks = lucas_kanade_track(g0, g1, corners.points)
        ok = (corners.valid & tracks.status)[:, None]
        if self.logger.isEnabledFor(logging.DEBUG):
            self.logger.debug(f"features: {int(ok.sum())}")
        return (torch.where(ok, corners.points, p0),
                torch.where(ok, tracks.points, p1))

    def _homography_frame_batch(self, batch_idx: List[int], flows: torch.Tensor,
                                rng: np.random.Generator,
                                gen: torch.Generator,
                                kmeans_init: Optional[Sequence],
                                out_dir: str) -> None:
        ds = self.dataset
        h, w = ds.capture_shape[:2]
        border = HOMOGRAPHY_BORDER
        boxes, gms, residuals, quants = [], [], [], []
        for j, i in enumerate(batch_idx):
            flow = flows[j]
            with self.tracer.stage("fit"):
                # the same numpy draw as the reference's, gathered on the card
                sy = rng.integers(border, h - border, HOMOGRAPHY_SAMPLES)
                sx = rng.integers(border, w - border, HOMOGRAPHY_SAMPLES)
                p0 = self._to_dev(np.stack([sx, sy], 1).astype(np.float32))
                p1 = p0 + flow[self._to_dev(sy), self._to_dev(sx)]
                if self.config.use_sparse_of:
                    p0, p1 = self._sparse_correspondences(i, p0, p1)
                H = fit_homography_lstsq(p0, p1)
                gm = homography_motion_field(H, h, w)
                residual, mag = subtract_global_motion(flow, gm)
            with self.tracer.stage("cluster"):
                init = (None if kmeans_init is None
                        else self._to_dev(np.asarray(kmeans_init[i])))
                quant, mask = cluster_image(mag, init, generator=gen)
            with self.tracer.stage("boxsearch"):
                res = analyze_pyramid(quant.to(torch.float32))
                _, box = optimize_window(
                    torch.where(mask, mag, torch.zeros_like(mag)), res.box_xywh)
            boxes.append(box)
            if out_dir:
                gms.append(gm)
                residuals.append(residual)
                quants.append(quant)

        # one device->host copy per kind for the whole batch
        with self.tracer.stage("materialize"):
            boxes_h = torch.stack(boxes).cpu().numpy()
            if out_dir:
                flows_h = flows.cpu().numpy()
                gms_h = torch.stack(gms).cpu().numpy()
                residuals_h = torch.stack(residuals).cpu().numpy()
                quants_h = torch.stack(quants).cpu().numpy()

        with self.tracer.stage("artifacts"):
            for j, i in enumerate(batch_idx):
                bx = boxes_h[j]
                rect = Rectangle((float(bx[0]), float(bx[1])),
                                 (float(bx[2]), float(bx[3])))
                gts = ds.get_annotation(i)
                iou = max((Rectangle.calculate_iou_safe(rect, gt) for gt in gts),
                          default=0.0)
                fr = FrameResult(time=float(ds.get_time(i)), tpr=float(iou))
                self.detection_results[i] = fr
                self.config.results[i] = fr
                if not out_dir:
                    continue
                with open(os.path.join(ds.results_path,
                                       f"image_{i:05d}.json"), "w") as f:
                    f.write(fr.to_json())
                # 2x3 debug mosaic:
                # top = frame+box | global motion | residual
                # bottom = flow vis | global motion | cluster vis
                frame = np.asarray(ds.get_frame(i))[..., :3].copy()
                tl = rect.get_topleft_int()
                br = rect.get_bottomright_int()
                frame[max(tl[1], 0):br[1], max(tl[0], 0):tl[0] + 2] = (0, 255, 0)
                frame[max(tl[1], 0):br[1], br[0] - 2:br[0]] = (0, 255, 0)
                frame[max(tl[1], 0):tl[1] + 2, max(tl[0], 0):br[0]] = (0, 255, 0)
                frame[br[1] - 2:br[1], max(tl[0], 0):br[0]] = (0, 255, 0)
                gm_vis = flow_to_color(gms_h[j])
                quant = quants_h[j].astype(np.float32)
                cluster_vis = to_rgb(255.0 * quant / max(float(quant.max()), 1e-6))
                top = np.hstack([frame, gm_vis, flow_to_color(residuals_h[j])])
                bottom = np.hstack([flow_to_color(flows_h[j]), gm_vis, cluster_vis])
                imwrite(os.path.join(out_dir, f"image_{i:05d}.png"),
                        np.vstack([top, bottom]))

    def _frame_result(self, i: int, row: np.ndarray, gt_foe) -> FrameResult:
        """The FrameResult of pair ``i`` from its row of packed scalars
        (``pack_frame_scalars``'s columns)."""
        return FrameResult(
            time=float(self.dataset.get_time(i)),
            tpr=float(row[2]), fpr=float(row[3]),
            tpr_fixed=float(row[4]), fpr_fixed=float(row[5]),
            sky_tpr=float(row[6]), sky_fpr=float(row[7]),
            drone_size_pixels=float(row[8]),
            drone_flow_pixels=(float(row[9]), float(row[10])),
            foe_dense=(float(row[0]), float(row[1])),
            foe_gt=tuple(float(v) for v in gt_foe),
            center_phi=float(row[11]),
        )

    def _sequence_inputs(self) -> Dict[str, np.ndarray]:
        """Frame-indexed host inputs of the scan engine: element t describes
        transition (t-1, t), with the aux arrays of the pair's FIRST frame
        (the batch engine's (i, i+1) convention at t = i + 1); element 0 is
        filler."""
        ds = self.dataset
        T = ds.N
        h, w = ds.capture_shape[:2]
        inputs = {
            "frames": np.stack([self._gray(ds.get_frame(i)) for i in range(T)]),
            "omegas": np.zeros((T, 3), np.float32),
            "dts": np.ones((T,), np.float32),
            "segs": np.zeros((T, h, w), np.uint8),
            "skys": np.zeros((T, h, w), bool),
            "depths": np.ones((T, h, w), np.float32),
            "gt_foes": np.zeros((T, 2), np.float32),
        }
        for t in range(1, T):
            i = t - 1
            dt = float(ds.get_delta_time(i + 1)) or 1.0
            inputs["omegas"][t] = np.asarray(
                ds.get_angular_difference(i, i + 1), np.float32) / dt
            inputs["dts"][t] = dt
            seg = np.asarray(ds.get_segmentation(i))
            inputs["segs"][t] = seg[..., 0] if seg.ndim == 3 else seg
            inputs["skys"][t] = np.asarray(ds.get_sky_segmentation(i), bool)
            # a dataset without depths (MIDGARD, VisDrone, the experiment
            # recordings) keeps the ones plane, as both batch engines do; the
            # reference's scan engine stores a NaN plane there, which makes
            # its sky_tpr / sky_fpr NaN (a divergence by design)
            depth = ds.get_depth(i)
            if depth is not None:
                inputs["depths"][t] = np.asarray(depth, np.float32)
            gt_foe = ds.get_gt_foe(i)
            inputs["gt_foes"][t] = (np.asarray(gt_foe, np.float32)
                                    if gt_foe is not None else np.nan)
        return inputs

    def run_detection_foe_scan(self, sample_yx=None, sparse_perm=None
                               ) -> Dict[int, FrameResult]:
        """Temporal frame engine (``--engine scan``): one pinned upload of
        the sequence, ``detect_sequence_scan`` over its transitions (the
        Farneback solver with the processor's flow parameters, then the
        fused detection step, with the flow history carried), one pull of
        the packed (T-1, 12) scalars. FrameResult JSON keeps the batch
        engine's schema; no debug images are produced in this mode. Flow is
        always computed on the device, so file and net flow sources cannot
        ride this engine.

        ``sample_yx`` (T-1, 2N, 2) and, with ``use_sparse_of``,
        ``sparse_perm`` (T-1, 256): the explicit draws of
        ``detect_sequence_scan``, in place of its seeded generator."""
        engine = self.config.engine
        src = self.config.flow_source
        if src in (FlowSource.RAFT, FlowSource.LUCAS_KANADE):
            raise ValueError(
                f"--engine {engine} computes Farneback flow inside the scan "
                f"body; --flow-source {src.name} is not supported there: use "
                "the batch engine")
        if src != FlowSource.FARNEBACK:
            self.logger.warning(
                f"--engine {engine}: flow-source {src.name} ignored: the scan "
                "engine computes Farneback flow on device")
        if engine == "chunked":
            if self.mesh is None:
                raise ValueError("--engine chunked requires --devices > 1")
            return self._run_chunked(sample_yx)

        ds = self.dataset
        T = ds.N
        with self.tracer.stage("stage"):
            inputs = self._sequence_inputs()
            if self._copy_stream is not None:
                # every copy is enqueued before the first is waited for; the
                # pinned buffers live in ``uploads`` until the run returns
                uploads = {k: self._upload(v) for k, v in inputs.items()}
                dev_in = {k: self._await_upload(u) for k, u in uploads.items()}
            else:
                dev_in = {k: torch.from_numpy(v) for k, v in inputs.items()}
            if sample_yx is not None:
                sample_yx = self._to_dev(np.asarray(sample_yx))
            if sparse_perm is not None:
                sparse_perm = self._to_dev(np.asarray(sparse_perm))

        with self.tracer.stage("scan"):
            out = detect_sequence_scan(
                dev_in["frames"], dev_in["omegas"], dev_in["dts"],
                dev_in["segs"], dev_in["skys"], dev_in["depths"],
                dev_in["gt_foes"], sample_yx=sample_yx,
                params=self._farneback, config=self._detection_step(),
                track_sparse=self.config.use_sparse_of,
                sparse_perm=sparse_perm)

        with self.tracer.stage("materialize"):
            packed = pack_frame_scalars(out[0]).cpu().numpy()
            foe_sparse = (out[2].cpu().numpy() if self.config.use_sparse_of
                          else None)

        with self.tracer.stage("artifacts"):
            results_dir = ds.results_path if ds.seq_path else ""
            if results_dir:
                create_if_not_exists(results_dir)
            if foe_sparse is not None:
                # FrameResult has no sparse-FoE field: the JSON schema stays
                # and the trace-based FoE goes into a sidecar
                if results_dir:
                    np.save(os.path.join(results_dir, "foe_sparse.npy"),
                            foe_sparse)
                self.logger.info(f"sparse FoE (LK traces): median "
                                 f"{np.nanmedian(foe_sparse, axis=0)}")
            self._scan_results(packed, inputs["gt_foes"], T, results_dir)
        self.logger.info("stage timing:\n" + self.tracer.summary())
        return self.detection_results

    def _scan_results(self, packed: np.ndarray, gt_foes: np.ndarray, T: int,
                      results_dir: str) -> None:
        """FrameResults (and JSON) of transitions 1..T-1 from their packed
        scalars: transition (t-1, t) is result t-1."""
        self._record_results(range(T - 1), packed, gt_foes[1:T], results_dir)

    def _run_chunked(self, sample_yx=None) -> Dict[int, FrameResult]:
        """``--engine chunked`` as this rank of the mesh: the sequence padded
        to a multiple of the mesh size by repeating its last frame, each
        rank's time chunk through ``detect_video_chunked`` (only that chunk
        goes to its device), the scalars gathered; rank 0 writes the
        FrameResults. Without explicit draws every rank draws the scan
        engine's, so chunked equals scan on the same sequence."""
        if self.config.use_sparse_of:
            self.logger.warning(
                "--use-sparse-of ignored with --engine chunked: LK trace "
                "state spans chunk boundaries and cannot ride the "
                "one-frame halo — use --engine scan")
        ds = self.dataset
        T = ds.N
        h, w = ds.capture_shape[:2]
        T_pad = -(-T // self.mesh.size) * self.mesh.size
        step = self._detection_step()
        with self.tracer.stage("stage"):
            inputs = self._sequence_inputs()
            padded = {k: pmesh.pad_to(v, T_pad) for k, v in inputs.items()}
            if sample_yx is None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(SCAN_SEED)
                sample_yx = sample_points(T - 1, step.foe_samples, h, w, gen,
                                          self.device)
            if not isinstance(sample_yx, torch.Tensor):
                sample_yx = torch.from_numpy(np.asarray(sample_yx))
            sample_yx = pmesh.pad_to(sample_yx, T_pad - 1)
        with self.tracer.stage("scan"):
            out = detect_video_chunked(
                self.mesh, padded["frames"], padded["omegas"], padded["dts"],
                padded["segs"], padded["skys"], padded["depths"],
                padded["gt_foes"], sample_yx=sample_yx, params=self._farneback,
                config=step)
        if self.mesh.rank == 0:
            with self.tracer.stage("materialize"):
                packed = pack_frame_scalars(out)[:T - 1].cpu().numpy()
            with self.tracer.stage("artifacts"):
                results_dir = ds.results_path if ds.seq_path else ""
                if results_dir:
                    create_if_not_exists(results_dir)
                self._scan_results(packed, inputs["gt_foes"], T, results_dir)
            self.logger.info("stage timing:\n" + self.tracer.summary())
        return self.detection_results

    def run_detection_foe(self, sample_yx: Optional[Sequence] = None
                          ) -> Dict[int, FrameResult]:
        """Run the FoE detection loop over the dataset.

        ``sample_yx``: optional per-batch FoE sample indices, one
        (B_padded, 2N, 2) (y, x) array per batch, in place of the draw from
        the run's generator (seeded once per run with ``SAMPLE_SEED``). On
        the scan and chunked engines: one (T-1, 2N, 2) array for the whole
        sequence. With ``devices > 1`` and no process group, the batch,
        spatial and chunked engines run on spawned ranks (rank 0's
        FrameResults come back)."""
        if self._ranks and self.config.engine != "scan":
            return self._run_on_ranks("run_detection_foe", sample_yx=sample_yx)
        if self.config.engine in ("scan", "chunked"):
            return self.run_detection_foe_scan(sample_yx=sample_yx)
        if self.mesh is not None:
            return self._run_detection_foe_sharded(sample_yx)
        ds = self.dataset
        n_pairs = ds.N - 1
        h, w = ds.capture_shape[:2]
        out_dirs = self._foe_out_dirs()
        save_images = bool(out_dirs) and self.save_images
        gen = torch.Generator(device=self.device)
        gen.manual_seed(SAMPLE_SEED)
        step = self._detection_step()
        src = self._effective_flow_source()

        t_start = time.time()
        self._stage_host_seconds = 0.0
        self._open_flo_prefetcher(n_pairs, src)
        batches = [list(range(b0, min(b0 + self.batch_size, n_pairs)))
                   for b0 in range(0, n_pairs, self.batch_size)]
        with self._staged_batches(batches, src) as staged_batches:
            for k, (idx, staged) in enumerate(zip(batches, staged_batches)):
                if self.is_exiting:
                    break
                nb = len(idx)
                # static-shape tail: pad the remainder batch to batch_size
                if 0 < nb < self.batch_size:
                    pad_b = self.batch_size - nb
                    staged = {key: _edge_pad_batch(v, pad_b)
                              for key, v in staged.items()}
                    nb = self.batch_size

                with self.tracer.stage("flow"):
                    flow = self._flow_from_staged(staged, src, len(idx))
                with self.tracer.stage("stage+detect"):
                    if "gt_flow" in staged:
                        gt_flow = self._to_dev(staged["gt_flow"])
                    else:
                        gt_flow = torch.zeros((nb, h, w, 2), device=self.device)
                    syx = (None if sample_yx is None
                           else self._to_dev(np.asarray(sample_yx[k])))
                    # the debug images need the full outputs (masks, phi map,
                    # derotated flow); throughput runs keep the scalars only
                    detect_fn = (detect_frame_batch if save_images
                                 else detect_frame_batch_scalars)
                    out = detect_fn(
                        flow, gt_flow, self._to_dev(staged["omegas"]),
                        self._to_dev(staged["dts"]),
                        self._to_dev(staged["segs"]),
                        self._to_dev(staged["skys"]),
                        self._to_dev(staged["depths"]),
                        self._to_dev(staged["gt_foes"]),
                        sample_yx=syx, generator=gen, config=step)

                # one device->host transfer of the scalars for the whole
                # batch and, with debug images on, one per image kind; padded
                # lanes' images stay on the card
                with self.tracer.stage("materialize"):
                    if save_images:
                        images = _pull_debug_images(out, len(idx))
                        out = _to_scalars(out)
                    packed = pack_frame_scalars(out).cpu().numpy()

                with self.tracer.stage("artifacts"):
                    self._record_results(idx, packed, staged["gt_foes"],
                                         out_dirs.get("results", ""))
                    if save_images:
                        self._write_batch_images(out_dirs, idx, images)
                self._log_progress(idx[-1] + 1, n_pairs, t_start)
        self._finish_foe_loop(out_dirs, time.time() - t_start,
                              "— overlapped with device compute on a background thread")
        return self.detection_results

    def _foe_out_dirs(self) -> Dict[str, str]:
        """The FoE loop's output directories, created; none without a
        sequence directory."""
        ds = self.dataset
        if not ds.seq_path:
            return {}
        out_dirs = {
            "results": ds.results_path,
            "result_imgs": os.path.join(ds.seq_path, "result-images"),
            "derotated": os.path.join(ds.seq_path, "derotated"),
            "phi": os.path.join(ds.seq_path, "phi"),
            "processed": os.path.join(ds.seq_path, "processed"),
        }
        for d in out_dirs.values():
            create_if_not_exists(d)
        return out_dirs

    @contextmanager
    def _staged_batches(self, staged_idx: List[List[int]], src: FlowSource,
                        lanes: Optional[int] = None
                        ) -> Iterator[Iterator[Dict[str, object]]]:
        """An iterator over the staged arrays of each batch of pairs in
        ``staged_idx``, in order, with double buffering: batch k+1 stages
        on a background thread while the caller computes batch k. On
        leaving the context (also on a break or an error) neither the
        stager thread nor the prefetcher's reader threads outlive it."""
        executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="stager",
                                      initializer=self._bind_device)

        def staged_batches():
            future = (executor.submit(self._stage_batch, staged_idx[0], src, lanes)
                      if staged_idx else None)
            for k in range(len(staged_idx)):
                staged = future.result()
                if k + 1 < len(staged_idx):
                    future = executor.submit(self._stage_batch, staged_idx[k + 1],
                                             src, lanes)
                yield staged

        try:
            yield staged_batches()
        finally:
            executor.shutdown(wait=True, cancel_futures=True)
            self._close_flo_prefetcher()

    def _record_results(self, idx: Sequence[int], packed: np.ndarray, gt_foes,
                        results_dir: str) -> None:
        """The FrameResults of pairs ``idx`` from their rows of packed
        scalars, and their JSON into ``results_dir`` when given."""
        for j, i in enumerate(idx):
            fr = self._frame_result(i, packed[j], gt_foes[j])
            self.detection_results[i] = fr
            self.config.results[i] = fr
            if results_dir:
                with open(os.path.join(results_dir, f"image_{i:05d}.json"), "w") as f:
                    f.write(fr.to_json())

    def _write_batch_images(self, out_dirs: Dict[str, str], idx: Sequence[int],
                            images: Tuple[np.ndarray, ...]) -> None:
        """The debug PNGs of pairs ``idx`` from ``_pull_debug_images``'s
        arrays."""
        for j, i in enumerate(idx):
            self._write_debug_images(out_dirs, f"image_{i:05d}",
                                     np.asarray(self.dataset.get_frame(i)),
                                     *(a[j] for a in images))

    def _log_progress(self, done: int, n_pairs: int, t_start: float) -> None:
        """About every tenth of the sequence: the share done and frames/s."""
        if done % max(n_pairs // 10, 1) < self.batch_size:
            self.logger.info(
                f"{done / n_pairs * 100:.1f}% {done}/{n_pairs} "
                f"({done / max(time.time() - t_start, 1e-9):.1f} fps)")

    def _finish_foe_loop(self, out_dirs: Dict[str, str], wall: float,
                         note: str) -> None:
        """The FoE loop's tail: the host-staging log line, the video of the
        overlay PNGs, the stage timing."""
        if wall > 0:
            self.logger.info(
                f"host staging {self._stage_host_seconds:.2f}s over "
                f"{wall:.2f}s wall ({100 * self._stage_host_seconds / wall:.0f}% "
                f"{note})")
        if out_dirs:
            with self.tracer.stage("encode"):
                self._encode_video(out_dirs["processed"],
                                   os.path.join(self.dataset.seq_path, "processed.mp4"))
        self.logger.info("stage timing:\n" + self.tracer.summary())

    # ------------------------------------------------------- multi-device
    def _bind_device(self) -> None:
        """Make this thread's current device the Processor's (a staging
        thread of a rank on ``cuda:r`` would otherwise start on card 0; a
        bare ``cuda`` is the current card already)."""
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)

    def _pairs_of(self, staged: Dict[str, object]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device (prevs, currs) of a staged gray batch."""
        frames = self._staged_frames(staged)
        if frames is None:
            return self._to_dev(staged["prevs"]), self._to_dev(staged["currs"])
        return frames[:-1], frames[1:]

    def _flow_spatial_pairs(self, prevs: torch.Tensor, currs: torch.Tensor
                            ) -> torch.Tensor:
        """``--engine spatial``: each pair's Farneback solve row-sharded over
        the mesh (``parallel/spatial.py``), its flow on every rank. A frame
        height that does not divide by the mesh size takes the unsharded
        batched solver: edge-padding rows would move the 5-px border
        down-weight ramp off the true bottom edge and change near-border
        flow."""
        n_dev = self.mesh.size
        h = prevs.shape[1]
        if h % n_dev:
            self.logger.warning(
                f"--engine spatial: frame height {h} does not divide by the "
                f"{n_dev}-device mesh — using the unsharded batched solver")
            return _farneback_cf(prevs, currs, self._farneback)
        return torch.stack([
            farneback_flow_spatial(prevs[j], currs[j], self._farneback, self.mesh)
            for j in range(prevs.shape[0])])

    def _log_psum(self, n_devices: int) -> None:
        wsum = sum(n for _, _, n in self._psum_metrics)
        tpr_g = sum(t * n for t, _, n in self._psum_metrics) / wsum
        fpr_g = sum(f * n for _, f, n in self._psum_metrics) / wsum
        self.logger.info(
            f"on-mesh psum metrics ({n_devices} devices): "
            f"fixed-threshold TPR {tpr_g:.4f} FPR {fpr_g:.6f}")

    def _run_on_ranks(self, method: str, **kwargs) -> Dict[int, FrameResult]:
        """Run ``method`` on ``devices`` spawned ranks with this Processor's
        dataset and settings, and take rank 0's FrameResults and all-reduced
        metrics as this Processor's."""
        job = _RankJob(config=_portable_config(self.config), dataset=self.dataset,
                       attrs={k: getattr(self, k) for k in _RANK_ATTRS},
                       method=method, kwargs=kwargs)
        results, psum = pmesh.launch(_processor_rank, self._ranks, self.device, job)
        for i, fr in results.items():
            self.detection_results[i] = fr
            self.config.results[i] = fr
        self._psum_metrics.extend(psum)
        if psum:
            self._log_psum(self._ranks)
        return self.detection_results

    def _run_detection_foe_sharded(self, sample_yx: Optional[Sequence] = None
                                   ) -> Dict[int, FrameResult]:
        """The FoE loop as this rank of the mesh (batch and spatial engines).

        A batch of ``batch_size`` lanes is padded to ``per * size`` lanes by
        repeating its last one, and rank ``r`` takes lanes ``[r*per,
        (r+1)*per)``. On the batch engine each rank stages and uploads only
        its lanes, on its own thread, and computes their flow; on the
        spatial engine every rank stages the whole batch and the ranks solve
        each pair's flow together. Each rank draws the whole batch's FoE
        samples from the run's generator and takes its lanes' (lane ``i``
        votes on the unsharded run's samples of lane ``i``), runs the
        detection step, and joins one all-reduce of the fixed-threshold
        counts (padded lanes masked out) and one all-gather of the packed
        (per, 12) scalars; rank 0 pulls both at once and writes the
        FrameResults and JSON. Debug images are written by the rank that
        computed them."""
        mesh = self.mesh
        ds = self.dataset
        n_pairs = ds.N - 1
        h, w = ds.capture_shape[:2]
        lead = mesh.rank == 0
        spatial = self.config.engine == "spatial"
        out_dirs = self._foe_out_dirs()
        save_images = bool(out_dirs) and self.save_images
        gen = torch.Generator(device=self.device)
        gen.manual_seed(SAMPLE_SEED)
        step = self._detection_step()
        src = self._effective_flow_source()
        B = self.batch_size
        lo, hi, per = pmesh.lanes(B, mesh)
        padded_b = per * mesh.size

        def mine(idx: List[int]) -> List[int]:
            # this rank's real pairs; a rank with none stages the batch's
            # last pair, whose lanes are then all padding
            return idx[lo:min(hi, len(idx))] or [idx[-1]]

        t_start = time.time()
        self._stage_host_seconds = 0.0
        batches = [list(range(b0, min(b0 + B, n_pairs)))
                   for b0 in range(0, n_pairs, B)]
        staged_idx = [idx if spatial else mine(idx) for idx in batches]
        self._open_flo_prefetcher(n_pairs, src,
                                  [i for idx in staged_idx for i in idx])
        with self._staged_batches(staged_idx, src,
                                  B if spatial else per) as staged_batches:
            for k, (idx, staged) in enumerate(zip(batches, staged_batches)):
                if self.is_exiting:
                    break
                nb = len(idx)
                n_valid = max(0, min(hi, nb) - lo)

                with self.tracer.stage("flow"):
                    if spatial:
                        prevs, currs = self._pairs_of(staged)
                        flow = pmesh.pad_to(self._flow_spatial_pairs(prevs, currs),
                                            padded_b)[lo:hi]
                        staged = {key: pmesh.pad_to(v, padded_b)[lo:hi]
                                  for key, v in staged.items()
                                  if key not in ("frames_dev", "frames", "prevs",
                                                 "currs")}
                    else:
                        n_mine = len(staged_idx[k])
                        if n_mine < per:
                            staged = {key: _edge_pad_batch(v, per - n_mine)
                                      for key, v in staged.items()}
                        # RAFT decides its coverage ladder on the real lanes
                        # of the whole batch; the others compute their lanes
                        flow = self._flow_from_staged(
                            staged, src, n_valid if src == FlowSource.RAFT else n_mine)
                with self.tracer.stage("stage+detect"):
                    if "gt_flow" in staged:
                        gt_flow = self._to_dev(staged["gt_flow"])
                    else:
                        gt_flow = torch.zeros((per, h, w, 2), device=self.device)
                    syx = (sample_points(B, step.foe_samples, h, w, gen, self.device)
                           if sample_yx is None
                           else self._to_dev(np.asarray(sample_yx[k])))
                    segs = self._to_dev(staged["segs"])
                    out = detect_frame_batch(
                        flow, gt_flow, self._to_dev(staged["omegas"]),
                        self._to_dev(staged["dts"]), segs,
                        self._to_dev(staged["skys"]),
                        self._to_dev(staged["depths"]),
                        self._to_dev(staged["gt_foes"]),
                        sample_yx=pmesh.pad_to(syx, padded_b)[lo:hi], config=step)
                    valid = torch.arange(lo, hi, device=self.device) < nb
                    g_tpr, g_fpr = pmesh.aggregate_metrics_psum(
                        mesh, segs, (255 * out.estimate_fixed.to(torch.int32)
                                     ).to(torch.uint8), valid)
                    gathered = pmesh.all_gather_cat(
                        pack_frame_scalars(_to_scalars(out)), mesh)

                with self.tracer.stage("materialize"):
                    if lead:
                        host = torch.cat([gathered.reshape(-1), g_tpr.reshape(1),
                                          g_fpr.reshape(1)]).cpu().numpy()
                        packed = host[:-2].reshape(padded_b, 12)
                        self._psum_metrics.append((float(host[-2]), float(host[-1]),
                                                   nb))
                    if save_images and n_valid:
                        images = _pull_debug_images(out, n_valid)

                with self.tracer.stage("artifacts"):
                    if save_images and n_valid:
                        self._write_batch_images(out_dirs, idx[lo:lo + n_valid], images)
                    if lead:
                        gt_foes = [ds.get_gt_foe(i) for i in idx]
                        self._record_results(
                            idx, packed, [np.full(2, np.nan, np.float32) if g is None
                                          else np.asarray(g, np.float32) for g in gt_foes],
                            out_dirs.get("results", ""))
                if lead:
                    self._log_progress(idx[-1] + 1, n_pairs, t_start)
        wall = time.time() - t_start
        # the video is encoded once every rank has written its images
        torch.distributed.barrier(group=mesh.group)
        if lead:
            if self._psum_metrics and not self._spawned:
                self._log_psum(mesh.size)
            self._finish_foe_loop(out_dirs, wall, "on rank 0")
        return self.detection_results

    @staticmethod
    def _write_debug_images(out_dirs: Dict[str, str], name: str,
                            frame: np.ndarray, fixed_mask: np.ndarray,
                            phi_map: np.ndarray, derot: np.ndarray) -> None:
        """One frame's four debug PNGs."""
        imwrite(os.path.join(out_dirs["result_imgs"], name + ".png"),
                to_rgb(255.0 * fixed_mask))
        imwrite(os.path.join(out_dirs["derotated"], name + ".png"),
                flow_to_color(derot))
        imwrite(os.path.join(out_dirs["phi"], name + ".png"),
                apply_colormap(phi_map.astype(np.float32)))
        # overlay like upstream's mask_vis (alpha blend)
        frame = frame.astype(np.float32)
        overlay = frame.copy()
        overlay[fixed_mask.astype(bool)] = (150, 0, 150)
        vis = 0.2 * frame + 0.8 * overlay
        imwrite(os.path.join(out_dirs["processed"], name + ".png"),
                np.clip(vis, 0, 255).astype(np.uint8))

    def _encode_video(self, img_dir: str, out_path: str, fps: int = 30) -> None:
        """png sequence -> the codec-free ``video.npz`` sidecar, plus
        ``processed.mp4`` through ``ffmpeg`` when it is on the path. The
        reference's second encoder, ``cv2.VideoWriter``, is not ported (the
        port has no OpenCV): without ffmpeg the mp4 is skipped, with a log
        line, as the reference does when it finds no codec."""
        if not glob.glob(os.path.join(img_dir, "image_*.png")):
            return
        self._encode_npz(img_dir,
                         os.path.join(os.path.dirname(out_path), "video.npz"))
        if shutil.which("ffmpeg") is None:
            self.logger.warning("video encode skipped: no ffmpeg on the path")
            return
        cmd = ["ffmpeg", "-y", "-loglevel", "error", "-framerate",
               str(fps), "-i", os.path.join(img_dir, "image_%05d.png"),
               "-c:v", "libx264", "-pix_fmt", "yuv420p", out_path]
        # check the exit code: an ffmpeg without libx264 exits non-zero
        if subprocess.run(cmd).returncode != 0:
            self.logger.warning("video encode failed: ffmpeg exited non-zero")

    # Above this many bytes of raw frames, skip the npz sidecar rather than
    # exhausting host memory after the detection work is done (a 1920x1024
    # x 2000-frame run is ~12 GB raw). Override via env.
    NPZ_MAX_BYTES = int(os.environ.get("MAVTPU_NPZ_MAX_BYTES", 4 << 30))

    def _encode_npz(self, img_dir: str, out_path: str) -> None:
        """png sequence -> single ``video.npz`` (key ``frames``, (n, h, w, 3)
        uint8 BGR)."""
        pngs = sorted(glob.glob(os.path.join(img_dir, "image_*.png")))

        def read_bgr(path: str) -> np.ndarray:
            img = imread(path)
            return np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img

        first = read_bgr(pngs[0])
        total = first.nbytes * len(pngs)
        if total > self.NPZ_MAX_BYTES:
            self.logger.warning(
                f"npz encode skipped: {total / 2**30:.1f} GiB of frames "
                f"exceeds MAVTPU_NPZ_MAX_BYTES "
                f"({self.NPZ_MAX_BYTES / 2**30:.1f} GiB)")
            return
        # preallocate so peak host memory is one copy of the stack. A bad
        # frame aborts the WHOLE artifact: box/annotation consumers key by
        # position, so silently dropping a middle frame would off-by-one
        # every frame after it.
        frames = np.empty((len(pngs),) + first.shape, first.dtype)
        for n, p in enumerate(pngs):
            f = first if n == 0 else read_bgr(p)
            if f.shape != first.shape:
                self.logger.warning(
                    f"npz encode skipped: bad frame {p} (positional box "
                    "protocol forbids dropping frames)")
                return
            frames[n] = f
        np.savez_compressed(out_path, frames=frames)

    # ----------------------------------------------- dataset conversion
    def annotation_to_yolo(self, rects) -> str:
        return "".join(r.to_yolo(self.dataset.resolution) for r in rects)

    def annotations_to_yolo(self) -> None:
        """MIDGARD csv -> YOLO txt annotations of every configured
        sequence (``--data-to-yolo``)."""
        midgard = os.environ["MIDGARD_PATH"]
        for sequence in self.config.get_all_sequences():
            ann_dir = f"{midgard}/{sequence}/annotation"
            self.logger.info(f"converting annotations: {sequence}")
            for old in glob.glob(f"{ann_dir}/*.txt"):
                os.remove(old)
            for src in sorted(glob.glob(f"{ann_dir}/*.csv")):
                dst = src.replace("annot_", "image_").replace("csv", "txt")
                rows = np.atleast_2d(np.genfromtxt(src, delimiter=","))
                lines = []
                for row in rows:
                    if row.size < 5 or not np.isfinite(row[1:5]).all():
                        continue
                    # MIDGARD csv: frame, x, y, w, h in pixels
                    rect = Rectangle((row[1], row[2]), (row[3], row[4]))
                    lines.append(rect.to_yolo(self.dataset.resolution))
                with open(dst, "w") as f:
                    f.writelines(lines)

    def convert(self, mode: Mode) -> None:
        """YOLO training-set export (``--prepare-dataset``): per train
        sequence, the mode imagery of each frame (``mode_image_host``, the
        Validator's inference transform) and a copy of its annotation, under
        ``$YOLOv4_PATH/dataset``. The flow comes from the sequence being
        exported: the dataset is re-created per sequence."""
        from mav_detection_tpu_torch.data import make_dataset
        from mav_detection_tpu_torch.pipeline.mode_imagery import mode_image_host

        dest = os.environ["YOLOv4_PATH"] + "/dataset"
        img_dest = f"{dest}/images"
        ann_dest = f"{dest}/labels/yolo"
        for d in (img_dest, ann_dest):
            create_if_not_exists(d)
            for name in os.listdir(d):
                p = os.path.join(d, name)
                shutil.rmtree(p) if os.path.isdir(p) else os.unlink(p)

        out_idx = 0
        orig_dataset = self.dataset
        try:
            for sequence in self.config.settings.get("train_sequences", []):
                self.logger.info(f"preparing sequence {sequence}")
                base = os.environ["MIDGARD_PATH"]
                imgs = sorted(glob.glob(f"{base}/{sequence}/images/image_*.png"))
                anns = sorted(glob.glob(f"{base}/{sequence}/annotation/*.txt"))
                if len(imgs) != len(anns):
                    raise ValueError(
                        f"input sizes do not match: {len(imgs)} images, "
                        f"{len(anns)} annotations")
                self.dataset = make_dataset(self.config.get_dataset_type(),
                                            self.config.logger, sequence,
                                            device=self.device)
                for i, (img_src, ann_src) in enumerate(zip(imgs, anns)):
                    if mode != Mode.APPEARANCE_RGB and i >= len(imgs) - 2:
                        continue  # last frames have no flow pair
                    dst_img = f"{img_dest}/{out_idx:06d}.png"
                    if mode == Mode.APPEARANCE_RGB:
                        shutil.copy2(img_src, dst_img)
                    else:
                        flow = self._flow_batch([i])[0].cpu().numpy()
                        frame = np.asarray(self.dataset.get_frame(i))
                        imwrite(dst_img, mode_image_host(frame, flow, mode.name,
                                                         seed=i, device=self.device))
                    shutil.copy2(ann_src, f"{ann_dest}/{out_idx:06d}.txt")
                    out_idx += 1
        finally:
            self.dataset = orig_dataset

    def undistort(self) -> None:
        """External undistortion tool passthrough (``--undistort``,
        ``UNDISTORT_PATH``)."""
        exe = os.environ.get("UNDISTORT_PATH")
        if not exe:
            self.logger.warning("UNDISTORT_PATH not set; skipping undistort")
            return
        base = os.environ["MIDGARD_PATH"]
        for sequence in self.config.get_all_sequences():
            cal = glob.glob(f"{base}/{sequence}/info/calibration/*.txt")
            if not cal:
                continue
            out_dir = f"{base}/{sequence}/undistorted"
            create_if_not_exists(out_dir)
            for img in sorted(glob.glob(f"{base}/{sequence}/images/image_*.png")):
                out = f"{out_dir}/{os.path.basename(img)}"
                if os.path.exists(out):
                    continue
                with open(os.devnull, "w") as devnull:
                    subprocess.call([exe, "--run", cal[0], img, out], stdout=devnull)

    def release(self) -> None:
        self._close_flo_prefetcher()
        self.dataset.release()
