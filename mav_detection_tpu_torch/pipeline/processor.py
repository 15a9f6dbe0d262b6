"""The frame engine: host IO around the fused device detection step
(``mav_detection_tpu.pipeline.processor.Processor.run_detection_foe`` on the
batch engine).

Frames are staged in host batches on a background thread, flow and the
fused detection step run the whole batch on the card, and only a packed
(B, 12) block of per-frame scalars comes back; FrameResult JSON goes to
``results/image_%05d.json`` when the dataset has a sequence directory.

Ported: flow sources FARNEBACK and PRECOMPUTED (with its FARNEBACK
fallback), staging with pinned-memory uploads of B+1 unique gray frames per
full batch, static-shape tail padding, one scalar pull per batch. Not ported
yet, each raising rather than skipping: debug images (``save_images``, need
``ops/image/visualize.py``), the scan/chunked/spatial engines, multi-device
meshes, the homography branch, and the LK/RAFT/GT flow sources.
"""
from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from mav_detection_tpu_torch.core.config import Algorithm, FlowSource, RunConfig
from mav_detection_tpu_torch.core.flo import read_flow_batch
from mav_detection_tpu_torch.core.frame_result import FrameResult
from mav_detection_tpu_torch.data.dataset import create_if_not_exists
from mav_detection_tpu_torch.ops.flow.farneback import (
    _farneback_cf,
    tuned_flow_params,
)
from mav_detection_tpu_torch.ops.image.color import bgr_to_gray_host
from mav_detection_tpu_torch.pipeline.detector import (
    DetectionStep,
    detect_frame_batch_scalars,
    pack_frame_scalars,
)
from mav_detection_tpu_torch.utils.device import resolve_device
from mav_detection_tpu_torch.utils.tracing import Tracer

# seed of the per-run FoE sample generator
SAMPLE_SEED = 0


def _edge_pad_batch(arr, pad: int):
    """Repeat the trailing element ``pad`` times along axis 0 (tail-batch
    padding: the extra lanes are real, finite inputs — last frame against
    itself — so every downstream op stays NaN-free; their results are never
    read back)."""
    if pad <= 0:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr[-1:].expand((pad,) + arr.shape[1:])])
    return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)


class Processor:
    """Detection runner (FoE branch, batch engine)."""

    def __init__(self, config: RunConfig,
                 device: Union[str, torch.device] = "cuda") -> None:
        self.device = resolve_device(device)
        self.config = config
        self.logger = config.logger or logging.getLogger("mav_detection_tpu_torch")
        if config.engine != "batch":
            raise NotImplementedError(
                f"--engine {config.engine} is not ported yet "
                "(pipeline/temporal.py, parallel/spatial.py); use batch")
        if config.devices and config.devices > 1:
            raise NotImplementedError(
                "multi-device frame batches (parallel/mesh.py) are not "
                "ported yet; use one device")
        self.dataset = config.get_dataset()
        self.batch_size = max(1, config.batch_size)
        self.detection_results: Dict[int, FrameResult] = {}
        self._stage_host_seconds = 0.0
        self.is_exiting = False
        # the reference's product flow configuration, keyed by frame size
        w, h = (int(v) for v in self.dataset.resolution)
        self._farneback = tuned_flow_params(h, w)
        self.tracer = Tracer()
        # per-frame debug images need ops/image/visualize.py (not ported);
        # JSON results are always written
        self.save_images = False
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
        if src not in (FlowSource.PRECOMPUTED, FlowSource.FARNEBACK):
            raise NotImplementedError(
                f"--flow-source {src.name} is not ported yet; use FARNEBACK "
                "or PRECOMPUTED")
        return src

    @staticmethod
    def _gray(img) -> np.ndarray:
        # host-side BT.601, kept uint8: 4x less host->device traffic
        return bgr_to_gray_host(img, np.uint8)

    def _upload(self, arr: np.ndarray):
        """Pinned host copy + asynchronous upload on the copy stream; the
        consumer waits on the returned event before use."""
        host = torch.from_numpy(arr).pin_memory()
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return dev, event, host

    def _stage_batch(self, idx: List[int], src: FlowSource) -> Dict[str, object]:
        """Host staging of one frame batch (gray conversion, .flo reads, aux
        arrays) for flow source ``src``. Runs on a background thread so it
        overlaps the card computing the previous batch."""
        t0 = time.time()
        ds = self.dataset
        h, w = ds.capture_shape[:2]
        staged: Dict[str, object] = {}
        if src == FlowSource.PRECOMPUTED:
            # in-memory datasets have no .flo directory
            paths = ([ds.get_flow_path(i) for i in idx]
                     if getattr(ds, "flow_path", None) else [])
            if paths and all(paths):
                staged["flow_host"] = read_flow_batch(paths)
            else:
                staged["flow_host"] = np.stack(
                    [np.asarray(ds.get_flow_uv(i), np.float32) for i in idx])
        elif idx == list(range(idx[0], idx[0] + len(idx))):
            # contiguous transitions stage B+1 UNIQUE gray frames (video is
            # a chain); the device slices prevs/currs out of one upload
            g = np.stack([self._gray(ds.get_frame(i))
                          for i in range(idx[0], idx[-1] + 2)])
            if self._copy_stream is not None and len(idx) == self.batch_size:
                # full batches upload HERE, overlapping the previous batch;
                # tail batches stay host-side for the padding step
                staged["grays_dev"] = self._upload(g)
            else:
                staged["grays"] = g
        else:
            staged["prevs"] = np.stack([self._gray(ds.get_frame(i)) for i in idx])
            staged["currs"] = np.stack([self._gray(ds.get_frame(i + 1)) for i in idx])

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

    def _to_dev(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr).to(self.device)

    def _flow_from_staged(self, staged: Dict[str, object]) -> torch.Tensor:
        """Device flow (n, h, w, 2) for a staged batch."""
        if "flow_host" in staged:
            return self._to_dev(staged["flow_host"])
        if "grays_dev" in staged:
            grays, event, _host = staged["grays_dev"]
            main = torch.cuda.current_stream(self.device)
            main.wait_event(event)
            grays.record_stream(main)
        elif "grays" in staged:
            grays = self._to_dev(staged["grays"])
        else:
            prevs = self._to_dev(staged["prevs"])
            currs = self._to_dev(staged["currs"])
            return _farneback_cf(prevs, currs, self._farneback)
        return _farneback_cf(grays[:-1], grays[1:], self._farneback)

    # ------------------------------------------------------------- detect
    def run_detection(self) -> Dict[int, FrameResult]:
        if self.config.algorithm == Algorithm.HOMOGRAPHY:
            raise NotImplementedError(
                "the homography branch is not ported yet; the FoE branch "
                "runs for every other --algorithm")
        return self.run_detection_foe()

    def run_detection_foe(self, sample_yx: Optional[Sequence] = None
                          ) -> Dict[int, FrameResult]:
        """Run the FoE detection loop over the dataset.

        ``sample_yx``: optional per-batch FoE sample indices, one
        (B_padded, 2N, 2) (y, x) array per batch, in place of the draw from
        the run's generator (seeded once per run with ``SAMPLE_SEED``)."""
        ds = self.dataset
        n_pairs = ds.N - 1
        h, w = ds.capture_shape[:2]
        save_images = bool(ds.seq_path) and self.save_images
        if save_images:
            raise NotImplementedError(
                "save_images needs ops/image/visualize.py, which is not "
                "ported yet; set save_images = False")
        results_dir = ds.results_path if ds.seq_path else ""
        if results_dir:
            create_if_not_exists(results_dir)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(SAMPLE_SEED)
        step = self._detection_step()
        src = self._effective_flow_source()

        t_start = time.time()
        self._stage_host_seconds = 0.0
        batches = [list(range(b0, min(b0 + self.batch_size, n_pairs)))
                   for b0 in range(0, n_pairs, self.batch_size)]
        # double buffering: batch k+1 stages on a background thread while
        # the card computes batch k
        executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="stager")
        try:
            future = (executor.submit(self._stage_batch, batches[0], src)
                      if batches else None)
            for k, idx in enumerate(batches):
                if self.is_exiting:
                    break
                nb = len(idx)
                staged = future.result()
                if k + 1 < len(batches):
                    future = executor.submit(self._stage_batch, batches[k + 1],
                                             src)

                # static-shape tail: pad the remainder batch to batch_size
                if 0 < nb < self.batch_size:
                    pad_b = self.batch_size - nb
                    staged = {key: _edge_pad_batch(v, pad_b)
                              for key, v in staged.items()}
                    nb = self.batch_size

                with self.tracer.stage("flow"):
                    flow = self._flow_from_staged(staged)
                with self.tracer.stage("stage+detect"):
                    if "gt_flow" in staged:
                        gt_flow = self._to_dev(staged["gt_flow"])
                    else:
                        gt_flow = torch.zeros((nb, h, w, 2), device=self.device)
                    syx = (None if sample_yx is None
                           else self._to_dev(np.asarray(sample_yx[k])))
                    out = detect_frame_batch_scalars(
                        flow, gt_flow, self._to_dev(staged["omegas"]),
                        self._to_dev(staged["dts"]),
                        self._to_dev(staged["segs"]),
                        self._to_dev(staged["skys"]),
                        self._to_dev(staged["depths"]),
                        self._to_dev(staged["gt_foes"]),
                        sample_yx=syx, generator=gen, config=step)

                # one device->host transfer for the whole batch
                with self.tracer.stage("materialize"):
                    packed = pack_frame_scalars(out).cpu().numpy()

                with self.tracer.stage("artifacts"):
                    gt_foes = staged["gt_foes"]
                    for j, i in enumerate(idx):
                        row = packed[j]
                        fr = FrameResult(
                            time=float(ds.get_time(i)),
                            tpr=float(row[2]), fpr=float(row[3]),
                            tpr_fixed=float(row[4]), fpr_fixed=float(row[5]),
                            sky_tpr=float(row[6]), sky_fpr=float(row[7]),
                            drone_size_pixels=float(row[8]),
                            drone_flow_pixels=(float(row[9]), float(row[10])),
                            foe_dense=(float(row[0]), float(row[1])),
                            foe_gt=tuple(float(v) for v in gt_foes[j]),
                            center_phi=float(row[11]),
                        )
                        self.detection_results[i] = fr
                        self.config.results[i] = fr
                        if results_dir:
                            with open(os.path.join(results_dir,
                                                   f"image_{i:05d}.json"), "w") as f:
                                f.write(fr.to_json())
                done = idx[-1] + 1
                if done % max(n_pairs // 10, 1) < self.batch_size:
                    self.logger.info(
                        f"{done / n_pairs * 100:.1f}% {done}/{n_pairs} "
                        f"({done / max(time.time() - t_start, 1e-9):.1f} fps)")
        finally:
            executor.shutdown(wait=True, cancel_futures=True)
        wall = time.time() - t_start
        if wall > 0:
            self.logger.info(
                f"host staging {self._stage_host_seconds:.2f}s over "
                f"{wall:.2f}s wall ({100 * self._stage_host_seconds / wall:.0f}% "
                "— overlapped with device compute on a background thread)")
        self.logger.info("stage timing:\n" + self.tracer.summary())
        return self.detection_results

    def release(self) -> None:
        self.dataset.release()
