"""Validation (``mav_detection_tpu.eval.validator``): per-frame result
aggregation, FoE-error stats, ROC artifacts, and in the NN detection modes
TinyYOLO over the sequence with its IoU against the annotations.

Copied unchanged from the reference: ``binned_mean_std``, the loading and
FoE statistics, the ``validation.npy`` layout, the box-string protocol
(``parse_frames``), the content-hash cache (``get_hash``, ``check_cache``).

What differs, by design:

* **Local inference** runs the port's TinyYOLO on ``device`` (the card
  unless the caller passes another), over mode imagery whose flow comes from
  ``.flo`` files, else GT flow, else the port's Farneback on the card in
  chunks of 8 pairs.
* **The remote client** (``YOLO_INFERENCE_HOST``) speaks the reference's
  REST protocol through ``urllib.request`` with a hand-built multipart body,
  not ``requests``.
* **npz only.** The port has no video encoder: a host that does not
  advertise ``npz`` (a reference-era YOLOv4 sidecar), or
  ``MAVTPU_NN_MEDIA=video``, raises.
* **Figures.** ``matplotlib`` is imported lazily; where it cannot be, the
  figures are skipped with one WARNING that names them, and every number is
  still computed and written (the returned stats, ``validation.npy``, the
  box cache).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import urllib.error
import urllib.parse
import urllib.request
import uuid
import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from mav_detection_tpu_torch.core.config import Mode, RunConfig
from mav_detection_tpu_torch.core.frame_result import FrameResult
from mav_detection_tpu_torch.core.rectangle import Rectangle
from mav_detection_tpu_torch.data.dataset import create_if_not_exists
from mav_detection_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("mav_detection_tpu_torch")

FOE_OUTLIER_THRESHOLD = 50.0
FOE_STABILIZE_FRAME = 56
# pairs per Farneback call of the flow the mode imagery is rendered from, and
# frames per TinyYOLO call (the server's batch)
FLOW_CHUNK = 8
YOLO_BATCH = 8
FIGURES = ("ious.png", "media/output/foe-error.png", "tpr_vs_time_raw",
           "tpr_vs_time", "sky_roc", "roc.png", "roc.eps")


def binned_mean_std(x: np.ndarray, y: np.ndarray, bins: np.ndarray) -> np.ndarray:
    """(len(bins), 3) rows of [mean_x, mean_y, std_y] per bin.

    Like the reference's ``get_avg_std`` (``np.zeros((len(bins), 3))``
    filled by a ``range(1, len(bins))`` loop), the LAST row is never written
    and stays zero; ``validation.npy`` keeps that shape."""
    out = np.zeros((len(bins), 3))
    y_finite_mask = ~np.isnan(y)
    idx = np.digitize(x, bins) - 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for b in range(len(bins) - 1):
            m = idx == b
            out[b, 0] = np.mean(x[m]) if m.any() else np.nan
            my = m & y_finite_mask
            out[b, 1] = np.mean(y[my]) if my.any() else np.nan
            out[b, 2] = np.std(y[my]) if my.any() else np.nan
    return out


def _http_get(url: str, timeout: Optional[float] = None) -> Tuple[int, bytes]:
    """(status, body) of a GET; HTTP error statuses come back, not raise."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def multipart_body(field: str, filename: str, data: bytes) -> Tuple[bytes, str]:
    """A multipart/form-data body holding one file field, and its
    Content-Type header value."""
    boundary = uuid.uuid4().hex
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{field}\"; "
            f"filename=\"{filename}\"\r\nContent-Type: application/octet-stream"
            f"\r\n\r\n").encode() + data + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


class Validator:
    def __init__(self, config: RunConfig, host: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda") -> None:
        self.config = config
        self.host = host or os.environ.get("YOLO_INFERENCE_HOST",
                                           "http://127.0.0.1:8099")
        self.frames: Dict[int, FrameResult] = {}
        self.foe_error = np.zeros((0, 2))
        self.device = resolve_device(device)
        self._plots_skipped = False

    # ----------------------------------------------------------- loading
    def run_validation(self) -> Dict[str, Any]:
        self.dataset = self.config.get_dataset(device=self.device)
        nn_stats: Dict[str, Any] = {}
        if self.config.uses_nn_for_detection():
            nn_stats = self.run_nn_validation()
        self.load_results()
        stats = self.compute_foe_stats()
        self.plot(stats)
        roc = self.plot_roc()
        return {**stats, **roc, **nn_stats}

    # ------------------------------------------------- NN detection modes
    def run_nn_validation(self) -> Dict[str, Any]:
        """TinyYOLO (local, or the remote client when ``YOLO_INFERENCE_HOST``
        is set) over the sequence, IoU against the ground-truth annotations,
        ``ious.png`` and the summary stats."""
        if os.environ.get("YOLO_INFERENCE_HOST"):
            src = self._nn_input_media(as_video=not self._server_accepts_npz())
            base, ext = os.path.splitext(src)
            raw = self.get_inference(src, f"{base}-out{ext}")
        else:
            raw = self.run_local_inference(self.dataset)
        detections = self.parse_frames(raw)

        ious: List[float] = []
        for i in range(self.dataset.N):
            gts = self.dataset.get_annotation(i)
            if not gts:
                continue
            best = 0.0
            for _, _, rect in detections.get(i, []):
                for gt in gts:
                    best = max(best, Rectangle.calculate_iou_safe(rect, gt))
            ious.append(best)
        iou_arr = np.asarray(ious)
        detected = iou_arr > 0.25

        if self.dataset.seq_path and iou_arr.size:
            plt = self._plt()
            if plt is not None:
                plt.figure()
                plt.grid()
                plt.hist(iou_arr, np.linspace(0, 1, 21))
                plt.xlabel("IoU")
                plt.ylabel("Frequency [frames]")
                plt.savefig(f"{self.dataset.seq_path}/ious.png", bbox_inches="tight")
                plt.close()
        if iou_arr.size:
            print(f"IoU mean: {iou_arr.mean():.3f}, std: {iou_arr.std():.3f}, "
                  f"detection rate (IoU>0.25): {detected.mean():.3f}")
        return {
            "iou_mean": float(iou_arr.mean()) if iou_arr.size else None,
            "iou_std": float(iou_arr.std()) if iou_arr.size else None,
            "detection_rate": float(detected.mean()) if iou_arr.size else None,
        }

    def _server_accepts_npz(self) -> bool:
        """Whether the inference host advertises ``"npz"`` in ``GET
        /config``; ``MAVTPU_NN_MEDIA=npz|video`` overrides, and an
        unreachable host counts as one that does not."""
        forced = os.environ.get("MAVTPU_NN_MEDIA", "").lower()
        if forced in ("npz", "video"):
            return forced == "npz"
        try:
            status, body = _http_get(f"{self.host}/config", timeout=10)
            cfg = json.loads(body)
        except Exception:
            return False
        return status == 200 and "npz" in cfg.get("media", ())

    def _nn_input_media(self, as_video: bool = False) -> str:
        """Build (idempotently) the mode imagery of all N frames for the
        remote server as an npz stack (key ``frames``). Video is refused:
        the port has no encoder."""
        import tempfile

        if as_video:
            raise RuntimeError(
                "the inference host takes video only (it does not advertise "
                "npz in GET /config, or MAVTPU_NN_MEDIA=video), and the port "
                "has no video encoder; serve with an npz-capable server, or "
                "set MAVTPU_NN_MEDIA=npz if this one accepts npz")
        base = self.dataset.seq_path or tempfile.mkdtemp(prefix="nn-input-")
        path = os.path.join(base, f"nn-input-{self.config.mode.name.lower()}.npz")
        if os.path.exists(path) and self._media_cache_valid(path):
            return path
        frames = []
        for i in range(self.dataset.N):
            img = self._mode_image(self.dataset, i)
            if img is None:
                raise RuntimeError(
                    f"dataset produced no frame {i}/{self.dataset.N} for NN "
                    "validation — refusing to post a short stack (box keys "
                    "are positional)")
            frames.append(np.asarray(img, np.uint8))
        np.savez_compressed(path, frames=np.stack(frames))
        return path

    def _media_cache_valid(self, path: str) -> bool:
        try:  # a truncated/corrupt cache means rebuild, not crash
            with np.load(path) as z:
                return len(z["frames"]) == self.dataset.N
        except Exception:
            return False

    def run_local_inference(self, dataset,
                            score_threshold: float = 0.5) -> Dict[str, List[str]]:
        """TinyYOLO on ``self.device`` over every frame, in the remote
        client's box-string protocol (``"name conf x y w h"``, top-left
        pixel coordinates), in calls of ``YOLO_BATCH`` frames as the server
        runs them. Cached under ``bounding-boxes/``, keyed by the
        checkpoint's sha1, N and the mode."""
        from mav_detection_tpu_torch.models import pretrained
        from mav_detection_tpu_torch.models.yolo import batch_box_strings

        model = pretrained.load_yolo(self.config.mode.name, self.device)
        if model is None:
            raise RuntimeError(
                "no TinyYOLO checkpoint found — the JAX package trains one "
                "with `python -m mav_detection_tpu.cli.train --model yolo`; "
                "or set YOLO_INFERENCE_HOST for remote inference")

        cache_dir = os.path.join(dataset.seq_path or ".", "bounding-boxes")
        ckpt = pretrained.resolve_yolo_checkpoint(self.config.mode.name)
        digest = (self.get_hash(ckpt) if os.path.exists(ckpt) else "live")
        digest += f"-{dataset.N}-{self.config.mode.name}"
        cache, json_path = self.check_cache(digest, cache_dir)
        if cache is not None:
            return cache

        strings: List[List[str]] = []
        chunk: List[np.ndarray] = []
        for i in range(dataset.N + 1):
            frame = self._mode_image(dataset, i) if i < dataset.N else None
            if frame is not None:
                chunk.append(np.asarray(frame))
            if chunk and (frame is None or len(chunk) == YOLO_BATCH):
                strings += batch_box_strings(model, np.stack(chunk), YOLO_BATCH,
                                             score_threshold)
                chunk = []
            if frame is None:
                break
        result = {str(i): s for i, s in enumerate(strings)}
        with open(json_path, "w") as f:
            json.dump(result, f)
        return result

    def _mode_image(self, dataset, i: int):
        """The mode-appropriate NN input of frame ``i``
        (``pipeline/mode_imagery.mode_image_host``)."""
        from mav_detection_tpu_torch.pipeline.mode_imagery import mode_image_host

        frame = dataset.get_frame(i)
        if frame is None or self.config.mode == Mode.APPEARANCE_RGB:
            return frame
        j = min(i, dataset.N - 2)  # the final frame reuses the last pair
        flow = self._pair_flow(dataset, j)
        return mode_image_host(frame, flow, self.config.mode.name, seed=i,
                               device=self.device)

    def _pair_flow(self, dataset, i: int) -> np.ndarray:
        """Dense flow for pair (i, i+1): precomputed .flo when present, else
        GT flow, else the port's Farneback on ``self.device``, batched in
        chunks of ``FLOW_CHUNK`` pairs with a one-chunk cache (callers sweep
        i in order)."""
        if dataset.has_precomputed_flow():
            return np.asarray(dataset.get_flow_uv(i), np.float32)
        gt = dataset.get_gt_of(i)
        if gt is not None:
            return np.asarray(gt, np.float32)
        from mav_detection_tpu_torch.ops.flow.farneback import farneback_flow_batch
        from mav_detection_tpu_torch.ops.image.color import bgr_to_gray_host

        c0 = (i // FLOW_CHUNK) * FLOW_CHUNK
        if getattr(self, "_fb_chunk_start", None) != c0:
            idx = range(c0, min(c0 + FLOW_CHUNK, dataset.N - 1))
            prevs = np.stack([bgr_to_gray_host(dataset.get_frame(k)) for k in idx])
            currs = np.stack([bgr_to_gray_host(dataset.get_frame(k + 1)) for k in idx])
            self._fb_chunk = farneback_flow_batch(
                prevs, currs, device=self.device).cpu().numpy()
            self._fb_chunk_start = c0
        return self._fb_chunk[i - c0]

    def load_results(self) -> None:
        self.frames = {}
        for i in range(self.dataset.N - 1):
            path = f"{self.dataset.results_path}/image_{i:05d}.json"
            if not os.path.exists(path):
                continue
            self.frames[i] = FrameResult.from_json_file(path)

    # ------------------------------------------------------------- stats
    def compute_foe_stats(self) -> Dict[str, Any]:
        if not self.frames:
            return {"foe_mean": None, "foe_std": None, "foe_outliers": 0}
        foe_dense = np.array([f.foe_dense for f in self.frames.values()], float)
        foe_gt = np.array([[np.nan, np.nan] if f.foe_gt is None else f.foe_gt
                           for f in self.frames.values()], float)
        if np.isnan(foe_gt).all():
            return {"foe_mean": None, "foe_std": None, "foe_outliers": 0}

        start = FOE_STABILIZE_FRAME if len(foe_dense) > FOE_STABILIZE_FRAME else 0
        self.foe_error = foe_dense[start:] - foe_gt[start:]
        err = self.foe_error[~np.isnan(self.foe_error).any(axis=1)]
        inliers = err[(np.abs(err) < FOE_OUTLIER_THRESHOLD).all(axis=1)]
        n_out = len(err) - len(inliers)
        if len(inliers) == 0:
            print("Error: no inliers in FoE estimates")
            return {"foe_mean": None, "foe_std": None, "foe_outliers": n_out}
        mean = inliers.mean(axis=0)
        std = inliers.std(axis=0)
        print(f"foe outliers: {n_out}, average error: "
              f"({mean[0]:.2f}, {mean[1]:.2f}), std: ({std[0]:.1f}, {std[1]:.1f})")
        return {"foe_mean": mean.tolist(), "foe_std": std.tolist(),
                "foe_outliers": int(n_out)}

    # -------------------------------------------------------------- plots
    def _plt(self):
        """``matplotlib.pyplot`` on the Agg backend, or None where it cannot
        be imported (said once per Validator, naming the figures skipped)."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            if not self._plots_skipped:
                logger.warning(
                    "matplotlib cannot be imported: skipping the figures "
                    f"{', '.join(FIGURES)}; the statistics, validation.npy and "
                    "the box cache are still written")
                self._plots_skipped = True
            return None
        return plt

    def plot(self, stats: Dict[str, Any]) -> None:
        plt = self._plt()
        if plt is None:
            return
        create_if_not_exists("media/output")
        if self.foe_error.size:
            plt.figure()
            plt.grid()
            plt.hist(self.foe_error[:, 0], np.linspace(-60, 60, 30), alpha=0.6,
                     label="x error")
            plt.hist(self.foe_error[:, 1], np.linspace(-60, 60, 30), alpha=0.6,
                     label="y error")
            plt.xlabel("FoE error [px]")
            plt.ylabel("Frequency [frames]")
            plt.legend()
            plt.savefig("media/output/foe-error.png", bbox_inches="tight")
            plt.close()

    def plot_roc(self) -> Dict[str, Any]:
        if not self.frames or not self.dataset.seq_path:
            return {}
        plt = self._plt()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return self._roc(plt)

    def _roc(self, plt) -> Dict[str, Any]:
        f = list(self.frames.values())
        phi = np.array([float(x.center_phi) for x in f])
        tpr = np.array([x.tpr for x in f])
        tpr_fixed = np.array([x.tpr_fixed for x in f])
        fpr = np.array([x.fpr for x in f])
        fpr_fixed = np.array([x.fpr_fixed for x in f])
        flow_x = np.array([float(x.drone_flow_pixels[0]) for x in f])
        flow_y = np.array([float(x.drone_flow_pixels[1]) for x in f])
        size = np.array([float(x.drone_size_pixels) for x in f])
        flow_x = flow_x[~np.isnan(flow_x)]
        flow_y = flow_y[~np.isnan(flow_y)]

        seq = self.dataset.seq_path

        # kappa vs TPR (raw + binned)
        if plt is not None:
            plt.figure()
            plt.grid()
            plt.plot(phi, tpr, ls="", marker="o")
            plt.xlabel(r"$\kappa$ [deg]")
            plt.ylabel("True Positive Rate")
            plt.ylim(0, 1.0)
            plt.savefig(f"{seq}/tpr_vs_time_raw", bbox_inches="tight")
            plt.close()

        bins = np.linspace(-180, 0, 40)
        avg_std_tpr = binned_mean_std(phi, tpr, bins)
        avg_std_tpr_fixed = binned_mean_std(phi, tpr_fixed, bins)
        avg_std_fpr = binned_mean_std(phi, fpr, bins)
        avg_std_fpr_fixed = binned_mean_std(phi, fpr_fixed, bins)

        if plt is not None:
            plt.figure()
            plt.grid()
            plt.xlabel(r"$\kappa$ [deg]")
            plt.ylabel("True Positive Rate")
            plt.ylim(0, 1.0)
            plt.errorbar(avg_std_tpr[:, 0], avg_std_tpr[:, 1], yerr=avg_std_tpr[:, 2],
                         marker="o", markersize=6, capsize=3, color="indigo")
            plt.savefig(f"{seq}/tpr_vs_time", bbox_inches="tight")
            plt.close()

        np.save(f"{seq}/validation.npy", np.array([
            np.average(tpr), np.std(tpr),
            np.average(size), np.std(size),
            np.median(flow_x) if flow_x.size else np.nan,
            np.std(flow_x) if flow_x.size else np.nan,
            np.average(flow_y) if flow_y.size else np.nan,
            np.std(flow_y) if flow_y.size else np.nan,
            avg_std_tpr, avg_std_tpr_fixed,
            avg_std_fpr, avg_std_fpr_fixed,
            fpr, tpr,
            self.foe_error,
        ], dtype=object), allow_pickle=True)

        # sky ROC (first half of frames, like the reference)
        sky_fpr = np.array([x.sky_fpr for x in f])[: len(f) // 2]
        sky_tpr = np.array([x.sky_tpr for x in f])[: len(f) // 2]
        # detection ROC over fixed-threshold rates
        bins_roc = np.linspace(0, 5.2e-4, 30)
        avg_std_roc = binned_mean_std(fpr_fixed, tpr_fixed, bins_roc)
        if plt is not None:
            plt.figure()
            plt.grid()
            plt.plot(sky_fpr, sky_tpr, ls="", marker="o")
            plt.xlabel("False Positive Rate")
            plt.ylabel("True Positive Rate")
            plt.ylim(0, 1.0)
            plt.savefig(f"{seq}/sky_roc", bbox_inches="tight")
            plt.close()

            plt.figure()
            plt.grid()
            plt.errorbar(avg_std_roc[:-1, 0], avg_std_roc[:-1, 1],
                         yerr=avg_std_roc[:-1, 2], marker="o", markersize=6,
                         capsize=3, color="indigo")
            plt.xlabel("False Positive Rate")
            plt.ylabel("True Positive Rate")
            plt.ylim(0, 1.0)
            plt.savefig(f"{seq}/roc.png", bbox_inches="tight")
            plt.savefig(f"{seq}/roc.eps", bbox_inches="tight")
            plt.close()

        return {
            "tpr_mean": float(np.nanmean(tpr)) if tpr.size else None,
            "fpr_mean": float(np.nanmean(fpr)) if fpr.size else None,
            "tpr_fixed_mean": float(np.nanmean(tpr_fixed)) if tpr_fixed.size else None,
            "fpr_fixed_mean": float(np.nanmean(fpr_fixed)) if fpr_fixed.size else None,
        }

    # ------------------------------------------- remote-inference client
    def get_hash(self, filename: str) -> str:
        sha = hashlib.sha1()
        with open(filename, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                sha.update(chunk)
        return sha.hexdigest()

    def check_cache(self, digest: str, directory: str
                    ) -> Tuple[Optional[Dict[str, List[str]]], str]:
        json_path = f"{directory}/{digest}.json"
        create_if_not_exists(directory)
        if os.path.exists(json_path):
            with open(json_path, "r") as f:
                return json.load(f), json_path
        return None, json_path

    def get_inference(self, input_file: str, output_file: str,
                      use_default_weights: bool = False) -> Dict[str, List[str]]:
        """Remote YOLO inference of a media file with content-hash caching
        (the reference's protocol over urllib). Returns frame -> box-string
        lists."""
        boxes_dir = os.path.dirname(input_file) + "/bounding-boxes"
        status, body = _http_get(f"{self.host}/config")
        if status != 200:
            raise RuntimeError(f"inference server GET /config: HTTP {status}")
        run_ts = str(json.loads(body)["start_time"])
        content_hash = self.get_hash(input_file)
        digest = content_hash + "-" + run_ts
        cache, json_path = self.check_cache(digest, boxes_dir)
        if cache is not None:
            return cache

        with open(input_file, "rb") as fh:
            data, ctype = multipart_body("video", os.path.basename(input_file),
                                         fh.read())
        query = urllib.parse.urlencode({"use_default_weights": use_default_weights})
        req = urllib.request.Request(
            f"{self.host}/predict_video?{query}", data=data, method="POST",
            headers={"accept": "application/json", "Content-Type": ctype})
        try:
            with urllib.request.urlopen(req) as r:
                annotated = r.read()
        except urllib.error.HTTPError as e:
            raise RuntimeError(f"inference server POST /predict_video: HTTP "
                               f"{e.code}: {e.read()[:500]!r}") from None
        with open(output_file, "wb") as out:
            out.write(annotated)
        # keyed by the media hash so a concurrent job on the shared server
        # can't swap its boxes in between our POST and this GET
        q = urllib.parse.urlencode({"hash": content_hash})
        status, body = _http_get(f"{self.host}/predict_video_boxes?{q}")
        if status == 404:
            # the server evicted our job (busy LRU) — the unkeyed GET is a
            # last resort, racy on a shared server (reference behavior)
            status, body = _http_get(f"{self.host}/predict_video_boxes")
        if status != 200:
            raise RuntimeError(f"inference server GET /predict_video_boxes: "
                               f"HTTP {status}: {body[:500]!r}")
        result = json.loads(body)
        if not isinstance(result, dict) or "error" in result:
            # never persist an error payload into the content-hash cache
            raise RuntimeError(f"inference server error: {result}")
        with open(json_path, "w") as f:
            json.dump(result, f)
        return result

    @staticmethod
    def parse_frames(frames: Dict[Any, List[str]]) -> Dict[int, List[Tuple[str, float, Rectangle]]]:
        """Box strings -> (name, confidence, Rectangle) per frame."""
        out: Dict[int, List[Tuple[str, float, Rectangle]]] = {}
        for frame, boxes in frames.items():
            parsed = []
            for box in boxes:
                parts = box.split(" ")
                floats = [float(x) for x in parts[1:]]
                parsed.append((parts[0], floats[0],
                               Rectangle.from_yolo_output(floats[1:])))
            out[int(frame)] = parsed
        return out
