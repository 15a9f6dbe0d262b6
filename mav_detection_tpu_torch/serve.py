"""TinyYOLO inference server (``mav_detection_tpu.serve``): the reference's
YOLOv4 REST protocol, answered by the port's TinyYOLO on the card.

  GET  /config              -> {"start_time": <server start epoch>,
                                "media": ["npz"]}
                               (the client keys its content-hash cache on
                               start_time; "media" says which upload
                               containers are decoded)
  POST /predict_video       -> multipart field ``video``; query param
                               ``use_default_weights`` selects the RGB
                               fallback checkpoint; responds with the
                               annotated media bytes
  GET  /predict_video_boxes -> {"<frame>": ["name conf x y w h", ...]}
                               (top-left pixel coordinates). Optional
                               ``?hash=<sha1-of-media>`` returns the boxes
                               of THAT job (an LRU of 64), making a
                               concurrent POST-then-GET pair race-free;
                               without it the last-finished job's boxes
  GET  /health              -> {"ok": true}

Media: ``.npz`` archives (key ``frames``: (N, H, W, 3) uint8). The port has
no video decoder or encoder (no OpenCV), so any other container answers 400
naming the missing decoder, and the annotated output is always npz, the
box outlines drawn with numpy exactly where ``cv2.rectangle`` draws them.

Inference runs in batches of ``batch`` frames as one (B, H, W, 3) call with
the ragged tail edge-padded; the padded frames never appear in the result.
``ThreadingHTTPServer`` calls ``predict`` from several handler threads, so
the device work runs under a lock.
"""
from __future__ import annotations

import hashlib
import io
import json
import logging
import threading
import time
from collections import OrderedDict
from email.parser import BytesParser
from email.policy import HTTP as HTTP_POLICY
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple, Union
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from mav_detection_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

BOX_COLOR = (0, 0, 255)   # BGR red, as the reference draws


def _decode_media(data: bytes) -> Tuple[np.ndarray, str]:
    """Media bytes -> ((N, H, W, 3) uint8 frames, container kind)."""
    if data[:4] != b"PK\x03\x04":  # npz is a zip archive
        raise ValueError(
            "media is not an npz archive: the port has no video decoder (no "
            "OpenCV); post an npz with a 'frames' (N, H, W, 3) uint8 array")
    with np.load(io.BytesIO(data)) as z:
        if "frames" not in z:
            raise ValueError("npz media must carry a 'frames' array")
        frames = np.asarray(z["frames"], np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"bad frames shape {frames.shape}")
    return frames, "npz"


def draw_rectangle(img: np.ndarray, pt1: Tuple[int, int], pt2: Tuple[int, int],
                   color=BOX_COLOR) -> None:
    """The one-pixel outline ``cv2.rectangle(img, pt1, pt2, color, 1)``
    draws, clipped to the image, in place."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = pt1, pt2
    xa, xb = max(min(x1, x2), 0), min(max(x1, x2), w - 1)
    ya, yb = max(min(y1, y2), 0), min(max(y1, y2), h - 1)
    for y in (y1, y2):
        if 0 <= y < h and xa <= xb:
            img[y, xa:xb + 1] = color
    for x in (x1, x2):
        if 0 <= x < w and ya <= yb:
            img[ya:yb + 1, x] = color


def _encode_annotated(frames: np.ndarray, boxes: Dict[str, List[str]]) -> bytes:
    """Burn the detected boxes into the frames; npz bytes (key ``frames``)."""
    out = frames.copy()
    for i in range(len(out)):
        for s in boxes.get(str(i), []):
            parts = s.split(" ")
            x, y, w, h = (float(v) for v in parts[2:6])
            draw_rectangle(out[i], (int(x), int(y)), (int(x + w), int(y + h)))
    buf = io.BytesIO()
    np.savez_compressed(buf, frames=out)
    return buf.getvalue()


class YoloInferenceEngine:
    """Batched TinyYOLO over frame stacks on ``device``."""

    def __init__(self, mode: Optional[str] = None, batch: int = 8,
                 score_threshold: float = 0.5,
                 device: Union[str, torch.device] = "cuda"):
        from mav_detection_tpu_torch.models import pretrained

        self.device = resolve_device(device)
        self.batch = int(batch)
        self.score_threshold = float(score_threshold)
        self._model = pretrained.load_yolo(mode, self.device)
        self._default_model = (pretrained.load_yolo(None, self.device)
                               if mode else self._model)
        if self._model is None:
            raise RuntimeError(
                "no TinyYOLO checkpoint shipped — the JAX package trains one "
                "with `python -m mav_detection_tpu.cli.train --model yolo`")
        self._lock = threading.Lock()

    def predict(self, frames: np.ndarray,
                use_default_weights: bool = False) -> Dict[str, List[str]]:
        from mav_detection_tpu_torch.models.yolo import batch_box_strings

        model = self._default_model if use_default_weights else self._model
        with self._lock:
            strings = batch_box_strings(model, frames, self.batch,
                                        self.score_threshold)
        return {str(i): s for i, s in enumerate(strings)}


class YoloServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying engine + last-job state."""

    daemon_threads = True

    MAX_JOBS = 64  # bound on retained per-hash results

    def __init__(self, addr, engine: YoloInferenceEngine):
        super().__init__(addr, _Handler)
        self.engine = engine
        self.start_time = time.time()
        self.last_boxes: Dict[str, List[str]] = {}
        # content-sha1 -> boxes, insertion-ordered for LRU eviction: lets a
        # client's POST-then-GET pair survive interleaved concurrent jobs
        self.boxes_by_hash: "OrderedDict[str, Dict[str, List[str]]]" = \
            OrderedDict()
        self._lock = threading.Lock()

    def store_boxes(self, digest: str, boxes: Dict[str, List[str]]) -> None:
        with self._lock:
            self.last_boxes = boxes
            self.boxes_by_hash.pop(digest, None)
            self.boxes_by_hash[digest] = boxes
            while len(self.boxes_by_hash) > self.MAX_JOBS:
                self.boxes_by_hash.popitem(last=False)


class _Handler(BaseHTTPRequestHandler):
    server: YoloServer

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug("serve: " + fmt % args)

    def _json(self, obj, code: int = 200) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        path = urlparse(self.path).path
        if path == "/config":
            self._json({"start_time": self.server.start_time, "media": ["npz"]})
        elif path == "/predict_video_boxes":
            digest = parse_qs(urlparse(self.path).query).get("hash", [None])[0]
            # snapshot under the lock, write to the socket OUTSIDE it — a
            # stalled client reader must not block every other handler
            with self.server._lock:
                if digest is None:  # reference-sidecar behavior: last job
                    boxes = dict(self.server.last_boxes)
                else:
                    boxes = self.server.boxes_by_hash.get(digest)
                    boxes = dict(boxes) if boxes is not None else None
            if boxes is not None:
                self._json(boxes)
            else:
                self._json({"error": f"unknown job hash {digest}"}, 404)
        elif path == "/health":
            self._json({"ok": True})
        else:
            self._json({"error": f"unknown path {path}"}, 404)

    def do_POST(self) -> None:
        parsed = urlparse(self.path)
        if parsed.path != "/predict_video":
            self._json({"error": f"unknown path {parsed.path}"}, 404)
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            media = self._multipart_field(body, "video")
            if media is None:
                raise ValueError("multipart field 'video' missing")
            q = parse_qs(parsed.query)
            use_default = q.get("use_default_weights",
                                ["False"])[0].lower() in ("true", "1")
            frames, _ = _decode_media(media)
            boxes = self.server.engine.predict(
                frames, use_default_weights=use_default)
            self.server.store_boxes(hashlib.sha1(media).hexdigest(), boxes)
            out = _encode_annotated(frames, boxes)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)
        except Exception as e:  # surface decode/infer errors to the client
            logger.exception("predict_video failed")
            self._json({"error": str(e)}, 400)

    def _multipart_field(self, body: bytes, name: str) -> Optional[bytes]:
        ctype = self.headers.get("Content-Type", "")
        msg = BytesParser(policy=HTTP_POLICY).parsebytes(
            b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body)
        for part in msg.iter_parts():
            if part.get_param("name", header="Content-Disposition") == name:
                return part.get_payload(decode=True)
        return None


def create_server(port: int = 0, host: str = "127.0.0.1",
                  mode: Optional[str] = None, batch: int = 8,
                  score_threshold: float = 0.5,
                  device: Union[str, torch.device] = "cuda") -> YoloServer:
    """Build a server bound to ``host:port`` (0 = ephemeral; read
    ``server.server_address[1]``). Call ``serve_forever()`` to run."""
    engine = YoloInferenceEngine(mode=mode, batch=batch,
                                 score_threshold=score_threshold, device=device)
    return YoloServer((host, port), engine)
