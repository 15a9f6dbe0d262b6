"""Dataset base: the on-disk sequence contract.

Same directory layout and accessor surface as
``mav_detection_tpu.data.dataset``:

    <base>/<sequence>/
        images/image_%05d.png        segmentations/image_%05d.png
        depths/image_%05d.pfm        optical-flow/image_%05d.flo   (GT flow)
        annotation/image_%05d.txt    results/image_%05d.json

Sky masks come from precomputed HRNet outputs where present, else from the
SkyUNet (``models/sky_segmentation.py``) on ``Dataset.device``, cached back as
HRNet-layout PNGs. At construction the preprocessing of
``data/preprocessing.py`` runs as in the reference: frames are recovered from
``recording.mp4`` through ``ffmpeg`` where it is on the path; stray ``.jpg``
frames raise, since the port has no JPEG decoder.

Images are PNGs, written and read by this module's own codec on ``zlib`` and
``struct`` (no imageio, no OpenCV). The decoder undoes the row filters in
native code (``runtime/native/png.cpp``, built with g++ at first use) and
reads what the reference's imageio reads: gray, gray+alpha, RGB, RGBA and
palette images at 8 bits, 16-bit gray as uint16, other 16-bit images as
their high bytes, palettes at 1, 2 and 4 bits too.
"""
from __future__ import annotations

import glob
import logging
import os
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from mav_detection_tpu_torch import _build
from mav_detection_tpu_torch.core.flo import read_flow
from mav_detection_tpu_torch.core.rectangle import Rectangle, parse_yolo_annotation
from mav_detection_tpu_torch.utils.device import resolve_device

_LOG = logging.getLogger("mav_detection_tpu_torch.data")

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# channels per pixel by PNG colour type (3: palette indices)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# bit depths the decoder reads, by colour type
_PNG_DEPTHS = {0: (8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}

# images decoded with the native unfilter and with the Python loop, since
# the process started (chip_smoke.py reads them to show which path ran)
DECODES: Dict[str, int] = {"native": 0, "plain": 0}
_DECODES_LOCK = threading.Lock()
_UNFILTER_LOCK = threading.Lock()
_UNFILTER = None        # the native function once loaded; False without g++


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_encode(img: np.ndarray) -> bytes:
    """8-bit PNG bytes of a gray (h, w) or RGB (h, w, 3) uint8 array
    (filter type 0 on every row, zlib level 3)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        colour = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        colour = 2
    else:
        raise ValueError(f"png_encode takes (h, w) or (h, w, 3), got {img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + img[0].size), np.uint8)   # leading filter byte 0
    rows[:, 1:] = img.reshape(h, -1)
    return (_PNG_MAGIC
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 3))
            + _png_chunk(b"IEND", b""))


def _paeth_or_average(ftype: int, line: np.ndarray, prev: np.ndarray,
                      bpp: int) -> np.ndarray:
    """Undo PNG filter 3 (Average) or 4 (Paeth) on one row. Each byte needs
    the reconstructed byte ``bpp`` to its left, so this is a byte loop."""
    cur = line.tolist()
    up = prev.tolist()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.array(cur, np.uint8)


def unfilter_plain(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters of an inflated image, (h, 1 + stride) uint8 with
    the filter type first in each row -> (h, stride): the plain version of
    ``runtime/native/png.cpp::png_unfilter``. Sub and Up are array
    operations; Average and Paeth rows take a byte loop."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(raw[y, 0]), raw[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:    # Sub: running sum along the row, per byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:    # Up
            cur = line + prev
        elif ftype in (3, 4):
            cur = _paeth_or_average(ftype, line, prev, bpp)
        else:
            raise ValueError(f"bad PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def _native_unfilter():
    """``png_unfilter`` from the native library, built at first use; False
    where g++ is missing (said once at WARNING). A failed build raises."""
    global _UNFILTER
    with _UNFILTER_LOCK:
        if _UNFILTER is None:
            try:
                _UNFILTER = _build.load("png").png_unfilter
            except _build.CompilerMissing as e:
                _UNFILTER = False
                _LOG.warning(f"PNG rows are unfiltered by the Python loop, "
                             f"about 0.5 s per 752x480 RGB frame: {e}")
        return _UNFILTER


def png_unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """``unfilter_plain``'s result, from the native library where it builds."""
    native = _native_unfilter()
    if not native:
        out = unfilter_plain(raw, bpp)
        kind = "plain"
    else:
        raw = np.ascontiguousarray(raw, np.uint8)
        h, stride = raw.shape[0], raw.shape[1] - 1
        out = np.empty((h, stride), np.uint8)
        rc = native(raw.reshape(-1), out.reshape(-1), h, stride, bpp)
        if rc != 0:
            raise ValueError(f"bad PNG filter type in row {rc - 1}" if rc > 0
                             else f"png_unfilter: bad arguments ({h}, {stride}, {bpp})")
        kind = "native"
    with _DECODES_LOCK:
        DECODES[kind] += 1
    return out


def png_decode(data: bytes) -> np.ndarray:
    """Decode a non-interlaced PNG into (h, w) or (h, w, c), as the
    reference's ``imageio.v3.imread`` returns it: uint8, except 16-bit gray
    (uint16); other 16-bit images give their high bytes, as Pillow reads
    them. Palette images expand to RGB, or to RGBA where a ``tRNS`` chunk
    gives alpha (imageio drops it: ``imread`` keeps three channels either
    way). Sub-byte gray and interlaced files raise ``ValueError``."""
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, idat, header, palette, trns = 8, [], None, None, None
    while pos < len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[colour] or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {colour}, "
            f"interlace {interlace}): bit depths 1, 2 and 4 are read for "
            "palettes only, and interlaced (Adam7) files not at all")
    channels = _PNG_CHANNELS[colour]
    bits = channels * depth
    stride = (w * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG data length does not match its header")
    rows = png_unfilter(raw.reshape(h, stride + 1), max(1, bits // 8))
    if depth < 8:           # packed palette indices, most significant first
        bits_of = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
        img = (bits_of << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
            -1, dtype=np.uint8)[..., None]
    elif depth == 16:
        img = rows.view(">u2").reshape(h, w, channels)
        img = img.astype(np.uint16) if colour == 0 else (img >> 8).astype(np.uint8)
    else:
        img = rows.reshape(h, w, channels)
    if colour == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        if trns is not None:
            alpha = np.full((len(palette), 1), 255, np.uint8)
            alpha[:min(len(trns), len(palette)), 0] = trns[:len(palette)]
            palette = np.concatenate([palette, alpha], axis=1)
        index = img[..., 0]
        if index.size and int(index.max()) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[index]
    return img[..., 0] if channels == 1 else img


def imread(path: str) -> np.ndarray:
    """Read a PNG as BGR uint8 (the upstream code is BGR-ordered), or gray
    (h, w); 16-bit gray stays uint16."""
    with open(path, "rb") as f:
        img = png_decode(f.read())
    if img.ndim == 3 and img.shape[2] >= 3:
        img = img[..., :3][..., ::-1]  # RGB -> BGR
    return np.ascontiguousarray(img)


def imwrite(path: str, img: np.ndarray) -> None:
    """Write a gray (h, w) or BGR (h, w, 3+) array as an 8-bit PNG."""
    out = img
    if img.ndim == 3 and img.shape[2] >= 3:
        out = img[..., :3][..., ::-1]  # BGR -> RGB
    with open(path, "wb") as f:
        f.write(png_encode(out.astype(np.uint8)))


def read_pfm(path: str) -> np.ndarray:
    """Portable float map reader (AirSim depth format)."""
    with open(path, "rb") as f:
        header = f.readline().decode("ascii").strip()
        if header not in ("Pf", "PF"):
            raise ValueError(f"not a PFM file: {path}")
        channels = 3 if header == "PF" else 1
        dims = f.readline().decode("ascii").strip()
        while dims.startswith("#"):
            dims = f.readline().decode("ascii").strip()
        w, h = (int(v) for v in dims.split())
        scale = float(f.readline().decode("ascii").strip())
        little_endian = scale < 0
        data = np.fromfile(f, "<f4" if little_endian else ">f4", count=w * h * channels)
    img = data.reshape(h, w) if channels == 1 else data.reshape(h, w, 3)
    # PFM stores rows bottom-to-top
    return np.ascontiguousarray(img[::-1])


def write_pfm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        img[::-1].astype("<f4").tofile(f)


def create_if_not_exists(d: str) -> None:
    os.makedirs(d, exist_ok=True)


def sorted_glob(pattern: str) -> List[str]:
    out = glob.glob(pattern)
    out.sort()
    return out


def _resize_nearest(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Nearest-neighbour resize with OpenCV's INTER_NEAREST sampling
    (source index ``floor(dst * src / dst_size)``)."""
    sh, sw = img.shape[:2]
    if (sh, sw) == (h, w):
        return img
    rows = np.minimum((np.arange(h) * (sh / h)).astype(np.int64), sh - 1)
    cols = np.minimum((np.arange(w) * (sw / w)).astype(np.int64), sw - 1)
    return img[rows][:, cols]


class Dataset:
    """Filesystem-backed sequence with the upstream accessor surface.

    ``device`` is where the SkyUNet runs for frames without a precomputed
    sky mask, and where a ``SimDataset`` synthesises its ground-truth flow:
    the card unless the caller passes another (the Processor passes its
    own)."""

    device: Union[str, torch.device] = "cuda"

    def __init__(self, base_path: str, logger: Optional[logging.Logger],
                 sequence: str, img_dir: str = "/images", seq_dir: str = "",
                 device: Union[str, torch.device] = "cuda") -> None:
        self.logger = logger or logging.getLogger("mav_detection_tpu_torch.data")
        self.device = device
        self.sequence = sequence or self.get_default_sequence()
        self.base_path = base_path
        self.seq_path = f"{base_path}{seq_dir}/{self.sequence}"
        self.img_path = f"{self.seq_path}{img_dir}"
        self.seg_path = f"{self.seq_path}/segmentations"
        self.depth_path = f"{self.seq_path}/depths"
        self.depth_vis_path = f"{self.seq_path}/depth-vis"
        self.gt_of_path = f"{self.seq_path}/optical-flow"
        self.gt_of_vis_path = f"{self.seq_path}/optical-flow-vis"
        self.ann_path = f"{self.seq_path}/annotation"
        self.results_path = f"{self.seq_path}/results"
        self.result_imgs_path = f"{self.seq_path}/result-images"
        self.state_path = f"{self.seq_path}/states"
        self.half_res_img_path = f"{self.seq_path}/half-res-images"
        self.hrnet_out = f"{self.half_res_img_path}/hrnet"
        self.flow_path = f"{self.img_path}/output/inference/run.epoch-0-flow-field"

        # idempotent preprocessing, as the reference's: recover frames from a
        # recording where ffmpeg is on the path, refuse stray jpgs (no JPEG
        # decoder here), normalize indices
        from mav_detection_tpu_torch.data import preprocessing as prep

        vid_path = f"{self.seq_path}/recording.mp4"
        if os.path.isdir(self.img_path):
            prep.jpgs_to_pngs(self.img_path)
        if not glob.glob(f"{self.img_path}/image_*.png") and os.path.exists(vid_path):
            prep.video_to_images(vid_path, f"{self.img_path}/image_%5d.png")
            prep.renormalize_indices(self.img_path)

        self._frames = sorted_glob(f"{self.img_path}/image_*.png")
        self.N = len(self._frames)
        if self.N == 0:
            raise FileNotFoundError(
                f"no frames found under {self.img_path} (expected image_%05d.png)")

        first = imread(self._frames[0])
        self.capture_shape: Tuple[int, int, int] = first.shape  # (h, w, c)
        self.capture_size: Tuple[int, int] = (first.shape[1], first.shape[0])  # (w, h)
        self.resolution = np.array([first.shape[1], first.shape[0]])
        self.start_frame = 0
        self.ground_truth: List[Rectangle] = []

        create_if_not_exists(self.results_path)
        create_if_not_exists(self.ann_path)

    # ---------------------------------------------------------- accessors
    def get_default_sequence(self) -> str:
        raise NotImplementedError

    def get_frame(self, i: int) -> np.ndarray:
        return imread(self._frames[i])

    def get_flow_uv(self, i: int) -> np.ndarray:
        """Precomputed dense flow for frame pair (i, i+1) (FlowNet2-layout
        ``.flo``); the pipeline falls back to on-device flow when missing."""
        return read_flow(f"{self.flow_path}/{i:06d}.flo")

    def has_precomputed_flow(self) -> bool:
        return os.path.exists(f"{self.flow_path}/000000.flo")

    def get_flow_path(self, i: int) -> Optional[str]:
        path = f"{self.flow_path}/{i:06d}.flo"
        return path if os.path.exists(path) else None

    def get_gt_of_path(self, i: int) -> Optional[str]:
        path = f"{self.gt_of_path}/image_{i:05d}.flo"
        return path if os.path.exists(path) else None

    def get_annotation(self, i: int, ann_path: Optional[str] = None) -> List[Rectangle]:
        if ann_path is None:
            ann_path = f"{self.ann_path}/image_{i:05d}.txt"
        if not os.path.exists(ann_path):
            self.ground_truth = []
            return []
        self.ground_truth = parse_yolo_annotation(ann_path, self.resolution)
        return self.ground_truth

    def get_segmentation(self, i: int) -> np.ndarray:
        path = f"{self.seg_path}/image_{i:05d}.png"
        if not os.path.exists(path):
            return np.zeros(self.capture_shape, np.uint8)
        return imread(path)

    def get_sky_segmentation(self, i: int) -> np.ndarray:
        """HRNet-layout sky mask: prediction PNG where sky = (180, 130, *)
        RGB. Without one the SkyUNet runs on ``self.device`` and its mask is
        written back as an HRNet-layout PNG, so that reruns read it; without
        a SkyUNet checkpoint the mask is all false."""
        path = f"{self.hrnet_out}/image_{i:05d}_prediction.png"
        if not os.path.exists(path):
            mask = self._infer_sky_segmentation(i)
            if mask is None:
                return np.zeros(self.capture_shape[:2], bool)
            if self.hrnet_out:
                create_if_not_exists(self.hrnet_out)
                vis = np.zeros(mask.shape + (3,), np.uint8)
                vis[mask] = (0, 130, 180)  # BGR for imwrite -> RGB (180,130,0)
                imwrite(path, vis)
            return mask
        w, h = self.capture_size
        img = _resize_nearest(imread(path), w, h)
        # imread returns BGR; HRNet sky color is RGB (180, 130, ...)
        return (img[..., 2] == 180) & (img[..., 1] == 130)

    def _infer_sky_segmentation(self, i: int) -> Optional[np.ndarray]:
        """SkyUNet mask of frame ``i`` from the card (one pull per frame), or
        None without a checkpoint."""
        from mav_detection_tpu_torch.models import pretrained
        from mav_detection_tpu_torch.models.sky_segmentation import sky_mask

        dev = resolve_device(self.device)
        model = pretrained.load_sky(dev)
        if model is None:
            return None
        return sky_mask(model, self.get_frame(i), dev).cpu().numpy()

    def validate_sky_segment(self, sky_mask: np.ndarray,
                             depth: np.ndarray) -> Tuple[float, float]:
        """(TPR, FPR) of a sky mask against the depth rule: sky is where the
        depth exceeds 0.8 of its maximum. Host tensors, like the reference's
        host call."""
        from mav_detection_tpu_torch.ops.image.metrics import calculate_tpr_fpr

        sky_gt = (depth > 0.8 * np.max(depth)).astype(np.uint8) * 255
        tpr, fpr = calculate_tpr_fpr(torch.from_numpy(sky_gt),
                                     torch.from_numpy(sky_mask.astype(np.uint8) * 255))
        return float(tpr), float(fpr)

    def get_depth(self, i: int) -> Optional[np.ndarray]:
        path = f"{self.depth_path}/image_{i:05d}.pfm"
        if not os.path.exists(path):
            return None
        return read_pfm(path)

    def get_gt_foe(self, i: int) -> Optional[Tuple[float, float]]:
        return None

    def get_gt_of(self, i: int) -> Optional[np.ndarray]:
        path = f"{self.gt_of_path}/image_{i:05d}.flo"
        if not os.path.exists(path):
            return None
        return read_flow(path)

    def get_orientation(self, i: int) -> Optional[np.ndarray]:
        return None

    def get_angular_difference(self, first: int, second: int) -> np.ndarray:
        return np.zeros(3)

    def get_time(self, i: int) -> float:
        return float(i) / 30.0

    def get_delta_time(self, i: int) -> float:
        return self.get_time(max(i, 1)) - self.get_time(max(i, 1) - 1)

    def get_state_filenames(self) -> List[str]:
        return []

    def release(self) -> None:
        pass
