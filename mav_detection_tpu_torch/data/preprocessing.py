"""Idempotent sequence preprocessing (host-side): a copy of
``mav_detection_tpu.data.preprocessing`` over the port's PNG codec.

mp4 -> png extraction, index renormalization, png -> mp4 assembly,
half-resolution copies, all skip-if-exists and ffmpeg-gated as in the
reference. One step diverges by design: ``jpgs_to_pngs`` needs a JPEG
decoder, which the port lacks (its codec reads and writes PNG only), so it
raises on a directory that holds ``.jpg`` frames instead of converting them.

Also carries the auxiliary capture-source helpers (KITTI / Cenek-Albl path
conventions).
"""
from __future__ import annotations

import glob
import os
import re
import shutil
import subprocess
from typing import Tuple

from mav_detection_tpu_torch.data.dataset import create_if_not_exists, imread, imwrite, sorted_glob


def _have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def video_to_images(video_path: str, img_pattern: str) -> bool:
    """mp4 -> image_%5d.png via ffmpeg; False without ffmpeg."""
    out_dir = os.path.dirname(img_pattern)
    create_if_not_exists(out_dir)
    if glob.glob(os.path.join(out_dir, "image_*.png")):
        return True
    if not _have_ffmpeg():
        return False
    subprocess.call(["ffmpeg", "-loglevel", "error", "-i", video_path, img_pattern])
    return True


def images_to_video(img_pattern: str, video_path: str, framerate: int = 30) -> bool:
    """image sequence -> mp4; False without ffmpeg or frames."""
    if os.path.exists(video_path):
        return True
    if not _have_ffmpeg():
        return False
    imgs = sorted_glob(os.path.join(os.path.dirname(img_pattern), "image_*.png"))
    if not imgs:
        return False
    m = re.search(r"image_(\d+)", os.path.basename(imgs[0]))
    start = m.group(1) if m else "0"
    subprocess.call([
        "ffmpeg", "-loglevel", "error", "-start_number", start,
        "-r", str(framerate), "-i", img_pattern,
        "-c:v", "libx264", "-vf", f"fps={framerate}", "-pix_fmt", "yuv420p",
        video_path, "-y"])
    return os.path.exists(video_path)


def jpgs_to_pngs(img_dir: str) -> int:
    """Returns 0 for a directory without ``.jpg`` frames; raises
    ``NotImplementedError`` for one with them, since converting them needs a
    JPEG decoder."""
    jpgs = sorted_glob(os.path.join(img_dir, "*.jpg"))
    if jpgs:
        raise NotImplementedError(
            f"{img_dir} holds {len(jpgs)} .jpg frames: jpgs_to_pngs would "
            "convert them to image_%05d.png, but the port has no JPEG decoder "
            "(its image codec reads and writes PNG only); convert them to PNG "
            "beforehand")
    return 0


def renormalize_indices(base_dir: str) -> int:
    """Rename image_* files so indices start at 0 and are contiguous."""
    files = sorted_glob(os.path.join(base_dir, "image_*"))
    moved = 0
    for i, path in enumerate(files):
        ext = os.path.splitext(path)[1]
        target = os.path.join(base_dir, f"image_{i:05d}{ext}")
        if os.path.abspath(path) != os.path.abspath(target):
            shutil.move(path, target)
            moved += 1
    return moved


def create_half_res_images(img_dir: str, out_dir: str) -> int:
    """50%-scale copies for the sky-segmentation model, skip-if-exists."""
    create_if_not_exists(out_dir)
    written = 0
    for src in sorted_glob(os.path.join(img_dir, "image_*.png")):
        dst = os.path.join(out_dir, os.path.basename(src))
        if os.path.exists(dst):
            continue
        img = imread(src)
        half = img[::2, ::2]
        imwrite(dst, half)
        written += 1
    return written


# ------------------------------------------------- auxiliary capture paths
def get_kitti_image_dir(sequence: str) -> str:
    """KITTI odometry grayscale layout."""
    kitti = os.environ["KITTI_PATH"]
    return f"{kitti}/data_odometry_gray/dataset/sequences/{sequence}/image_0"


def get_cenek_paths(sequence: str, camera: int) -> Tuple[str, str]:
    """Cenek-Albl et al. drone-detection dataset layout."""
    base = os.environ["CENEK_PATH"]
    return (f"{base}/{sequence}/{camera}.mp4",
            f"{base}/{sequence}/detections/{camera}.txt")
