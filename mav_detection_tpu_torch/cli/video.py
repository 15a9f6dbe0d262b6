"""Video utility CLI: ``python -m mav_detection_tpu_torch.cli.video <cmd> ...``
(``mav_detection_tpu.cli.video``, copied: ffmpeg argument building, no
framework).

The mp4 recipes of the original project's shell scripts (crop, skip frames,
shorten, PNGs to mp4, frame count, select one frame), parameterized. Every
subcommand prints the exact ffmpeg / ffprobe command it runs; ``--dry-run``
prints without running, which is what the tests pin.
"""
from __future__ import annotations

import argparse
import shlex
import subprocess
import sys
from typing import List, Optional


def _crop(a: argparse.Namespace) -> List[str]:
    # reference crop_mp4.sh: ffmpeg -i in -filter:v "crop=w:h:x:y" out
    return ["ffmpeg", "-y", "-i", a.input, "-filter:v",
            f"crop={a.width}:{a.height}:{a.x}:{a.y}", a.output]


def _skip_frames(a: argparse.Namespace) -> List[str]:
    # reference mp4_skip_frames.sh: keep every Nth frame, compress PTS so
    # playback speed is preserved
    return ["ffmpeg", "-y", "-i", a.input, "-vf",
            f"select='not(mod(n\\,{a.every}))', setpts={1 / a.every}*PTS",
            "-an", a.output]


def _shorten(a: argparse.Namespace) -> List[str]:
    # reference shorten_mp4.sh: stream-copy a [start, start+duration) window
    return ["ffmpeg", "-y", "-ss", a.start, "-i", a.input, "-c", "copy",
            "-t", a.duration, a.output]


def _pngs_to_mp4(a: argparse.Namespace) -> List[str]:
    # reference pngs_to_mp4.sh (and dataset.py:54-55's png->mp4 step)
    return ["ffmpeg", "-y", "-r", str(a.fps), "-i", a.pattern, "-c:v",
            "libx264", "-vf", f"fps={a.fps}", "-pix_fmt", "yuv420p", a.output]


def _frame_count(a: argparse.Namespace) -> List[str]:
    # reference get_mp4_frame_count.sh
    return ["ffprobe", "-v", "error", "-select_streams", "v:0",
            "-count_packets", "-show_entries", "stream=nb_read_packets",
            "-of", "csv=p=0", a.input]


def _select_frame(a: argparse.Namespace) -> List[str]:
    # reference select_frame.sh: extract exactly frame N as a png
    return ["ffmpeg", "-y", "-i", a.input, "-vf",
            f"select='between(n\\,{a.frame}\\,{a.frame})'", "-vsync", "0",
            a.output]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="mav_detection_tpu_torch.cli.video",
        description="mp4 helpers (reference etc/bash/*.sh, parameterized)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the ffmpeg/ffprobe command without running")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("crop", help="crop to a w:h:x:y window")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--x", type=int, default=0)
    p.add_argument("--y", type=int, default=0)
    p.set_defaults(build=_crop)

    p = sub.add_parser("skip-frames", help="keep every Nth frame")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--every", type=int, default=4)
    p.set_defaults(build=_skip_frames)

    p = sub.add_parser("shorten", help="cut a time window (stream copy)")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--start", default="00:00:00.0")
    p.add_argument("--duration", default="00:00:15.0")
    p.set_defaults(build=_shorten)

    p = sub.add_parser("pngs-to-mp4", help="encode an image_%05d.png sequence")
    p.add_argument("pattern", help="e.g. images/image_%%05d.png")
    p.add_argument("output")
    p.add_argument("--fps", type=int, default=30)
    p.set_defaults(build=_pngs_to_mp4)

    p = sub.add_parser("frame-count", help="count packets in the video stream")
    p.add_argument("input")
    p.set_defaults(build=_frame_count)

    p = sub.add_parser("select-frame", help="extract one frame as png")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--frame", type=int, required=True)
    p.set_defaults(build=_select_frame)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cmd = args.build(args)
    print(" ".join(shlex.quote(c) for c in cmd))
    if args.dry_run:
        return 0
    return subprocess.run(cmd).returncode


if __name__ == "__main__":
    sys.exit(main())
