#!/usr/bin/env python3
"""Batch re-mux of recorded mission logs.

Port of ``cuauv_vision_pipeline_tpu.misc.log_fixer`` (a host tool: no
device work). Parity target: reference misc/log_fixer.py — a threaded
ffmpeg/ffprobe pool that re-encodes recorded videos so seeking works after
an unclean shutdown. Without ffmpeg each video reports
``FAILED   ffmpeg not installed``.

    python -m cuauv_vision_pipeline_tpu_torch.misc.log_fixer DIRECTORY [--force] [--jobs 4]
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

VIDEO_EXTS = {".mp4", ".avi", ".mkv", ".mov"}


def probe_ok(path: Path) -> bool:
    """True if ffprobe can fully read the file."""
    try:
        result = subprocess.run(
            ["ffprobe", "-v", "error", str(path)],
            capture_output=True,
            timeout=60,
        )
        return result.returncode == 0 and not result.stderr
    except (subprocess.TimeoutExpired, FileNotFoundError):
        return False


def fix_one(path: Path, force: bool = False) -> str:
    if not force and probe_ok(path):
        return f"ok       {path}"
    tmp = path.with_suffix(".fixed" + path.suffix)
    try:
        result = subprocess.run(
            [
                "ffmpeg", "-y", "-v", "error",
                "-i", str(path),
                "-c", "copy", "-movflags", "+faststart",
                str(tmp),
            ],
            capture_output=True,
            timeout=600,
        )
        if result.returncode != 0:
            tmp.unlink(missing_ok=True)
            return f"FAILED   {path}: {result.stderr.decode()[:200]}"
        shutil.move(str(tmp), str(path))
        return f"fixed    {path}"
    except FileNotFoundError:
        return "FAILED   ffmpeg not installed"
    except subprocess.TimeoutExpired:
        tmp.unlink(missing_ok=True)
        return f"TIMEOUT  {path}"


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="re-mux recorded logs")
    parser.add_argument("directory")
    parser.add_argument("--force", action="store_true", help="re-mux everything")
    parser.add_argument("--jobs", type=int, default=4)
    args = parser.parse_args(argv)

    videos = [
        p
        for p in Path(args.directory).rglob("*")
        if p.suffix.lower() in VIDEO_EXTS
    ]
    if not videos:
        print("no videos found")
        return
    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        for line in pool.map(lambda p: fix_one(p, args.force), videos):
            print(line)


if __name__ == "__main__":
    main()
