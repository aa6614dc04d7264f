#!/usr/bin/env python3
"""Side-by-side / diff playback of two recorded videos.

Port of ``cuauv_vision_pipeline_tpu.misc.diffmovies`` (a host tool: no
device work). Parity target: reference misc/diffmovies.sh — an ffplay
overlay diff of raw vs compressed pool-test videos. This version shells out
to ffplay when a display exists, or writes a diff video with ffmpeg
(``--out``); without them it says so and exits 1.

    python -m cuauv_vision_pipeline_tpu_torch.misc.diffmovies A B [--out diff.mp4]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="diff two videos")
    parser.add_argument("a")
    parser.add_argument("b")
    parser.add_argument(
        "--out", default="", help="write blend-difference video here instead "
        "of playing"
    )
    args = parser.parse_args(argv)

    filter_graph = (
        "[0:v][1:v]blend=all_mode=difference,hue=s=0,eq=gamma=1.7[d]"
    )
    if args.out:
        cmd = [
            "ffmpeg", "-y", "-i", args.a, "-i", args.b,
            "-filter_complex", filter_graph, "-map", "[d]", args.out,
        ]
    else:
        if not os.environ.get("DISPLAY") or not shutil.which("ffplay"):
            print(
                "no display/ffplay; use --out diff.mp4 to write the diff",
                file=sys.stderr,
            )
            sys.exit(1)
        cmd = [
            "ffplay", "-f", "lavfi",
            f"movie={args.a}[a];movie={args.b}[b];"
            "[a][b]blend=all_mode=difference,hue=s=0,eq=gamma=1.7",
        ]
    try:
        sys.exit(subprocess.run(cmd).returncode)
    except FileNotFoundError:
        print(f"{cmd[0]} not installed", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
