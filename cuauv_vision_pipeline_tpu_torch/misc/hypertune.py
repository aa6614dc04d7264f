#!/usr/bin/env python3
"""Offline parameter sweeps: run a module class over a directory of images.

Parity target: reference misc/hypertune.py (broken against the current
reference core, SURVEY.md §2.7); this version works against the rebuilt
framework: it instantiates a module class by reflection, feeds it every
image in a directory through a private frame-bus block, and collects the
posted outputs per tuner configuration — the offline harness for threshold
sweeps.

Port of ``cuauv_vision_pipeline_tpu.misc.hypertune``:
``run_module_over_images`` runs the module on ``device`` (its ``--device``;
the module's default, cuda:0, when none is given).

    python -m cuauv_vision_pipeline_tpu_torch.misc.hypertune red_buoy:BuoyLAB DIR --sweep thresh_min=100,140
"""

from __future__ import annotations

import argparse
import importlib
import itertools
import threading
import time
import uuid
from typing import Dict, Iterable, List

import numpy as np

from ..capture_sources.image_directory import load_images
from ..core.bindings.frame_bus import BlockAccessor, frame_bytes


def run_module_over_images(
    module_cls,
    images: List[np.ndarray],
    tuners: List,
    tuner_values: Dict[str, object],
    fps: int = 100,
    device=None,
) -> Dict[str, List[np.ndarray]]:
    """Run one module over the images with fixed tuner values; returns the
    posts it produced keyed by post name. ``device`` is passed as the
    module's ``--device`` (None: the module's default, cuda:0)."""
    direction = f"hypertune_{uuid.uuid4().hex[:8]}"
    posts: Dict[str, List[np.ndarray]] = {}

    for t in tuners:
        if t.name in tuner_values:
            t._current_value = tuner_values[t.name]

    argv = [] if device is None else ["--device", str(device)]
    module = module_cls([direction], tuners, fps=fps, argv=argv)
    captured = module.post

    def capture_post(name, image, color_space="BGR"):
        posts.setdefault(name, []).append(np.array(image, copy=True))
        captured(name, image, color_space)

    module.post = capture_post

    # Modules dispatch on @sources / @device_fn plane aliases (e.g.
    # red_buoy wants 'forward' and 'normal'); write each image once per
    # alias so every handler fires. Alias-free modules get one anonymous
    # plane.
    aliases: List[str] = []
    for attr in dir(module):
        fn = getattr(module, attr, None)
        for alias in getattr(fn, "_sources_aliases", ()) or ():
            if alias not in aliases:
                aliases.append(alias)
        for alias in getattr(fn, "_device_fn_aliases", ()) or ():
            if alias not in aliases:
                aliases.append(alias)

    def payload(img):
        if not aliases:
            return img
        return tuple((a, img) for a in aliases)

    n_planes = max(1, len(aliases))
    size = frame_bytes(
        *((images[0].shape, images[0].dtype) for _ in range(n_planes))
    )
    with BlockAccessor(direction, size) as writer:
        quit_flag = threading.Event()
        from ..core.log import log

        with module._module_manager:
            thread = threading.Thread(
                target=module._loop, args=(quit_flag, log.hypertune)
            )
            thread.start()
            for img in images:
                writer.write_frame(int(time.monotonic() * 1000), payload(img))
                time.sleep(1.0 / fps)
            time.sleep(0.2)
            quit_flag.set()
            thread.join(timeout=10)
    return posts


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="module parameter sweep")
    parser.add_argument("module", help="e.g. red_buoy:BuoyLAB")
    parser.add_argument("image_dir")
    parser.add_argument(
        "--sweep",
        action="append",
        default=[],
        help="tuner sweep spec name=v1,v2,v3 (repeatable)",
    )
    args = parser.parse_args(argv)

    mod_name, cls_name = args.module.split(":")
    module_pkg = importlib.import_module(
        f"cuauv_vision_pipeline_tpu_torch.modules.{mod_name}"
    )
    module_cls = getattr(module_pkg, cls_name)
    tuners = getattr(module_pkg, "module_tuners", [])

    sweeps: Dict[str, Iterable] = {}
    for spec in args.sweep:
        name, values = spec.split("=")
        sweeps[name] = [eval(v) for v in values.split(",")]

    images = load_images(args.image_dir)
    keys = list(sweeps)
    combos = list(itertools.product(*sweeps.values())) if keys else [()]
    for combo in combos:
        values = dict(zip(keys, combo))
        posts = run_module_over_images(module_cls, images, tuners, values)
        summary = {k: len(v) for k, v in posts.items()}
        print(f"tuners={values} posts={summary}")


if __name__ == "__main__":
    main()
