#!/usr/bin/env python3
"""Generate (or delete) per-class YOLO result groups in the shm store.

Parity target: reference misc/yolo_shm.py:59-94 (installed as auv-yolo-shm)
— reads a weight file's class names and creates a ``yolo_<class>`` group
per class with angle/area/center/confidence/visible/bbox fields; --delete
removes them. The reference code-generated libshm's vars.conf; our shm
store takes schemas directly.

Port of ``cuauv_vision_pipeline_tpu.misc.yolo_shm``: a ``.pt`` checkpoint's
names come through the port's own reader (``models/yolo/weights.py``).

    python -m cuauv_vision_pipeline_tpu_torch.misc.yolo_shm WEIGHT [--delete]
"""

from __future__ import annotations

import argparse
import json
from typing import List

from ..core import shm

FIELDS = {
    "visible": "bool",
    "confidence": "float",
    "angle": "float",
    "area": "float",
    "center_x": "float",
    "center_y": "float",
    "min_x": "float",
    "min_y": "float",
    "max_x": "float",
    "max_y": "float",
}


def class_names_from_weight(path: str) -> List[str]:
    """Extract class names from a checkpoint (.msgpack sidecar or .pt)."""
    if path.endswith(".pt"):
        from ..models.yolo.weights import load_checkpoint

        names = load_checkpoint(path)[1]["names"]
        if not names:
            raise ValueError(f"no class names found in {path}")
        return list(names)
    with open(path + ".json") as fh:
        meta = json.load(fh)
    names = meta.get("names")
    if not names:
        raise ValueError(f"no class names in {path}.json")
    return list(names)


def create_groups(names: List[str]) -> None:
    for name in names:
        group = f"yolo_{name}".replace("-", "_")
        shm.define_group(group, dict(FIELDS))
        print(f"created shm group {group}")


def delete_groups(names: List[str]) -> None:
    for name in names:
        group = f"yolo_{name}".replace("-", "_")
        shm.delete_group(group)
        print(f"deleted shm group {group}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="generate yolo_<class> shm groups")
    parser.add_argument("weight", help="checkpoint path (.msgpack or .pt)")
    parser.add_argument("--delete", action="store_true")
    args = parser.parse_args(argv)
    names = class_names_from_weight(args.weight)
    if args.delete:
        delete_groups(names)
    else:
        create_groups(names)


if __name__ == "__main__":
    main()
