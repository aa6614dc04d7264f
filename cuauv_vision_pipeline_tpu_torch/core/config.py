"""Vehicle configuration (the reference's external ``conf.vehicle``).

Port of ``cuauv_vision_pipeline_tpu.core.config``: the same file format,
defaults and attributes. The reference imports ``conf.vehicle`` for its
camera list and the ``vision_modules`` map consumed by the module toggler
(reference core/module_toggler.py:42-47, capture_sources/*, SURVEY.md §5
config). This in-repo equivalent reads a YAML file from
``$CUAUV_VEHICLE_CONFIG`` (or the bundled default) and exposes the same
attributes.

Example vehicle.yaml:

    cameras:
      zed:
        type: zed
        fps: 10
      forward:
        type: flir
        serial: "12345"
        width: 1600
        height: 1100
        fps: 15
    vision_modules:
      red_buoy: [zed]
      yolo: [zed]
      gate: [forward]
    module_devices:        # optional: pin module@source to cuda:N
      yolo:
        zed: 0
      red_buoy:
        zed: 1
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List

_DEFAULT_CONFIG: Dict[str, Any] = {
    "cameras": {
        "zed": {"type": "zed", "fps": 10},
    },
    "vision_modules": {
        "red_buoy": ["zed"],
        "gate": ["zed"],
        "bins": ["zed"],
        "yolo": ["zed"],
        "poster": ["zed"],
    },
}


def _load() -> Dict[str, Any]:
    path = os.environ.get("CUAUV_VEHICLE_CONFIG")
    if not path:
        bundled = Path(__file__).resolve().parent.parent / "configs" / "vehicle.yaml"
        path = str(bundled) if bundled.exists() else ""
    if path and os.path.exists(path):
        try:
            import yaml

            with open(path) as fh:
                loaded = yaml.safe_load(fh) or {}
            return {**_DEFAULT_CONFIG, **loaded}
        except Exception as e:  # config errors must not kill the daemon
            print(f"[config] failed to load {path}: {e}; using defaults")
    return dict(_DEFAULT_CONFIG)


class _Vehicle:
    def __init__(self) -> None:
        data = _load()
        self.cameras: Dict[str, Dict[str, Any]] = data.get("cameras", {})
        self.vision_modules: Dict[str, List[str]] = {
            name: list(sources)
            for name, sources in data.get("vision_modules", {}).items()
        }
        # module -> {source -> CUDA ordinal} (multi-card hosts pin each
        # module process to one card; see ModuleBase --device)
        self.module_devices: Dict[str, Dict[str, int]] = {
            name: {src: int(dev) for src, dev in (mapping or {}).items()}
            for name, mapping in data.get("module_devices", {}).items()
        }


vehicle = _Vehicle()
