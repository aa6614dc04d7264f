#!/usr/bin/env python3
"""Module toggler daemon: shm flags -> module subprocess lifecycle.

Port of ``cuauv_vision_pipeline_tpu.core.module_toggler`` (reference
core/module_toggler.py:33-264): for each ``(module, source)`` in the vehicle
config, watch the shm flag ``<module>_on_<source>``; on change, diff
should-run vs running, start new modules as subprocesses
(``python -m cuauv_vision_pipeline_tpu_torch.modules.<module> <source>``,
plus ``--device N`` from ``vehicle.module_devices``) in their own process
group with logs under ``$CUAUV_LOG/current``, stop removed ones with
SIGTERM -> 5 s -> SIGKILL on the group, and reap crashed processes. The
``vision_modules`` flag group has the JAX toggler's name, fields and types,
so either toggler acts on the same flags.

    python -m cuauv_vision_pipeline_tpu_torch.core.module_toggler
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional

from . import shm
from .config import vehicle


@dataclass
class ModuleProcess:
    name: str
    source: str
    process: subprocess.Popen
    log_name: str


class ModuleToggler:
    """Manages vision modules based on shm toggle flags."""

    STOP_GRACE_S = 5.0

    def __init__(self) -> None:
        print("[INFO] Initializing ModuleToggler")
        self.running: Dict[str, ModuleProcess] = {}
        self.vehicle_config = vehicle.vision_modules
        print(
            f"[INFO] Loaded vehicle config with modules: "
            f"{list(self.vehicle_config.keys())}"
        )
        self._ensure_flags()

    # -- flags ---------------------------------------------------------------

    @staticmethod
    def _flag_name(module: str, source: str) -> str:
        return f"{module}_on_{source}".replace("-", "_")

    def _ensure_flags(self) -> None:
        """Define the vision_modules group with one flag per pair."""
        schema = {
            self._flag_name(m, s): ["bool", False]
            for m, sources in self.vehicle_config.items()
            for s in sources
        }
        if schema:
            existing = shm.group("vision_modules", schema)
            missing = set(schema) - set(existing.field_names())
            if missing:
                # schema evolved: recreate with the union
                union = {f: ["bool", False] for f in set(schema) | set(existing.field_names())}
                shm.delete_group("vision_modules")
                shm.define_group("vision_modules", union)

    def _enabled(self, module: str, source: str) -> bool:
        flags = shm.vision_modules
        name = self._flag_name(module, source)
        if name not in flags.field_names():
            return False
        return bool(flags.get_field(name))

    # -- lifecycle -------------------------------------------------------------

    @staticmethod
    def _key(module: str, source: str) -> str:
        return f"{module}_{source}"

    def _module_argv(self, module: str, source: str) -> Optional[list]:
        argv = [
            sys.executable,
            "-m",
            f"cuauv_vision_pipeline_tpu_torch.modules.{module}",
            source,
        ]
        device = vehicle.module_devices.get(module, {}).get(source)
        if device is not None:
            argv += ["--device", str(device)]
        return argv

    def _start(self, module: str, source: str) -> bool:
        key = self._key(module, source)
        if key in self.running:
            return True
        argv = self._module_argv(module, source)
        log_name = f"{module}@{source}-module"
        log_dir = os.path.join(os.environ.get("CUAUV_LOG", "/tmp"), "current")
        os.makedirs(log_dir, exist_ok=True)
        log_file = open(os.path.join(log_dir, f"{log_name}.log"), "a")
        stamp = time.strftime("%Y/%m/%d %H:%M:%S UTC", time.gmtime())
        log_file.write(f"Starting {' '.join(argv)} at {stamp}\n")
        log_file.flush()
        try:
            # start_new_session: the module gets its own process group, so
            # _stop signals it and every process it started
            process = subprocess.Popen(
                argv,
                stdout=log_file,
                stderr=subprocess.STDOUT,
                start_new_session=True,
            )
        except OSError as e:
            print(f"[ERROR] Failed to start {module} {source}: {e}")
            return False
        finally:
            log_file.close()  # the child holds its own descriptor
        self.running[key] = ModuleProcess(module, source, process, log_name)
        print(f"[INFO] Started: {module} {source}")
        return True

    def _stop(self, module: str, source: str) -> bool:
        key = self._key(module, source)
        entry = self.running.pop(key, None)
        if entry is None:
            return True
        try:
            pgid = os.getpgid(entry.process.pid)
            os.killpg(pgid, signal.SIGTERM)
            try:
                entry.process.wait(timeout=self.STOP_GRACE_S)
            except subprocess.TimeoutExpired:
                os.killpg(pgid, signal.SIGKILL)
                entry.process.wait(timeout=2)
        except ProcessLookupError:
            pass
        print(f"[INFO] Stopped: {module} {source}")
        return True

    def _reap(self) -> None:
        for key in list(self.running):
            entry = self.running[key]
            if entry.process.poll() is not None:
                print(
                    f"[WARN] Module died: {entry.name} {entry.source} "
                    f"(rc={entry.process.returncode})"
                )
                del self.running[key]

    def sync(self) -> None:
        """Diff should-run vs running; start/stop accordingly."""
        self._reap()
        should_run = {
            self._key(m, s): (m, s)
            for m, sources in self.vehicle_config.items()
            for s in sources
            if self._enabled(m, s)
        }
        for key, (m, s) in should_run.items():
            if key not in self.running:
                self._start(m, s)
        for key in list(self.running):
            if key not in should_run:
                entry = self.running[key]
                self._stop(entry.name, entry.source)

    def run_forever(self) -> None:
        watcher = shm.watchers.watcher()
        watcher.watch(shm.vision_modules)
        self.sync()
        try:
            while True:
                watcher.wait(new_update=True, timeout=1.0)
                self.sync()
        except KeyboardInterrupt:
            print("[INFO] shutting down; stopping all modules")
            for key in list(self.running):
                entry = self.running[key]
                self._stop(entry.name, entry.source)


def main() -> None:
    ModuleToggler().run_forever()


if __name__ == "__main__":
    main()
