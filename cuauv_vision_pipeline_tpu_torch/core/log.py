"""Hierarchical logger — in-repo replacement for the external ``auvlog``.

The reference imports ``auvlog.client.Logger`` / ``log`` everywhere
(reference core/base.py:27, core/capture_source.py:19) but the package lives
outside the repo (SURVEY.md §1 external deps). This module provides the same
usage surface:

    from cuauv_vision_pipeline_tpu_torch.core.log import Logger, log
    logger = log.vision.capture_source.MySource     # attribute chaining
    logger("message", True)                          # True => echo to stdout

Records go to stderr (always) and optionally to ``$CUAUV_LOG/current/`` files
when that directory exists (matching module_toggler's log-dir contract,
reference core/module_toggler.py:98-106).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from pathlib import Path
from typing import Optional

_lock = threading.Lock()


def _log_dir() -> Optional[Path]:
    root = os.environ.get("CUAUV_LOG")
    if not root:
        return None
    path = Path(root) / "current"
    return path if path.is_dir() else None


class Logger:
    """A named logger. Calling it records a message; attribute access
    creates a child logger with a dotted name."""

    def __init__(self, name: str = "log"):
        self._name = name

    def __getattr__(self, child: str) -> "Logger":
        if child.startswith("__"):
            raise AttributeError(child)
        return Logger(f"{self._name}.{child}")

    def __call__(self, message: str, copy_to_stdout: bool = False) -> None:
        stamp = time.strftime("%H:%M:%S")
        line = f"[{stamp}] {self._name}: {message}"
        with _lock:
            print(line, file=sys.stderr, flush=True)
            if copy_to_stdout:
                print(line, flush=True)
            log_dir = _log_dir()
            if log_dir is not None:
                try:
                    with open(log_dir / "vision.log", "a") as fh:
                        fh.write(line + "\n")
                except OSError:
                    pass

    @property
    def name(self) -> str:
        return self._name


log = Logger()
