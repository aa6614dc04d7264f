"""What a run must not do: load JAX or the JAX package, or leave files in
/dev/shm."""

from __future__ import annotations

import os
import sys
from typing import Iterable, List, Set

# top-level module names that may not be loaded in a run's process; the
# port's own name begins with the JAX package's, so names are compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "cuauv_vision_pipeline_tpu")

SHM_DIR = "/dev/shm"


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name (the part before the first
    dot) is one of FORBIDDEN, compared whole."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def shm_entries() -> Set[str]:
    try:
        return set(os.listdir(SHM_DIR))
    except FileNotFoundError:
        return set()


def shm_left(before: Set[str]) -> List[str]:
    """Entries of /dev/shm that were not there when the run began."""
    return sorted(shm_entries() - before)
