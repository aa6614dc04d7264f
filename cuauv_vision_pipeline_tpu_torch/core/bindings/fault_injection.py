"""Writer-side fault injection for the frame bus.

The reference has no way to rehearse camera/transport failures — its
robustness was only ever exercised by real hardware acting up.  This gives
the bus a deterministic fault model, enabled by environment variable so
ANY capture source or module can be soak-tested unmodified:

    CUAUV_BUS_FAULTS="drop=0.1,corrupt=0.05,delay_ms=15,stall_every=200,stall_ms=500,seed=7"

Faults are applied in ``BlockAccessor.write_frame`` before the seqlock
write, i.e. they model the *producer* (camera/DMA/driver) misbehaving —
never the bus itself, whose torn-read/crash guarantees are tested
separately (tests/test_frame_bus.py, test_frame_bus_crash.py):

* ``drop``        — probability a frame is silently never written
                    (camera frame loss); the writer sees SUCCESS.
* ``corrupt``     — probability the payload of one plane gets a burst of
                    flipped bytes (DMA/sensor glitch). Downstream code
                    must tolerate garbage PIXELS; headers stay valid.
* ``delay_ms``    — fixed extra latency per write (slow link).
* ``stall_every`` / ``stall_ms`` — every Nth write stalls for the given
                    time (driver hiccup / GC pause), testing latest-wins
                    catch-up in readers.
* ``seed``        — RNG seed; same plan + seed => same fault sequence.

All state is per-accessor; disabled (the default, no env var) costs one
``is None`` check per write.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np


class FaultPlan:
    """Parsed fault configuration + RNG state for one bus writer."""

    __slots__ = (
        "drop", "corrupt", "delay_ms", "stall_every", "stall_ms",
        "_rng", "_writes", "counters",
    )

    def __init__(
        self,
        drop: float = 0.0,
        corrupt: float = 0.0,
        delay_ms: float = 0.0,
        stall_every: int = 0,
        stall_ms: float = 0.0,
        seed: int = 0,
    ):
        self.drop = float(drop)
        self.corrupt = float(corrupt)
        self.delay_ms = float(delay_ms)
        self.stall_every = int(stall_every)
        self.stall_ms = float(stall_ms)
        self._rng = np.random.default_rng(int(seed))
        self._writes = 0
        self.counters = {"dropped": 0, "corrupted": 0, "stalled": 0}

    @classmethod
    def from_env(cls, env: str = "CUAUV_BUS_FAULTS") -> Optional["FaultPlan"]:
        spec = os.environ.get(env, "").strip()
        return cls.parse(spec) if spec else None

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse "k=v,k=v" — unknown keys raise (catching typos beats
        silently fault-free soak runs)."""
        kwargs = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, value = part.partition("=")
            key = key.strip()
            if key not in (
                "drop", "corrupt", "delay_ms", "stall_every", "stall_ms",
                "seed",
            ):
                raise ValueError(f"unknown bus fault '{key}' in '{spec}'")
            kwargs[key] = float(value)
        return cls(**kwargs)

    def apply_write(
        self, planes: List[np.ndarray]
    ) -> Optional[List[np.ndarray]]:
        """Apply the plan to one outgoing frame.

        Returns the (possibly corrupted) plane list, or None when the
        frame should be dropped.  May sleep (delay/stall)."""
        self._writes += 1
        if self.delay_ms > 0:
            time.sleep(self.delay_ms / 1000.0)
        if self.stall_every > 0 and self._writes % self.stall_every == 0:
            self.counters["stalled"] += 1
            time.sleep(self.stall_ms / 1000.0)
        if self.drop > 0 and self._rng.random() < self.drop:
            self.counters["dropped"] += 1
            return None
        if self.corrupt > 0 and self._rng.random() < self.corrupt:
            self.counters["corrupted"] += 1
            idx = int(self._rng.integers(len(planes)))
            plane = np.array(planes[idx])  # copy; never corrupt caller data
            flat = plane.reshape(-1).view(np.uint8)
            burst = int(self._rng.integers(1, max(2, flat.size // 64)))
            start = int(self._rng.integers(max(1, flat.size - burst)))
            flat[start:start + burst] ^= 0xFF
            planes = list(planes)
            planes[idx] = plane
        return planes
