"""The topology soak of ``tests/test_soak.py`` on the port, on the CPU:
the synthetic ZED source under bus fault injection, ``modules.red_buoy``
and ``modules.yolo`` (pico fixture) with ``--device cpu``; liveness, the
source stopped and restarted at 40 %, recovery, bounded RSS, clean SIGINT
exits and no leaked module block (``tests/soak_topology.py``).

Opt in with the soak's seconds, as for the JAX soak:

    CUAUV_SOAK_S=60 JAX_PLATFORMS=cpu python -m pytest -m soak tests/test_torch_soak.py

It runs in a /dev/shm of its own (``run_private``), so neither another
test's clean-up nor a bus of the machine's shares its blocks. Each module
keeps torch's CPU pool to one thread (``run_private`` gives it
``CHILD_ENV``): at its default (a thread per core) on a loaded host every
small op's thread barrier waits on descheduled threads. ``chip_smoke.py``'s ``soak`` phase
runs the same topology on cuda:0.
"""

import json
import os
import uuid
from pathlib import Path

import pytest
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from test_torch_private_shm import run_private


def soak_scenario(seconds: float, log_dir: str) -> None:
    from soak_topology import run_soak

    os.environ["CUAUV_SHM_NAMESPACE"] = f"torch-soak-{uuid.uuid4().hex[:8]}"
    counters = run_soak(seconds, "cpu", Path(log_dir), f"torch_soak_{uuid.uuid4().hex[:8]}",
                        env={"CUAUV_TPU_DEVICE": "cpu"})
    print("SOAK_RESULT " + json.dumps(counters))


@pytest.mark.soak
def test_topology_soak_liveness_memory_recovery(tmp_path):
    if "CUAUV_SOAK_S" not in os.environ:
        pytest.skip("soak tier: opt in with CUAUV_SOAK_S=<seconds> (minutes of two module processes)")
    seconds = float(os.environ["CUAUV_SOAK_S"])
    proc = run_private(soak_scenario, seconds, str(tmp_path), timeout=seconds * 2 + 900)
    counters = json.loads(proc.stdout.split("SOAK_RESULT ", 1)[1].splitlines()[0])
    print(f"\nSOAK_COUNTERS {json.dumps(counters)}")
    assert counters["source_kills"] == 1 and counters["recovery_s"] is not None
