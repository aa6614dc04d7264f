"""Run a test's scenario in a /dev/shm of its own.

``tests/test_record_replay.py``'s ``clean_bus`` fixture (and
``tests/test_soak.py``) unlink every ``auv_visiond_*`` and ``auv_shm_*`` file
in /dev/shm, from whichever xdist worker runs them. A test that starts a
module and polls a group loses to that: a module that opens its source's
bus block after the unlink waits for it for ever ("trying again to access"),
and a reader can hold the mapping of a file that no writer writes any more.

:func:`run_private` runs a module-level function of a test module in a
child Python inside a mount namespace of its own (``unshare --user
--map-root-user --mount``, or ``--mount`` alone where user namespaces are
off) with a fresh tmpfs on /dev/shm: the child and every process it starts
see only their own bus blocks and groups, and no other test sees theirs.
Where the kernel grants neither, the child runs on the shared /dev/shm and
says so on stderr. The tests at the end hold the helper itself.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import uuid
from pathlib import Path
from typing import Callable, Tuple

from torch_cpu_pool import CHILD_ENV  # and torch's CPU pool at one thread

REPO = Path(__file__).resolve().parents[1]
SHM_DIR = "/dev/shm"
# mount a tmpfs on /dev/shm, then run the command given after the script
_MOUNT = ("sh", "-c", 'mount -t tmpfs -o mode=1777 private-shm /dev/shm && exec "$@"', "private-shm")
_CHILD = ("import importlib, json, sys; "
          "getattr(importlib.import_module(sys.argv[1]), sys.argv[2])(*json.loads(sys.argv[3]))")


@functools.lru_cache(maxsize=None)
def namespace_prefix() -> Tuple[str, ...]:
    """The command prefix that gives what follows a private /dev/shm, or ()
    where this machine allows none."""
    for unshare in (("unshare", "--user", "--map-root-user", "--mount"), ("unshare", "--mount")):
        try:
            if subprocess.run([*unshare, *_MOUNT, "true"], capture_output=True, timeout=30).returncode == 0:
                return (*unshare, *_MOUNT)
        except (OSError, subprocess.TimeoutExpired):
            continue
    return ()


def run_private(fn: Callable, *args, timeout: float = 240.0) -> subprocess.CompletedProcess:
    """``fn(*args)`` (JSON arguments) in a child Python with a /dev/shm of
    its own and torch's CPU pool at one thread (``CHILD_ENV``, inherited by
    every process it starts); an AssertionError carrying the child's output
    if it fails."""
    prefix = namespace_prefix()
    if not prefix:
        print("run_private: no mount namespace here; the child shares /dev/shm", file=sys.stderr)
    tests = str(Path(__file__).resolve().parent)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO), tests]), **CHILD_ENV}
    proc = subprocess.run([*prefix, sys.executable, "-c", _CHILD, fn.__module__, fn.__name__, json.dumps(args)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (f"{fn.__name__} failed in its child (rc {proc.returncode}):\n"
                                  f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    return proc


# --- the helper itself -----------------------------------------------------------


def _child_sees(name: str, mine: str) -> None:
    """In the child: the parent's file is not there; this one is made."""
    assert not os.path.exists(os.path.join(SHM_DIR, name)), f"the child sees {name}"
    Path(SHM_DIR, mine).write_bytes(b"child")
    print(f"made {mine}")


def _child_fails(message: str) -> None:
    raise AssertionError(message)


def test_child_has_a_dev_shm_of_its_own():
    key = uuid.uuid4().hex[:12]
    parent, child = f"auv_visiond_privtest_{key}", f"auv_shm_privtest_{key}"
    Path(SHM_DIR, parent).write_bytes(b"parent")
    try:
        assert namespace_prefix(), "this machine allows no private /dev/shm"
        proc = run_private(_child_sees, parent, child)
        assert f"made {child}" in proc.stdout
        assert not os.path.exists(os.path.join(SHM_DIR, child))
        assert Path(SHM_DIR, parent).read_bytes() == b"parent"
    finally:
        os.unlink(os.path.join(SHM_DIR, parent))


def test_a_failing_child_reports_its_traceback():
    message = f"boom {uuid.uuid4().hex[:8]}"
    try:
        run_private(_child_fails, message)
    except AssertionError as e:
        assert message in str(e) and "_child_fails" in str(e)
    else:
        raise AssertionError("a failing child passed")
