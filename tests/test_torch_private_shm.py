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
says so on stderr.

An open of a bus block waits for ever for a block that is not there, as a
module started before its camera must. A port test opens a block through
:func:`opened_within`, which bounds that wait: an open stranded by such a
clean-up, or by a writer that never makes its block, fails the test naming
the clean-up and does not hang it. The tests at the end hold the helpers
themselves, and what a clean-up does to an open.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path
from typing import Callable, Tuple

from torch_cpu_pool import CHILD_ENV  # and torch's CPU pool at one thread

from cuauv_vision_pipeline_tpu_torch.core.bindings.frame_bus import BLOCK_STUB, BlockAccessor

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


OPEN_BOUND_S = 30.0  # an open of blocks that exist returns at once


def returns_within(context, seconds: float) -> bool:
    """Whether ``context.__enter__()``, run on a daemon thread, returns within
    ``seconds`` (re-raising what it raised); a stranded open stays behind
    on its thread."""
    done, raised = threading.Event(), []

    def enter():
        try:
            context.__enter__()
        except BaseException as e:  # raised again in the caller's thread
            raised.append(e)
        done.set()

    threading.Thread(target=enter, daemon=True).start()
    entered = done.wait(seconds)
    if raised:
        raise raised[0]
    return entered


def enter_within(context, seconds: float = OPEN_BOUND_S):
    """``context.__enter__()`` for an open-mode ``BlockAccessor`` (either
    package's) or a module's ``_module_manager``, with the open bounded: it
    retries at 1 Hz for ever for a block that is not there. The caller
    exits it."""
    if not returns_within(context, seconds):
        raise AssertionError(
            f"an open of a bus block did not return in {seconds:g} s: no writer made it, or it was "
            "unlinked after its writer made it, as tests/test_record_replay.py's clean_bus does to "
            "every auv_visiond_* file of a shared /dev/shm")
    return context


@contextlib.contextmanager
def opened_within(context, seconds: float = OPEN_BOUND_S):
    """``with context:``, its open bounded as :func:`enter_within` bounds it."""
    enter_within(context, seconds)
    try:
        yield context
    finally:
        context.__exit__(None, None, None)


# --- the helpers themselves -------------------------------------------------------


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


STRANDED_S = 4.0  # four of an open's 1 Hz retries
_OPEN_CHILD = ("import sys; from cuauv_vision_pipeline_tpu_torch.core.bindings.frame_bus import BlockAccessor; "
               "print('opening', flush=True); BlockAccessor(sys.argv[1]).__enter__()")


def test_clean_bus_strands_an_open_from_another_process_only(unique_direction):
    """What ``clean_bus`` does to an open: a source makes its block at its
    first frame and another test unlinks it. An open in the source's own
    process still returns (the native library hands it the mapping this
    process made, whatever the file), so the in-process module tests cannot
    be stranded this way; an open from another process, as a module
    process's, waits for ever, the source writing on into its unlinked
    mapping. In a /dev/shm of its own, every open with a bound."""
    run_private(stranded_open_scenario, unique_direction, timeout=120)


def stranded_open_scenario(direction: str) -> None:
    from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import Synthetic

    source = Synthetic(direction, width=64, height=36, fps=60)
    thread = threading.Thread(target=source.run_event_loop)
    thread.start()
    block = Path(BLOCK_STUB + direction)
    try:
        deadline = time.monotonic() + 30
        while not block.exists():
            assert time.monotonic() < deadline, "the source never made its block"
            time.sleep(0.01)
        block.unlink()  # what clean_bus does from another worker
        assert returns_within(BlockAccessor(direction), OPEN_BOUND_S), "the source's own process could not open"
        child = subprocess.Popen([sys.executable, "-c", _OPEN_CHILD, direction], cwd=REPO,
                                 env={**os.environ, "PYTHONPATH": str(REPO)},
                                 stdout=subprocess.PIPE, text=True)
        try:
            assert child.stdout.readline().strip() == "opening"
            try:
                child.wait(STRANDED_S)
            except subprocess.TimeoutExpired:
                pass
            assert child.poll() is None, "another process's open returned after the unlink"
        finally:
            child.kill()
            child.communicate()
        assert thread.is_alive() and not block.exists(), "the source stopped, or made its block again"
    finally:
        source.quit_flag.set()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_opened_within_fails_naming_clean_bus(unique_direction):
    """In a child, whose exit ends the open left waiting on its thread."""
    run_private(bounded_open_scenario, unique_direction)


def bounded_open_scenario(direction: str) -> None:
    t0 = time.monotonic()
    try:
        with opened_within(BlockAccessor(direction), seconds=2.0):  # no writer: waits for ever
            raise AssertionError("entered an open whose block no writer made")
    except AssertionError as e:
        assert "clean_bus" in str(e) and "did not return in 2 s" in str(e), str(e)
    assert time.monotonic() - t0 < 10
