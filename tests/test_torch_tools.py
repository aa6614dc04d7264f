"""The port's last modules against the JAX package's, on the CPU.

* The no-JAX import test (``tests/test_torch_module.py``) walks every
  module of the port: the mesh, the examples, the four manual tools and the
  native build command among them.
* ``misc.image_ordering_test`` writes its color cycle on a direction of
  this test's own; the port's reader and the JAX package's
  ``BlockAccessor`` read the same frames back (one wire format).
* ``misc.webcam_latency_test`` reads that direction and prints a latency
  per frame.
* ``misc.log_fixer`` and ``misc.diffmovies`` parse their arguments and,
  with no ffmpeg/ffplay on the PATH, report it as the JAX tools do.
"""

import os
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path

import numpy as np
import pytest
from test_torch_private_shm import opened_within
from torch_cpu_pool import CHILD_ENV  # and torch's CPU pool at one thread

from cuauv_vision_pipeline_tpu.core.bindings.frame_bus import BlockAccessor as JBlockAccessor
from cuauv_vision_pipeline_tpu.core.bindings.frame_bus import ReadStatus as JReadStatus
from cuauv_vision_pipeline_tpu.misc import diffmovies as jdiffmovies
from cuauv_vision_pipeline_tpu.misc import log_fixer as jlog_fixer
from cuauv_vision_pipeline_tpu_torch.core.bindings.frame_bus import BLOCK_STUB, BlockAccessor, ReadStatus
from cuauv_vision_pipeline_tpu_torch.misc import diffmovies, image_ordering_test, log_fixer, webcam_latency_test

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "cuauv_vision_pipeline_tpu_torch"
NEW_MODULES = ["parallel/mesh.py", "examples/multichip_fanout.py", "examples/quickstart.py",
               "misc/image_ordering_test.py", "misc/webcam_latency_test.py", "misc/log_fixer.py",
               "misc/diffmovies.py", "native/__main__.py"]


@pytest.mark.parametrize("name", NEW_MODULES)
def test_import_test_walks_the_new_module(name):
    """tests/test_torch_module.py imports every ``*.py`` of the port but
    ``__init__.py`` in a fresh process and fails on any JAX import."""
    assert (PORT / name).exists()
    assert (PORT / name) in set(PORT.rglob("*.py"))


def _writer(direction, frames, hz):
    thread = threading.Thread(target=image_ordering_test.main,
                              args=([direction, "--hz", str(hz), "--frames", str(frames)],))
    thread.start()
    return thread


def _wait_for_block(direction, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not Path(BLOCK_STUB + direction).exists():
        assert time.monotonic() < deadline, "the color cycle's block never appeared"
        time.sleep(0.02)


def test_image_ordering_cycle_reads_the_same_in_both_packages(capsys):
    direction = f"torch_tools_{uuid.uuid4().hex[:8]}"
    colors = [tuple(c) for c in image_ordering_test.COLORS]
    writer = _writer(direction, 12, 10.0)
    seen = {"port": {}, "jax": {}}
    try:
        _wait_for_block(direction)
        with opened_within(BlockAccessor(direction)) as ours, opened_within(JBlockAccessor(direction)) as theirs:
            deadline = time.monotonic() + 10
            while writer.is_alive() and time.monotonic() < deadline:
                for key, acc, success in (("port", ours, ReadStatus.SUCCESS), ("jax", theirs, JReadStatus.SUCCESS)):
                    status, frame, acq = acc.read_frame()
                    if status == success:
                        frame = np.asarray(frame)
                        assert frame.shape == (240, 320, 3) and frame.dtype == np.uint8
                        first = tuple(int(v) for v in frame[0, 0])
                        assert (frame == frame[0, 0]).all() and first in colors
                        seen[key][acq] = first
                time.sleep(0.01)
    finally:
        writer.join(timeout=30)
    both = set(seen["port"]) & set(seen["jax"])
    assert len(both) >= 3, seen
    assert all(seen["port"][t] == seen["jax"][t] for t in both)
    # in the cycle's order: each frame's color follows the one before it
    order = [colors.index(seen["port"][t]) for t in sorted(seen["port"])]
    steps = [(b - a) % len(colors) for a, b in zip(order, order[1:])]
    assert all(s >= 1 for s in steps), order
    assert f"writing color cycle to '{direction}' at 10.0 Hz" in capsys.readouterr().out
    assert not Path(BLOCK_STUB + direction).exists()  # the writer's exit removed its block


def test_webcam_latency_reads_the_cycle(capsys):
    direction = f"torch_tools_{uuid.uuid4().hex[:8]}"
    writer = _writer(direction, 15, 10.0)
    try:
        _wait_for_block(direction)
        webcam_latency_test.main([direction, "--seconds", "0.8"])
    finally:
        writer.join(timeout=30)
    out = capsys.readouterr().out
    assert "latency:" in out and "avg over" in out


def _no_ffmpeg(monkeypatch, tmp_path):
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.delenv("DISPLAY", raising=False)


def test_log_fixer_without_ffmpeg_reports_as_jax(tmp_path, monkeypatch, capsys):
    logs = tmp_path / "logs"
    (logs / "day1").mkdir(parents=True)
    for name in ("a.mp4", "day1/b.avi", "notes.txt"):
        (logs / name).write_bytes(b"\x00" * 64)
    _no_ffmpeg(monkeypatch, tmp_path)
    log_fixer.main([str(logs), "--jobs", "2"])
    ours = capsys.readouterr().out
    jlog_fixer.main([str(logs), "--jobs", "2"])
    theirs = capsys.readouterr().out
    assert sorted(ours.splitlines()) == sorted(theirs.splitlines())
    assert ours.splitlines() == ["FAILED   ffmpeg not installed"] * 2
    log_fixer.main([str(tmp_path / "bin")])
    assert capsys.readouterr().out == "no videos found\n"
    with pytest.raises(SystemExit):
        log_fixer.main([])


def test_diffmovies_without_a_display_reports_as_jax(tmp_path, monkeypatch, capsys):
    _no_ffmpeg(monkeypatch, tmp_path)
    for tool in (diffmovies, jdiffmovies):
        with pytest.raises(SystemExit) as exit_:
            tool.main(["a.mp4", "b.mp4"])
        assert exit_.value.code == 1
        assert capsys.readouterr().err == "no display/ffplay; use --out diff.mp4 to write the diff\n"
    # --out without ffmpeg: the port says so and exits 1
    with pytest.raises(SystemExit) as exit_:
        diffmovies.main(["a.mp4", "b.mp4", "--out", str(tmp_path / "d.mp4")])
    assert exit_.value.code == 1 and capsys.readouterr().err == "ffmpeg not installed\n"
    with pytest.raises(SystemExit):
        diffmovies.main(["only_one.mp4"])


def test_tools_run_as_modules():
    for tool in ("image_ordering_test", "webcam_latency_test", "log_fixer", "diffmovies"):
        proc = subprocess.run([sys.executable, "-m", f"cuauv_vision_pipeline_tpu_torch.misc.{tool}", "--help"],
                              cwd=REPO, capture_output=True, text=True, timeout=60,
                              env={**os.environ, **CHILD_ENV})
        assert proc.returncode == 0 and "usage:" in proc.stdout, proc.stderr
