"""The port's frame-bus binding (ctypes) and its writer-side fault injection,
held to the JAX package's bus tests and against the JAX binding (cffi).

Ports of ``tests/test_frame_bus.py`` (latest-wins, NO_NEW_FRAME,
FRAMEWORK_DELETED, planes and dtypes, blocking reads, no torn reads under a
concurrent writer or across processes), ``tests/test_frame_bus_crash.py``
(a writer SIGKILLed mid-stream, then recovery) and
``tests/test_frame_bus_faults.py`` (the ``CUAUV_BUS_FAULTS`` plan, drop,
corrupt, a faulty writer SIGKILLed and restarted). Cases that cross the two
packages are parametrised by writer and reader (``port-jax`` = a port writer
read by the JAX binding): both sit on the same native bus, so a block
written by either holds the same bytes and reads the same in the other, and
the same plan and seed give the same fault sequence.

The writer processes import the port's binding alone (no torch, no jax), so
the crash and faulty-writer cases take a few seconds. They, and the
cross-process case, hold their block for seconds and run in a /dev/shm of
their own (``run_private``): ``tests/test_record_replay.py``'s ``clean_bus``
unlinks every ``auv_visiond_*`` file from other workers.
"""

import contextlib
import importlib
import os
import signal
import subprocess
import sys
import threading
import time
import types
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch.core.bindings.fault_injection import FaultPlan
from cuauv_vision_pipeline_tpu_torch.core.bindings.frame_bus import (
    BLOCK_STUB,
    BlockAccessor,
    ReadStatus,
    WriteStatus,
    frame_bytes,
)
from test_torch_private_shm import run_private

REPO = Path(__file__).resolve().parents[1]
# the two bindings of one native bus; the JAX one is imported where a case
# reads or writes with it (a private child pays the jax import only then)
PACKAGES = {"port": "cuauv_vision_pipeline_tpu_torch", "jax": "cuauv_vision_pipeline_tpu"}
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]
PAIR_IDS = ["-".join(p) for p in PAIRS]
FAULTS_ENV = "CUAUV_BUS_FAULTS"


def binding(package: str) -> types.ModuleType:
    return importlib.import_module(f"{PACKAGES[package]}.core.bindings.frame_bus")


def faults_module(package: str) -> types.ModuleType:
    return importlib.import_module(f"{PACKAGES[package]}.core.bindings.fault_injection")


def fresh_direction() -> str:
    return f"test_torch_{uuid.uuid4().hex[:12]}"


@contextlib.contextmanager
def writer_and_reader(pair, direction, size):
    """A create-mode writer of ``pair[0]``'s binding and a reader of
    ``pair[1]``'s: the writer itself when both are one package (as the JAX
    tests read), else an open-mode accessor of the other binding."""
    with binding(pair[0]).BlockAccessor(direction, size) as writer:
        if pair[0] == pair[1]:
            yield writer, writer
        else:
            with binding(pair[1]).BlockAccessor(direction) as reader:
                yield writer, reader


# --- tests/test_frame_bus.py on the port's binding ------------------------------


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_create_write_read_roundtrip(unique_direction, pair):
    img = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    with writer_and_reader(pair, unique_direction, img.nbytes) as (writer, reader):
        assert writer.write_frame(123, img).name == "SUCCESS"
        status, data, t = reader.read_frame()
        assert status.name == "SUCCESS"
        assert t == 123
        np.testing.assert_array_equal(data, img)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_no_new_frame_after_consume(unique_direction, pair):
    img = np.zeros((4, 4, 1), dtype=np.uint8)
    with writer_and_reader(pair, unique_direction, img.nbytes) as (writer, reader):
        writer.write_frame(1, img)
        status, _, _ = reader.read_frame()
        assert status.name == "SUCCESS"
        status, _, _ = reader.read_frame()
        assert status.name == "NO_NEW_FRAME"


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_latest_wins(unique_direction, pair):
    """Multiple writes between reads: the reader sees only the newest frame."""
    img = np.zeros((8, 8), dtype=np.uint8)
    with writer_and_reader(pair, unique_direction, img.nbytes) as (writer, reader):
        for i in range(10):
            writer.write_frame(i, np.full((8, 8), i, dtype=np.uint8))
        status, data, t = reader.read_frame()
        assert status.name == "SUCCESS"
        assert t == 9
        assert data.flat[0] == 9


def test_empty_block_has_no_frame(unique_direction):
    with BlockAccessor(unique_direction, 64) as block:
        status, data, _ = block.read_frame()
        assert status == ReadStatus.NO_NEW_FRAME
        assert data is None


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_multi_plane_names_and_dtypes(unique_direction, pair):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (6, 8, 3), dtype=np.uint8)
    depth = rng.random((6, 8, 1)).astype(np.float32)
    normal = rng.random((6, 8, 3)).astype(np.float64)
    size = frame_bytes(
        (rgb.shape, np.uint8), (depth.shape, np.float32), (normal.shape, np.float64)
    )
    with writer_and_reader(pair, unique_direction, size) as (writer, reader):
        writer.write_frame(5, [("rgb", rgb), ("depth", depth), ("normal", normal)])
        status, data, t = reader.read_frame()
        assert status.name == "SUCCESS"
        assert isinstance(data, tuple) and len(data) == 3
        for got, want in zip(data, (rgb, depth, normal)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert reader.last_plane_names() == ("rgb", "depth", "normal")


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_half_dtype_plane(unique_direction, pair):
    """2-byte element planes (f16/bf16 payloads)."""
    half = np.random.default_rng(1).random((4, 4, 1)).astype(np.float16)
    with writer_and_reader(pair, unique_direction, frame_bytes((half.shape, np.float16))) as (writer, reader):
        writer.write_frame(1, half)
        status, data, _ = reader.read_frame()
        assert status.name == "SUCCESS"
        assert data.dtype == np.float16
        np.testing.assert_array_equal(data, half)


def test_open_mode_sees_creator_frames(unique_direction):
    img = np.random.default_rng(2).integers(0, 255, (5, 7, 3), dtype=np.uint8)
    with BlockAccessor(unique_direction, img.nbytes) as writer:
        writer.write_frame(77, img)
        with BlockAccessor(unique_direction) as reader:
            status, data, t = reader.read_frame()
            assert status == ReadStatus.SUCCESS
            assert t == 77
            np.testing.assert_array_equal(data, img)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_framework_deleted_propagates(unique_direction, pair):
    img = np.zeros((4, 4), dtype=np.uint8)
    writer = binding(pair[0]).BlockAccessor(unique_direction, img.nbytes)
    writer.__enter__()
    writer.write_frame(1, img)
    reader = binding(pair[1]).BlockAccessor(unique_direction)
    reader.__enter__()
    status, _, _ = reader.read_frame()
    assert status.name == "SUCCESS"
    writer.__exit__(None, None, None)  # creator teardown
    status, _, _ = reader.read_frame()
    assert status.name == "FRAMEWORK_DELETED"
    reader.__exit__(None, None, None)


def test_write_too_large_raises(unique_direction):
    with BlockAccessor(unique_direction, 16) as block:
        with pytest.raises(RuntimeError):
            block.write_frame(0, np.zeros((64, 64), dtype=np.uint8))


def test_returned_views_are_writable(unique_direction):
    """Staging reads hand out writable arrays: no defensive copy needed."""
    img = np.zeros((4, 4, 3), dtype=np.uint8)
    with BlockAccessor(unique_direction, img.nbytes) as block:
        block.write_frame(0, img)
        _, data, _ = block.read_frame()
        data[:] = 7  # must not raise
        assert (data == 7).all()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_blocking_read_wakes_on_write(unique_direction, pair):
    img = np.full((4, 4), 3, dtype=np.uint8)
    with binding(pair[0]).BlockAccessor(unique_direction, img.nbytes) as writer:

        def delayed_write():
            time.sleep(0.15)
            writer.write_frame(42, img)

        with binding(pair[1]).BlockAccessor(unique_direction, block_thread=True) as reader:
            t = threading.Thread(target=delayed_write)
            t.start()
            start = time.monotonic()
            status, data, acq = reader.read_frame()
            waited = time.monotonic() - start
            t.join(timeout=10)
            assert not t.is_alive()
            assert status.name == "SUCCESS"
            assert acq == 42
            assert 0.05 < waited < 1.0  # woke on publish, not on timeout


def test_blocking_read_times_out(unique_direction):
    with BlockAccessor(unique_direction, 64) as writer:  # noqa: F841
        with BlockAccessor(unique_direction, block_thread=True) as reader:
            start = time.monotonic()
            status, _, _ = reader.read_frame()
            waited = time.monotonic() - start
            assert status == ReadStatus.NO_NEW_FRAME
            assert waited >= 0.9  # ~1 s timeout like the reference


class _HammerWriter(threading.Thread):
    """Writes recognizable frames as fast as possible."""

    def __init__(self, accessor, n_writes, shape):
        super().__init__()
        self.accessor = accessor
        self.n_writes = n_writes
        self.shape = shape

    def run(self):
        for i in range(1, self.n_writes + 1):
            frame = np.full(self.shape, i % 251, dtype=np.uint8)
            self.accessor.write_frame(i, frame)
            if i % 50 == 0:
                time.sleep(0.001)  # let the GIL-bound reader sample the stream


def check_frame(data, t, last_t, strictly=True):
    """A read frame is whole (every byte from one write, the byte encoding
    its stamp) and no older than the last one."""
    assert (data == data.flat[0]).all(), "torn frame detected"
    assert data.flat[0] == t % 251
    assert t > last_t if strictly else t >= last_t, (t, last_t)
    return t


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_seqlock_no_torn_reads_under_concurrent_writer(unique_direction, pair):
    """Every successful read returns a frame whose bytes all come from one
    write, while a writer thread hammers the ring."""
    shape = (64, 64, 3)
    with binding(pair[0]).BlockAccessor(unique_direction, int(np.prod(shape))) as writer:
        with binding(pair[1]).BlockAccessor(unique_direction) as reader:
            w = _HammerWriter(writer, 2000, shape)
            w.start()
            seen = 0
            last_t = 0
            while w.is_alive() or seen == 0:
                status, data, t = reader.read_frame()
                if status.name == "SUCCESS":
                    seen += 1
                    last_t = check_frame(data, t, last_t)
            w.join(timeout=30)
            assert not w.is_alive()
            assert seen > 10  # the reader actually sampled the stream


def test_block_file_uses_reference_prefix(unique_direction):
    with BlockAccessor(unique_direction, 64):
        assert os.path.exists(BLOCK_STUB + unique_direction)
    assert not os.path.exists(BLOCK_STUB + unique_direction)


def zed_like_frames(n: int, seed: int):
    """``n`` seeded 4-plane frames of one layout (u8 BGR, f32 depth, f64
    normals, an f16 plane): the planes a ZED source writes, at a toy size."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield [("forward", rng.integers(0, 256, (6, 10, 3), dtype=np.uint8)),
               ("depth", rng.random((6, 10, 1)).astype(np.float32)),
               ("normal", rng.random((6, 10, 3))),
               ("half", rng.random((3, 4)).astype(np.float16))]


@pytest.mark.parametrize("faults", ["", "drop=0.3,corrupt=0.5,seed=4"], ids=["clean", "faulty"])
def test_block_bytes_equal_across_packages(monkeypatch, faults):
    """The same frames written through each binding (with the same fault
    plan) leave the same block bytes: header, slot headers, plane names,
    dtypes and payload; each reads back in the other binding as written."""
    if faults:
        monkeypatch.setenv(FAULTS_ENV, faults)
    else:
        monkeypatch.delenv(FAULTS_ENV, raising=False)
    frames = list(zed_like_frames(10, seed=3))
    size = frame_bytes(*[(a.shape, a.dtype) for _, a in frames[0]])
    directions = {pkg: fresh_direction() for pkg in PACKAGES}
    files = {}
    with contextlib.ExitStack() as stack:
        writers = {pkg: stack.enter_context(binding(pkg).BlockAccessor(d, size)) for pkg, d in directions.items()}
        readers = {pkg: stack.enter_context(binding(other).BlockAccessor(directions[pkg]))
                   for pkg, other in (("port", "jax"), ("jax", "port"))}
        reads = {pkg: [] for pkg in PACKAGES}
        for i, frame in enumerate(frames):
            for pkg in PACKAGES:
                assert writers[pkg].write_frame(100 + i, frame).name == "SUCCESS"
                status, data, t = readers[pkg].read_frame()
                reads[pkg].append((status.name, t, readers[pkg].last_plane_names(),
                                   None if status.name != "SUCCESS" else [(a.dtype.str, a.shape, a.tobytes())
                                                                        for a in data]))
        for pkg, d in directions.items():
            files[pkg] = Path(BLOCK_STUB + d).read_bytes()
        assert writers["port"].latest_uid == writers["jax"].latest_uid
    assert files["port"] == files["jax"]
    assert reads["port"] == reads["jax"]
    for (status, t, names, planes), frame in zip(reads["port"], frames):
        if status != "SUCCESS":
            assert faults  # a dropped frame
            continue
        assert names == ("forward", "depth", "normal", "half")
        for (dtype, shape, raw), (_, want) in zip(planes, frame):
            assert np.dtype(dtype) == want.dtype and shape[:want.ndim] == want.shape
            if not faults:
                assert raw == want.tobytes()
    if not faults:
        assert all(status == "SUCCESS" for status, *_ in reads["port"])


# --- the writer processes ---------------------------------------------------------

# a writer of the port's binding alone (no torch, no jax): frames whose every
# byte is the stamp mod 251, stamps from START + 1 upward, PAUSE s between writes
_WRITER = r"""
import ctypes, os, signal, sys, time
import numpy as np
# die with the parent: a hard-killed run must not leak producers
# that keep writing into /dev/shm (PR_SET_PDEATHSIG = 1)
ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL, 0, 0, 0)
if os.getppid() == 1:
    sys.exit(0)
from cuauv_vision_pipeline_tpu_torch.core.bindings.frame_bus import BlockAccessor
direction, shape, start, pause = sys.argv[1], tuple(map(int, sys.argv[2].split("x"))), int(sys.argv[3]), float(sys.argv[4])
with BlockAccessor(direction, int(np.prod(shape))) as block:
    i = start
    while True:
        i += 1
        block.write_frame(i, np.full(shape, i % 251, np.uint8))
        if pause:
            time.sleep(pause)
"""


def spawn_writer(direction: str, shape, start: int, pause: float, env=None, stderr=None) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", _WRITER, direction, "x".join(map(str, shape)), str(start), str(pause)],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO), **(env or {})}, stderr=stderr)


def cross_process_scenario(reader_package: str) -> None:
    """In a private /dev/shm: a writer process, a blocking reader of
    ``reader_package`` in this one; 50 whole, newer frames."""
    direction = fresh_direction()
    shape = (32, 32, 3)
    proc = spawn_writer(direction, shape, 0, 0.0005)
    try:
        with binding(reader_package).BlockAccessor(direction, block_thread=True) as reader:
            seen = 0
            last_t = 0
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and seen < 50:
                status, data, t = reader.read_frame()
                if status.name == "SUCCESS":
                    seen += 1
                    last_t = check_frame(data, t, last_t)
                elif status.name == "FRAMEWORK_DELETED":
                    break
            assert seen >= 50, seen
    finally:
        proc.terminate()
        assert proc.wait(timeout=30) == -signal.SIGTERM


@pytest.mark.parametrize("reader", list(PACKAGES))
def test_cross_process_no_torn_reads(reader):
    """The same property across a process boundary (capture process ->
    module process), read by either binding."""
    run_private(cross_process_scenario, reader, timeout=120)


# --- tests/test_frame_bus_crash.py on the port's binding -------------------------

CRASH_SHAPE = (64, 96, 3)


def crash_scenario(reader_package: str) -> None:
    """Four writer generations, each SIGKILLed mid-stream: the reader of
    ``reader_package`` gets 25 whole, newer frames from every generation."""
    direction = fresh_direction()
    # keep the block alive across writer generations so the name persists
    with BlockAccessor(direction, int(np.prod(CRASH_SHAPE))):
        with binding(reader_package).BlockAccessor(direction) as reader:
            total_seen = 0
            last_t = 0
            for generation in range(4):
                proc = spawn_writer(direction, CRASH_SHAPE, generation * 1_000_000, 0.0)
                deadline = time.monotonic() + 20
                seen = 0
                while time.monotonic() < deadline and seen < 25:
                    status, data, t = reader.read_frame()
                    if status.name == "SUCCESS":
                        last_t = check_frame(data, t, last_t)
                        seen += 1
                assert seen >= 25, f"generation {generation}: bus wedged"
                total_seen += seen
                # SIGKILL mid-write: no cleanup
                os.kill(proc.pid, signal.SIGKILL)
                proc.wait(timeout=10)
            assert total_seen >= 100
    print(f"crash: {total_seen} frames over 4 generations")


@pytest.mark.parametrize("reader", list(PACKAGES))
def test_writer_sigkill_mid_stream_then_recovery(reader):
    """A SIGKILLed writer leaves a slot's seqlock odd; the next writer heals
    it, and a reader of either binding keeps getting whole frames."""
    run_private(crash_scenario, reader, timeout=120)


# --- tests/test_frame_bus_faults.py on the port's binding ------------------------


def test_parse_plan_and_unknown_key():
    plan = FaultPlan.parse("drop=0.25, corrupt=0.1, delay_ms=5, seed=9")
    assert plan.drop == 0.25 and plan.corrupt == 0.1 and plan.delay_ms == 5
    with pytest.raises(ValueError, match="unknown bus fault 'dorp'"):
        FaultPlan.parse("dorp=0.5")


def test_plan_determinism():
    a, b = FaultPlan.parse("drop=0.5,seed=3"), FaultPlan.parse("drop=0.5,seed=3")
    planes = [np.zeros(16, np.uint8)]
    seq_a = [a.apply_write(planes) is None for _ in range(50)]
    seq_b = [b.apply_write(planes) is None for _ in range(50)]
    assert seq_a == seq_b and any(seq_a) and not all(seq_a)


SOAK_FAULTS = "drop=0.02,corrupt=0.01,stall_every=400,stall_ms=250,seed=11"


@pytest.mark.parametrize("spec", [
    SOAK_FAULTS,
    "drop=0.5,seed=3",
    "drop=0.2,corrupt=0.1,stall_every=100,stall_ms=50,seed=3",
    "corrupt=0.4,drop=0.1,delay_ms=2,stall_every=7,stall_ms=9,seed=5",
])
def test_fault_sequence_equal_across_packages(monkeypatch, spec):
    """The same plan and seed drop, corrupt (the same bytes of the same
    plane) and stall (for the same time) the same writes in both packages'
    ``FaultPlan``; the caller's planes are never touched."""
    sequences = {}
    for package in PACKAGES:
        module = faults_module(package)
        sleeps = []
        monkeypatch.setattr(module, "time", types.SimpleNamespace(sleep=sleeps.append))
        plan = module.FaultPlan.parse(spec)
        rng = np.random.default_rng(17)
        planes = [rng.integers(0, 256, (12, 16, 3), dtype=np.uint8), rng.random((12, 16, 1)).astype(np.float32)]
        before = [p.copy() for p in planes]
        outs = []
        for _ in range(1200):
            out = plan.apply_write(planes)
            outs.append(None if out is None else [p.tobytes() for p in out])
        assert all(np.array_equal(p, q) for p, q in zip(planes, before))
        sequences[package] = (outs, sleeps, dict(plan.counters))
    assert sequences["port"] == sequences["jax"]
    outs, sleeps, counters = sequences["port"]
    assert counters["dropped"] == sum(o is None for o in outs) > 0
    clean = [p.tobytes() for p in before]
    assert counters["corrupted"] == sum(o is not None and o != clean for o in outs)
    assert counters["stalled"] == (1200 // FaultPlan.parse(spec).stall_every if "stall_every" in spec else 0)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_drop_all_writes_nothing(unique_direction, monkeypatch, pair):
    monkeypatch.setenv(FAULTS_ENV, "drop=1.0")
    img = np.full((4, 4), 7, np.uint8)
    with writer_and_reader(pair, unique_direction, img.nbytes) as (writer, reader):
        assert writer.write_frame(1, img).name == "SUCCESS"
        status, *_ = reader.read_frame()
        assert status.name == "NO_NEW_FRAME"
        assert writer._faults.counters["dropped"] == 1


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_corrupt_damages_payload_not_headers(unique_direction, monkeypatch, pair):
    monkeypatch.setenv(FAULTS_ENV, "corrupt=1.0,seed=1")
    img = np.zeros((32, 32), np.uint8)
    with writer_and_reader(pair, unique_direction, img.nbytes) as (writer, reader):
        writer.write_frame(5, img)
        status, data, t = reader.read_frame()
        assert status.name == "SUCCESS"
        assert t == 5
        assert data.reshape(img.shape).dtype == img.dtype  # header intact
        assert data.shape == (32, 32, 1)
        assert data.any()  # the burst flipped some zero bytes
        assert not img.any()  # caller's array untouched


def test_caller_sees_no_faults_when_env_unset(unique_direction, monkeypatch):
    monkeypatch.delenv(FAULTS_ENV, raising=False)
    img = np.arange(16, dtype=np.uint8)
    with BlockAccessor(unique_direction, img.nbytes) as block:
        assert block._faults is None
        assert block.write_frame(2, img) == WriteStatus.SUCCESS
        status, data, _ = block.read_frame()
        assert status == ReadStatus.SUCCESS
        np.testing.assert_array_equal(data.ravel(), img)


def faulty_writer_scenario(reader_package: str, log_dir: str) -> None:
    """A faulty producer (drop + corrupt + stall) is SIGKILLed mid-run and
    restarted; the reader of ``reader_package`` keeps valid headers and
    non-decreasing stamps, and spots corrupted payloads by content."""
    direction = fresh_direction()
    env = {FAULTS_ENV: "drop=0.2,corrupt=0.1,stall_every=100,stall_ms=50,seed=3"}
    errlog = open(Path(log_dir) / "writer.err", "wb")
    writer = spawn_writer(direction, (4096,), 999, 0.001, env=env, stderr=errlog)
    try:
        with binding(reader_package).BlockAccessor(direction, 4096, block_thread=True) as reader:
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:  # until frames flow
                status, *_ = reader.read_frame()  # blocks <= 1 s (futex timeout)
                if status.name == "SUCCESS":
                    break
            else:
                raise AssertionError("no frames from the faulty writer within 20 s: "
                                     + (Path(log_dir) / "writer.err").read_text()[-500:])
            stats = {"frames": 0, "corrupted": 0}
            last_t = 0

            def drain(seconds):
                nonlocal last_t
                end = time.monotonic() + seconds
                while time.monotonic() < end:
                    status, data, t = reader.read_frame()  # <= 1 s block
                    if status.name != "SUCCESS":
                        continue
                    assert t >= last_t, "timestamps went backwards"
                    last_t = t
                    data = data.ravel()
                    assert data.size == 4096 and data.dtype == np.uint8
                    stats["frames"] += 1
                    if not (data == data[0]).all():
                        stats["corrupted"] += 1

            drain(2.0)
            os.kill(writer.pid, signal.SIGKILL)  # the producer dies mid-stream
            writer.wait(timeout=10)
            time.sleep(0.2)
            writer = spawn_writer(direction, (4096,), 999, 0.001, env=env, stderr=errlog)  # and comes back
            last_t = 0  # the new producer generation restarts its stamps
            drain(2.0)
    finally:
        writer.kill()
        writer.wait(timeout=10)
        errlog.close()
    assert stats["frames"] > 100, f"soak starved: {stats}"
    assert stats["corrupted"] > 0, "corrupt=0.1 never materialized"
    # corruption is bounded: bursts hit a strict subset of frames
    assert stats["corrupted"] < stats["frames"] / 2, stats
    print(f"faulty writer: {stats}")


@pytest.mark.parametrize("reader", list(PACKAGES))
def test_soak_faulty_writer_sigkill_recovery(reader, tmp_path):
    run_private(faulty_writer_scenario, reader, str(tmp_path), timeout=120)
