"""Typed shared-memory variable store with watchers.

In-repo replacement for the vehicle-wide ``shm``/``libshm`` store the
reference imports everywhere but does not contain (SURVEY.md §1 external
deps: ``import shm`` in modules/red_buoy.py:9, watchers in
core/module_toggler.py:217-245, result groups in every handler).

Design: each *group* is a small mmap'd file ``/dev/shm/auv_shm_<group>``
holding a seqlock word plus little-endian packed fields. The schema (field
names, types, defaults) is embedded in the file header as JSON, so any
process that opens a group learns its layout — no global vars.conf needed.
Groups used by the in-tree modules are pre-declared in DEFAULT_GROUPS and
auto-created on first access; new groups (e.g. per-YOLO-class result groups
generated by misc/yolo_shm.py, reference misc/yolo_shm.py:59-94) are created
with :func:`define_group`.

Usage (same shapes as the reference's libshm Python API):

    from cuauv_vision_pipeline_tpu_torch.core import shm
    shm.red_buoy_results.center_x.set(0.25)
    x = shm.red_buoy_results.center_x.get()
    g = shm.red_buoy_results.get()          # snapshot namespace
    shm.red_buoy_results.set(g)             # write a full snapshot back

    w = shm.watchers.watcher()
    w.watch(shm.vision_modules)
    w.wait(new_update=True)                 # blocks until any write
"""

from __future__ import annotations

import fcntl
import json
import mmap
import os
import struct
import sys
import threading
import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

SHM_STUB = "/dev/shm/auv_shm_"
NAMESPACE_ENV = "CUAUV_SHM_NAMESPACE"
_MAGIC = b"AUVSHM1\x00"
_HEADER_FMT = "<8sQI"  # magic, seq, schema_len
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)
_SEQ_OFF = 8

_TYPE_FMT = {
    "int": "q",
    "float": "d",
    "bool": "B",
    "string": "64s",
}
_TYPE_DEFAULT: Dict[str, Any] = {
    "int": 0,
    "float": 0.0,
    "bool": False,
    "string": "",
}


def group_path(name: str) -> str:
    """The backing file of group ``name``. With ``CUAUV_SHM_NAMESPACE=<ns>``
    set when the group is first opened, the file is ``auv_shm_<name>@<ns>``:
    runs that must not share results (two checkouts on one machine, a test
    next to a live module) each get their own groups, byte layout unchanged."""
    namespace = os.environ.get(NAMESPACE_ENV, "")
    return SHM_STUB + name + (f"@{namespace}" if namespace else "")


def _coerce(type_name: str, value: Any) -> Any:
    if type_name == "int":
        return int(value)
    if type_name == "float":
        return float(value)
    if type_name == "bool":
        return bool(value)
    if type_name == "string":
        return str(value)
    raise ValueError(f"unknown shm field type {type_name}")


class FieldAccessor:
    """Accessor for one field of a group: ``.get()`` / ``.set(value)``."""

    def __init__(self, group: "Group", name: str):
        self._group = group
        self._name = name

    def get(self) -> Any:
        return self._group.get_field(self._name)

    def set(self, value: Any) -> None:
        self._group.set_field(self._name, value)

    def __repr__(self) -> str:
        return f"FieldAccessor({self._group.name}.{self._name}={self.get()!r})"


class Group:
    """One shared group of typed fields, backed by a /dev/shm file."""

    def __init__(self, name: str, schema: Optional[Dict[str, Any]] = None):
        self._name = name
        self._path = group_path(name)
        # RLock: writers hold it across _maybe_reattach (which also takes
        # it) so field offsets can't go stale between reattach and write
        self._lock = threading.RLock()
        self._mm: Optional[mmap.mmap] = None
        self._fields: List[Tuple[str, str]] = []  # (name, type)
        self._defaults: Dict[str, Any] = {}
        self._offsets: Dict[str, Tuple[int, str]] = {}
        self._data_off = 0
        self._declared_schema = schema
        self._ino = -1
        self._last_stat = 0.0
        self._attach_or_create(schema)

    # -- lifecycle ---------------------------------------------------------

    def _attach_or_create(self, schema: Optional[Dict[str, Any]]) -> None:
        fd = os.open(self._path, os.O_RDWR | os.O_CREAT, 0o666)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            size = os.fstat(fd).st_size
            if size >= _HEADER_SIZE:
                header = os.pread(fd, _HEADER_SIZE, 0)
                magic, _seq, schema_len = struct.unpack(_HEADER_FMT, header)
                if magic == _MAGIC:
                    raw = os.pread(fd, schema_len, _HEADER_SIZE)
                    # json.loads preserves the serialized key order (py3.7+
                    # dicts), so attachers derive the exact offsets the
                    # creator wrote.
                    on_disk = json.loads(raw.decode())
                    declared = (
                        schema
                        if schema is not None
                        else DEFAULT_GROUPS.get(self._name)
                    )
                    if declared is None or set(declared) <= set(on_disk):
                        self._load_schema(on_disk, blob_len=schema_len)
                        self._map(fd)
                        return
                    # Declared schema grew since this file was created
                    # (e.g. a new telemetry field after an upgrade):
                    # replace with a fresh inode. Processes still mapping
                    # the old inode keep a frozen-but-valid view; truncating
                    # in place would SIGBUS them. They re-attach within
                    # ~0.5 s via the st_ino re-stat in _maybe_reattach.
                    print(
                        f"[shm] group '{self._name}': declared schema grew "
                        f"({sorted(set(declared) - set(on_disk))}); replacing "
                        "the live group file — attached processes re-stat "
                        "and re-attach on their next access",
                        file=sys.stderr,
                    )
                    fcntl.flock(fd, fcntl.LOCK_UN)
                    os.close(fd)
                    fd = -1
                    try:
                        os.unlink(self._path)
                    except FileNotFoundError:
                        pass  # concurrent upgrader got there first
                    return self._attach_or_create(schema)
            # Fresh (or corrupt) file: initialize from the given schema.
            if schema is None:
                schema = DEFAULT_GROUPS.get(self._name)
            if schema is None:
                raise KeyError(
                    f"shm group '{self._name}' does not exist and has no "
                    f"declared schema; use shm.define_group()"
                )
            # Canonical on-disk field order = schema insertion order. Never
            # sort: the creator's offsets and every attacher's offsets must
            # both come from the byte order of this blob.
            blob = json.dumps(schema).encode()
            self._load_schema(schema, blob_len=len(blob))
            payload_fmt = "".join(
                _TYPE_FMT[t] for _, t in self._fields
            )
            data_size = struct.calcsize("<" + payload_fmt) if self._fields else 0
            total = _HEADER_SIZE + len(blob) + data_size
            os.ftruncate(fd, total)
            os.pwrite(fd, struct.pack(_HEADER_FMT, _MAGIC, 0, len(blob)), 0)
            os.pwrite(fd, blob, _HEADER_SIZE)
            # defaults
            defaults = bytearray()
            for fname, ftype in self._fields:
                value = self._defaults[fname]
                if ftype == "string":
                    value = str(value).encode()[:64].ljust(64, b"\x00")
                    defaults += value
                else:
                    defaults += struct.pack("<" + _TYPE_FMT[ftype], value)
            os.pwrite(fd, bytes(defaults), _HEADER_SIZE + len(blob))
            self._map(fd)
        finally:
            if fd >= 0:
                fcntl.flock(fd, fcntl.LOCK_UN)
                os.close(fd)

    def _load_schema(self, schema: Dict[str, Any], blob_len: Optional[int] = None) -> None:
        self._fields = []
        self._defaults = {}
        for fname, spec in schema.items():
            if isinstance(spec, (list, tuple)):
                ftype, default = spec[0], spec[1]
            else:
                ftype, default = spec, _TYPE_DEFAULT[spec]
            if ftype not in _TYPE_FMT:
                raise ValueError(f"unknown shm field type {ftype}")
            self._fields.append((fname, ftype))
            self._defaults[fname] = default
        if blob_len is None:
            blob_len = len(json.dumps(schema).encode())
        self._data_off = _HEADER_SIZE + blob_len
        off = self._data_off
        self._offsets = {}
        for fname, ftype in self._fields:
            self._offsets[fname] = (off, ftype)
            off += struct.calcsize("<" + _TYPE_FMT[ftype])

    def _map(self, fd: int) -> None:
        st = os.fstat(fd)
        self._mm = mmap.mmap(fd, st.st_size)
        self._ino = st.st_ino
        self._last_stat = time.monotonic()

    def _maybe_reattach(self) -> None:
        """Re-stat the group path (throttled to ~2 Hz): if the file was
        replaced by a schema upgrade in another process (new inode), drop
        the orphaned mapping and re-attach — otherwise this process would
        silently keep writing to a file no new reader can see."""
        now = time.monotonic()
        if now - self._last_stat < 0.5:
            return
        self._last_stat = now
        try:
            ino = os.stat(self._path).st_ino
        except FileNotFoundError:
            if (
                self._declared_schema is None
                and DEFAULT_GROUPS.get(self._name) is None
            ):
                # deleted outright and nothing to recreate from: keep the
                # orphaned (frozen-but-valid) view rather than raise
                return
            ino = -1  # deleted: recreate from the declared schema
        if ino == self._ino:
            return
        with self._lock:
            # drop the orphaned mapping WITHOUT closing it: lock-free readers
            # (get_field) may hold a reference mid-unpack — a frozen view of
            # the old file is benign, a closed mmap raises under them
            self._mm = None
            self._attach_or_create(self._declared_schema)

    # -- seqlock helpers -----------------------------------------------------

    def _read_seq_raw(self) -> int:
        assert self._mm is not None
        return struct.unpack_from("<Q", self._mm, _SEQ_OFF)[0]

    def _read_seq(self) -> int:
        self._maybe_reattach()
        return self._read_seq_raw()

    def _bump_seq(self) -> None:
        # raw read: callers hold self._lock, and _maybe_reattach (which
        # also takes the lock) must not run here
        assert self._mm is not None
        struct.pack_into("<Q", self._mm, _SEQ_OFF, self._read_seq_raw() + 1)

    @property
    def seq(self) -> int:
        """Monotone write counter; watchers poll this."""
        return self._read_seq()

    @property
    def name(self) -> str:
        return self._name

    def field_names(self) -> List[str]:
        return [f for f, _ in self._fields]

    # -- field access ---------------------------------------------------------

    def get_field(self, name: str) -> Any:
        # lock-free read: capture the mapping + offsets together so a
        # concurrent reattach can't null the mapping mid-unpack (a stale
        # pair reads the frozen old file once — benign; next poll reattaches)
        mm, offsets = self._mm, self._offsets
        assert mm is not None
        off, ftype = offsets[name]
        raw = struct.unpack_from("<" + _TYPE_FMT[ftype], mm, off)[0]
        if ftype == "string":
            return raw.split(b"\x00", 1)[0].decode(errors="replace")
        if ftype == "bool":
            return bool(raw)
        return raw

    def set_field(self, name: str, value: Any) -> None:
        with self._lock:  # reattach + offset lookup + write must be atomic
            self._maybe_reattach()
            assert self._mm is not None
            off, ftype = self._offsets[name]
            value = _coerce(ftype, value)
            if ftype == "string":
                encoded = value.encode()[:64].ljust(64, b"\x00")
                self._mm[off : off + 64] = encoded
            else:
                struct.pack_into("<" + _TYPE_FMT[ftype], self._mm, off, value)
            self._bump_seq()

    def get(self) -> SimpleNamespace:
        """Snapshot all fields, retrying across concurrent writes."""
        for _ in range(64):
            s1 = self._read_seq()
            values = {f: self.get_field(f) for f, _ in self._fields}
            if self._read_seq() == s1:
                return SimpleNamespace(**values)
        return SimpleNamespace(**values)  # contended; best effort

    def set(self, snapshot: Any = None, **kwargs: Any) -> None:
        """Write multiple fields at once (one seq bump)."""
        updates: Dict[str, Any] = {}
        if snapshot is not None:
            for fname, _ in self._fields:
                if hasattr(snapshot, fname):
                    updates[fname] = getattr(snapshot, fname)
        updates.update(kwargs)
        with self._lock:  # reattach + offset lookups + writes must be atomic
            self._maybe_reattach()
            assert self._mm is not None
            for fname, value in updates.items():
                off, ftype = self._offsets[fname]
                value = _coerce(ftype, value)
                if ftype == "string":
                    self._mm[off : off + 64] = value.encode()[:64].ljust(64, b"\x00")
                else:
                    struct.pack_into("<" + _TYPE_FMT[ftype], self._mm, off, value)
            self._bump_seq()

    def __getattr__(self, name: str) -> FieldAccessor:
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self._offsets:
            return FieldAccessor(self, name)
        raise AttributeError(f"shm group '{self._name}' has no field '{name}'")


class Watcher:
    """Blocks until any watched group is written (polling the seq words)."""

    def __init__(self, poll_interval: float = 0.005):
        self._groups: List[Group] = []
        self._last_seqs: List[int] = []
        self._poll = poll_interval
        self._broken = threading.Event()

    def watch(self, group: Group) -> None:
        self._groups.append(group)
        self._last_seqs.append(group.seq)

    def broadcast(self) -> None:
        """Force any wait() to return (used for shutdown)."""
        self._broken.set()

    def wait(self, new_update: bool = True, timeout: Optional[float] = None) -> bool:
        """Return True when a watched group changed (False on timeout)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._broken.is_set():
            changed = False
            for i, group in enumerate(self._groups):
                seq = group.seq
                if seq != self._last_seqs[i]:
                    self._last_seqs[i] = seq
                    changed = True
            if changed or not new_update:
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(self._poll)
        return False


class _WatcherFactory:
    @staticmethod
    def watcher(poll_interval: float = 0.005) -> Watcher:
        return Watcher(poll_interval)


watchers = _WatcherFactory()


# --- default schema -----------------------------------------------------------
# Groups referenced by the in-tree modules/handlers, mirroring the vehicle
# SHM groups the reference writes (SURVEY.md §2.5/§2.6).

def obb_object_fields(prefix: str) -> Dict[str, Any]:
    """Per-object OBB result fields, prefixed, matching the layout every
    YOLO handler writes (reference handlers/torpedoes.py:98-115 et al.):
    visibility, confidence, the four ordered corners, center, area."""
    fields: Dict[str, Any] = {
        f"{prefix}_visible": "int",
        f"{prefix}_confidence": "float",
        f"{prefix}_center_x": "float",
        f"{prefix}_center_y": "float",
        f"{prefix}_area": "float",
    }
    for corner in ("top_left", "top_right", "bottom_left", "bottom_right"):
        fields[f"{prefix}_{corner}_x"] = "float"
        fields[f"{prefix}_{corner}_y"] = "float"
    return fields


def _obb_group(*prefixes: str, extra: Dict[str, Any] = {}) -> Dict[str, Any]:
    group: Dict[str, Any] = {}
    for prefix in prefixes:
        group.update(obb_object_fields(prefix))
    group.update(extra)
    return group


DEFAULT_GROUPS: Dict[str, Dict[str, Any]] = {
    "red_buoy_results": {
        "visible": "bool",
        "center_x": "float",
        "center_y": "float",
        "area": "float",
        "heuristic_score": "float",
        "latency_ms": "float",  # camera-to-result, written per detection
        # camera-to-result of the NEWEST lane only: batched chains drain
        # stale queued frames whose latency_ms deliberately counts queueing;
        # this field answers "how old is the freshest detection"
        "latency_newest_ms": "float",
    },
    # per-module camera-to-detection latency telemetry (the seq counter is
    # the frame counter; watchers sample latency_ms on each seq change)
    "yolo_status": {
        "latency_ms": "float",
        "frames": "int",
        # lanes in the dispatch that delivered this result (1 unbatched;
        # up to CUAUV_YOLO_BATCH when queue-depth batching drains a backlog)
        # — the drain histogram for diagnosing batched e2e throughput
        "lanes": "int",
        # dispatch counter (one bump per device round trip, vs `frames`
        # which bumps once per lane): frames/dispatches over a window is
        # the exact mean drain depth, free of the lane-count weighting a
        # per-lane `lanes` sampler suffers
        "dispatches": "int",
        # camera-to-result of the NEWEST lane only (all-lane latency_ms
        # deliberately counts queueing delay of drained stale lanes)
        "latency_newest_ms": "float",
    },
    # bins SIFT pose estimation (BASELINE config 3's "pose estimation with
    # utils/feature + sift"): projected template quad in pixel coordinates
    "bins_pose": {
        "visible": "bool",
        "matches": "int",
        "inliers": "int",
        "quad_x1": "float",
        "quad_y1": "float",
        "quad_x2": "float",
        "quad_y2": "float",
        "quad_x3": "float",
        "quad_y3": "float",
        "quad_x4": "float",
        "quad_y4": "float",
        "center_x": "float",
        "center_y": "float",
        "latency_ms": "float",
        "seq_frames": "int",
    },
    "camera_calibration": {
        "brightness": ["float", 50.0],
        "contrast": ["float", 50.0],
        "hue": ["float", 0.0],
        "saturation": ["float", 50.0],
        "gamma": ["float", 50.0],
        "sharpness": ["float", 50.0],
        "white_balance": ["float", 4600.0],
        "exposure": ["float", 50.0],
        "gain": ["float", 50.0],
        "red_gain": ["float", 1.0],
        "green_gain": ["float", 1.0],
        "blue_gain": ["float", 1.0],
        "auto_exposure": ["bool", False],
        "auto_white_balance": ["bool", False],
    },
    "zed_calibration": {
        "brightness": ["float", 4.0],
        "contrast": ["float", 4.0],
        "hue": ["float", 0.0],
        "saturation": ["float", 4.0],
        "gamma": ["float", 5.0],
        "sharpness": ["float", 4.0],
        "white_balance": ["float", 4600.0],
        "zed_exposure": ["float", 50.0],
        "zed_gain": ["float", 50.0],
        "zed_brightness": ["float", 4.0],
    },
    "zed_metrics": {
        "alpha": ["float", 0.1],
        "fps": "float",
        "acquisition_sec": "float",
        "acquisition_percent": "float",
        "postprocess_sec": "float",
        "postprocess_percent": "float",
        "start_time_sec": "float",
    },
    "flir_calibration": {
        "exposure_us": ["float", 10000.0],
        "manual_exposure": ["bool", False],
    },
    "vision_modules": {},  # populated dynamically: <Module>_on_<source> flags
    "active_objects": {
        # gating flags + the direction each detector should run on
        # (reference modules/yolo.py:66-99)
        "yolo_torpedoes_board": ["bool", True],
        "yolo_torpedoes_board_direction": ["string", "forward"],
        "yolo_gate": ["bool", True],
        "yolo_gate_direction": ["string", "forward"],
        "yolo_gate_behind": ["bool", True],
        "yolo_gate_behind_direction": ["string", "forward"],
        "yolo_slalom": ["bool", True],
        "yolo_slalom_direction": ["string", "forward"],
        "yolo_bins": ["bool", True],
        "yolo_bins_direction": ["string", "forward"],
        "yolo_manipulator": ["bool", True],
        "yolo_manipulator_direction": ["string", "forward"],
    },
    "relay": {
        "point_x": "float",
        "point_y": "float",
        "normal_x_at_point": "float",
        "normal_y_at_point": "float",
        "normal_z_at_point": "float",
    },
    "poster_status": {
        "frames_posted": "int",
        "latency_ema_sec": "float",
    },
    "active_mission": {
        "active": "bool",
        "log_path": ["string", "/tmp"],
    },
    "yolo_torpedoes_board": _obb_group("board", "shark", "saw"),
    "yolo_gate": _obb_group("shark", "saw"),
    "yolo_gate_behind": _obb_group("gate_behind"),
    "yolo_slalom": _obb_group("slalom_red", "slalom_left", "slalom_right"),
    "yolo_bins": _obb_group("bin_shark", "bin_saw", "bin"),
    "yolo_manipulator": _obb_group(
        "spoon", "cup", "pink_basket", "yellow_basket",
        extra={"num_spoons_detected": "int"},
    ),
}


_group_cache: Dict[str, Group] = {}
_cache_lock = threading.Lock()


def group(name: str, schema: Optional[Dict[str, Any]] = None) -> Group:
    """Open (or create) a group by name, in the current namespace."""
    with _cache_lock:
        existing = _group_cache.get(group_path(name))
        if existing is not None:
            return existing
        g = Group(name, schema)
        _group_cache[group_path(name)] = g
        return g


def define_group(name: str, schema: Dict[str, Any]) -> Group:
    """Create a new group with an explicit schema (idempotent if it exists)."""
    return group(name, schema)


def delete_group(name: str) -> None:
    """Remove a group's backing file (e.g. misc/yolo_shm.py --delete)."""
    with _cache_lock:
        _group_cache.pop(group_path(name), None)
    try:
        os.unlink(group_path(name))
    except FileNotFoundError:
        pass


def list_groups() -> List[str]:
    """Names of the live groups in the current namespace: with
    ``CUAUV_SHM_NAMESPACE=<ns>`` the groups ``auv_shm_<name>@<ns>``, without
    it every ``auv_shm_*`` file (as the JAX package lists them)."""
    stub = os.path.basename(SHM_STUB)
    suffix = f"@{os.environ.get(NAMESPACE_ENV, '')}"
    names = []
    for entry in sorted(os.listdir(os.path.dirname(SHM_STUB))):
        if not entry.startswith(stub):
            continue
        name = entry[len(stub):]
        if suffix == "@":
            names.append(name)
        elif name.endswith(suffix):
            names.append(name[: -len(suffix)])
    return names


def __getattr__(name: str) -> Group:
    """Module-level attribute access: ``shm.red_buoy_results``."""
    if name.startswith("_"):
        raise AttributeError(name)
    return group(name)
