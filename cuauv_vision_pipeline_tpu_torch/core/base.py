"""The module framework: video sources, module manager/reader, ModuleBase.

Behavioral parity with the reference core (reference core/base.py:36-942),
re-implemented for the shared-memory frame bus:

* ``VideoSource`` — parses CLI specs ``"name[alias1,alias2]:u8:f32:f64"``
  into a block name, plane aliases, and dtype overrides for 1/4/8-byte
  elements (reference base.py:36-120).
* ``@sources("zed[forward]", ...)`` — tags a method with ordered plane
  aliases for multi-source dispatch (reference base.py:123-149).
* ``ModuleManager`` — owns read accessors per video source, write accessors
  per tuner (blocks named ``module_<name>_tune%<idx>%<Type>_<tname>``), and
  lazily-created post accessors (``module_<name>_post%<idx>%<pname>``)
  (reference base.py:161-322). Tuner defaults are pushed on first entry.
* ``ModuleReader`` — GUI-side consumer globbing ``module_*`` blocks, polling
  posts and tuners at 60 fps, pushing tuner edits back
  (reference base.py:325-510).
* ``VideoSourceMetadata`` — rolling-30 latency, width-normalized centered
  coordinates returned (y, x), 3-strike dead-source counter
  (reference base.py:517-574).
* ``ModuleBase`` — the user-facing abstract module: argparse CLI, named
  ``<Class>-on-<src1>-<src2>``, auto-retry on FRAMEWORK_DELETED, per-tick
  read -> multi-plane fan-out -> handler dispatch -> post-queue drain
  (reference base.py:577-942).

Differences from the reference:

* frames handed to module code are *writable staging views* (the frame bus
  binding lands bytes in a reusable buffer), so there is no per-frame
  defensive copy (the reference copied twice, base.py:761-768);
* an optional ``device_fn`` fast path: a module may register a torch chain
  over its frame bundle, and ModuleBase runs it on the module's device
  (``--device N``, or ``--device cpu``; ``$CUAUV_TPU_DEVICE`` when the flag
  is absent; CUDA by default) through the module's device lane
  (engine/lane.py) with staging reuse.

Port of ``cuauv_vision_pipeline_tpu.core.base``; the bus, tuner and post
block names are unchanged, so the JAX package's ModuleReader reads a port
module and vice versa.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import signal
import threading
import time
from abc import ABC
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import (
    Any,
    Callable,
    Deque,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np
import torch

from ..engine.lane import DeviceLane, DeviceResultMeta
from ..ops.cuda import launch_counts
from .bindings.frame_bus import (
    BLOCK_STUB,
    BlockAccessor,
    ReadStatus,
)
from .device import resolve_device
from .log import Logger, log as auvlog
from .trace import maybe_start_device_profile, stop_device_profile, tracer
from .tuners import BoolTuner, DoubleTuner, IntTuner, TunerBase

VALID_COLOR_SPACES = ("BGR", "RGB", "HSV", "LAB", "HLS", "YCRCB", "LUV", "GRAY")


# ---------------------------------------------------------------------------
# Video source specs
# ---------------------------------------------------------------------------

_BYTE_TYPES = {"u8": np.uint8, "i8": np.int8}
_SHORT_TYPES = {"u32": np.uint32, "i32": np.int32, "f32": np.float32}
_LONG_TYPES = {"u64": np.uint64, "i64": np.int64, "f64": np.float64}


@dataclass
class VideoSource:
    """How to decode frames from one frame-bus block."""

    name: str
    byte_type: type = np.uint8
    short_type: type = np.float32
    long_type: type = np.float64
    plane_aliases: Tuple[str, ...] = ()

    @staticmethod
    def _split_aliases(spec: str) -> Tuple[str, Tuple[str, ...]]:
        if "[" not in spec:
            return spec, tuple()
        name, rest = spec.split("[", maxsplit=1)
        inner = rest.rsplit("]", maxsplit=1)[0]
        aliases = tuple(a.strip() for a in inner.split(",") if a.strip())
        return name, aliases

    @classmethod
    def create(cls, source: Union[str, "VideoSource"]) -> "VideoSource":
        """Parse ``"name[aliases]:u8:f32:f64"`` (types optional, any order)."""
        if isinstance(source, VideoSource):
            return source

        if ":" in source:
            name_part, type_part = source.split(":", maxsplit=1)
        else:
            name_part, type_part = source, ""

        name, aliases = cls._split_aliases(name_part)
        name = name.strip()

        byte_type: type = np.uint8
        short_type: type = np.float32
        long_type: type = np.float64
        for token in type_part.split(":"):
            token = token.strip()
            if token in _BYTE_TYPES:
                byte_type = _BYTE_TYPES[token]
            elif token in _SHORT_TYPES:
                short_type = _SHORT_TYPES[token]
            elif token in _LONG_TYPES:
                long_type = _LONG_TYPES[token]

        return cls(name, byte_type, short_type, long_type, aliases)

    def into_accessor(self) -> BlockAccessor:
        """Build a read-mode accessor for this source."""
        return BlockAccessor(
            self.name,
            byte_type=self.byte_type,
            short_type=self.short_type,
            long_type=self.long_type,
        )


def sources(*source_specs: str):
    """Decorator binding a method to ordered plane aliases.

    ``@sources("zed[forward]", "zed[normal]")`` registers the method to fire
    with the cached ``forward`` and ``normal`` frames once all are present
    and at least one was updated this tick.
    """

    def _alias_of(spec: str) -> str:
        s = spec.strip()
        if "[" in s and "]" in s:
            return s.split("[", 1)[1].rsplit("]", 1)[0].strip()
        return s

    def _decorator(fn: Callable):
        fn._sources_aliases = tuple(_alias_of(s) for s in source_specs)
        return fn

    return _decorator


def device_fn(
    *source_specs: str,
    depth: int = 1,
    async_fetch: bool = False,
    batch: int = 1,
    batch_mode: str = "vmap",
    latest_only_backlog: Optional[int] = None,
):
    """Decorator marking a method as the module's device chain.

    The device fast path the reference never had (its per-frame path copied
    every frame twice and ran OpenCV synchronously, reference
    core/base.py:761-768). The decorated method is a function of tensors:

        @device_fn("zed[forward]", "zed[normal]")
        def chain(self, forward, normal, *, tuners, want_posts):
            ...torch ops on the module's device...
            return result_tree, posts_dict

    * positional args: device tensors for each alias, in order;
    * a spec of ``"$N"`` (or ``"*"``, shorthand for ``"$0"``) binds to the
      first alias that arrives from the module's N-th video source — for
      single-source modules whose source name is chosen on the command
      line (``python -m ...modules.bins anycam``);
    * ``tuners``: dict of tuner name -> numpy scalar;
    * ``want_posts``: bool — False in performance mode; the chain then
      returns no debug images and nothing but the result scalars crosses
      back to the host;
    * returns ``(result, posts)`` trees (dicts/tuples) of device tensors.

    ``batch > 1`` resolves SURVEY's latency-vs-batching tension with a
    queue-depth-driven policy: every tick the loop drains up to ``batch``
    unseen frames from the bus in ONE native call (the ring keeps the
    latest K instead of latest-wins-only) and submits them as one
    ``[lanes, ...]`` dispatch. When the module keeps up only 1 frame is
    fresh per tick, so latency stays batch-1; when it falls behind each
    dispatch carries up to K frames instead of dropping K-1. Only the FRESH
    lanes are transferred and computed (no padding to the full batch).
    ``on_device_result`` fires once per FRESH frame, oldest
    first, each with its own acquisition-time latency; debug posts are
    delivered for the NEWEST lane only (``meta.newest``).
    Requires a single-source spec and a bus with slot_count > batch.

    ``batch_mode`` picks how lanes combine into one dispatch: ``"vmap"``
    (default) hands the stacked ``[lanes, ...]`` batch to the chain, which
    must then accept a leading batch dimension, while ``"map"`` calls the
    per-frame chain on the lanes one after another and stacks the results.

    ``latest_only_backlog=M`` restores the reference's latest-wins
    semantics (reference cmf.cpp:423) on demand: when more than M unseen
    frames are queued, only the newest is dispatched — stale frames are
    dropped instead of batched, bounding result latency at one dispatch
    interval. ``None`` (default) batches the full backlog.

    The module's device lane (engine/lane.py) runs the chain through a
    depth-``depth`` StreamExecutor: frame N's H2D copy + compute overlap
    the bus read of frame N+1, and the materialized result of frame N
    arrives at ``on_device_result(result, posts, meta)`` one submit later.
    ``depth > 1`` keeps several dispatches in flight and
    ``async_fetch=True`` moves result readback to a worker thread that
    waits on each dispatch's CUDA event. Results are packed into one device
    vector so a whole result tree costs ONE device->host copy
    (engine/executor.py pack_result).
    """

    def _alias_of(spec: str) -> str:
        s = spec.strip()
        if s == "*":
            return "$0"
        if "[" in s and "]" in s:
            return s.split("[", 1)[1].rsplit("]", 1)[0].strip()
        return s

    if batch_mode not in ("vmap", "map"):
        raise ValueError(
            f"@device_fn batch_mode must be 'vmap' or 'map', got {batch_mode!r}"
        )
    if latest_only_backlog is not None and latest_only_backlog < 1:
        raise ValueError(
            "@device_fn latest_only_backlog must be >= 1 (got "
            f"{latest_only_backlog}); use None to batch the full backlog"
        )

    def _decorator(fn: Callable):
        fn._device_fn_aliases = tuple(_alias_of(s) for s in source_specs)
        fn._device_fn_depth = depth
        fn._device_fn_async = async_fetch
        fn._device_fn_batch = batch
        fn._device_fn_batch_mode = batch_mode
        fn._device_fn_latest_only = latest_only_backlog
        return fn

    return _decorator


@dataclass
class VideoMessage:
    source: VideoSource
    status: ReadStatus
    data: Optional[Union[np.ndarray, Tuple[np.ndarray, ...]]]
    acquisition_time: int
    plane_names: Tuple[str, ...] = tuple()
    # latest-K drain for a batching device chain: oldest-first frames (the
    # last one == data) and their acquisition times
    batch_data: Optional[List[Union[np.ndarray, Tuple[np.ndarray, ...]]]] = None
    batch_acqs: Optional[List[int]] = None


# ---------------------------------------------------------------------------
# ModuleManager
# ---------------------------------------------------------------------------


class ModuleManager:
    """Per-module I/O hub: video reads, tuner blocks, post blocks.

    Module blocks are namespaced with a ``module_`` prefix so they are
    distinguishable from capture blocks in /dev/shm
    (reference base.py:182-187).
    """

    def __init__(
        self,
        module_name: str,
        video_sources: List[VideoSource],
        tuner_sources: List[TunerBase],
    ):
        self._module_name = "module_" + module_name
        self._post_name = self._module_name + "_post"
        self._tune_name = self._module_name + "_tune"
        self._first = True

        self._video_sources: Dict[str, VideoSource] = {
            vs.name: vs for vs in video_sources
        }
        if len(self._video_sources) != len(video_sources):
            raise RuntimeError("cannot have multiple video sources of the same name")

        self._tuner_sources: Dict[str, TunerBase] = {
            ts.name: ts for ts in tuner_sources
        }
        if len(self._tuner_sources) != len(tuner_sources):
            raise RuntimeError("cannot have multiple tuner types of the same name")

        self._video_accessor: Dict[str, BlockAccessor] = {
            vs.name: vs.into_accessor() for vs in video_sources
        }
        # The index in the block name tells the web GUI how to order tuners
        # (reference base.py:204-210).
        self._tuner_accessor: Dict[str, BlockAccessor] = {
            ts.name: BlockAccessor(
                f"{self._tune_name}%{idx}%{ts}",
                max_entry_size_bytes=ts.byte_size(),
            )
            for idx, ts in enumerate(tuner_sources)
        }
        self._post_accessor: Dict[str, BlockAccessor] = {}
        self._exit_stack = contextlib.ExitStack()
        self._inside_ctx = False

    def _require_ctx(self) -> None:
        if not self._inside_ctx:
            raise RuntimeError(
                "attempted to access ModuleManager while not in a context manager"
            )

    def post(
        self, name: str, idx: int, acquisition_time: int, data: np.ndarray
    ) -> None:
        self._require_ctx()
        accessor = self._post_accessor.get(name)
        if accessor is None:
            accessor = BlockAccessor(f"{self._post_name}%{idx}%{name}", data.nbytes)
            self._exit_stack.enter_context(accessor)
            self._post_accessor[name] = accessor
        accessor.write_frame(acquisition_time, data)

    def read_messages(
        self, batch: Optional[Dict[str, int]] = None
    ) -> List[VideoMessage]:
        """Read the newest frame from every video source. Sources named in
        ``batch`` drain up to that many unseen frames in ONE native call
        (the latest-K reader): the message's ``data`` is still the newest
        frame, and the full oldest-first batch rides in ``batch_data`` /
        ``batch_acqs`` for a batching device chain."""
        self._require_ctx()

        # Tuner updates first, so this tick's processing sees fresh values.
        for name, accessor in self._tuner_accessor.items():
            status, data, _ = accessor.read_frame()
            if status == ReadStatus.FRAMEWORK_DELETED:
                raise RuntimeError("Unexpected deleted Tuner")
            if status == ReadStatus.SUCCESS and data is not None:
                self._tuner_sources[name].deserialize(data.tobytes("C"))

        messages: List[VideoMessage] = []
        for name, accessor in self._video_accessor.items():
            max_frames = (batch or {}).get(name, 1)
            if max_frames > 1:
                status, frames, acqs = accessor.read_frame_batch(max_frames)
                if frames:
                    data = frames[-1]
                    acquisition_time = acqs[-1]
                    batch_data, batch_acqs = frames, acqs
                else:
                    # NO_NEW_FRAME: surface the cached last frame exactly
                    # like read_frame does, so _loop's 3-strike dead-source
                    # detector still fires for batch-reading modules
                    data = accessor.last_frame_data
                    acquisition_time = accessor.last_acquisition_time
                    batch_data, batch_acqs = None, None
            else:
                status, data, acquisition_time = accessor.read_frame()
                batch_data, batch_acqs = None, None
            if status == ReadStatus.FRAMEWORK_DELETED:
                raise RuntimeError(f"{accessor.direction} was marked for deletion")
            if data is not None:
                messages.append(
                    VideoMessage(
                        source=self._video_sources[name],
                        status=status,
                        data=data,
                        acquisition_time=acquisition_time,
                        plane_names=accessor.last_plane_names(),
                        batch_data=batch_data,
                        batch_acqs=batch_acqs,
                    )
                )
        return messages

    def __getitem__(self, key: str) -> Any:
        return self._tuner_sources[key].value

    def set_staging_depth(self, depth: int) -> None:
        """Keep the last ``depth`` reads per video source alive (pipelined
        device path; see BlockAccessor.set_staging_depth)."""
        for accessor in self._video_accessor.values():
            accessor.set_staging_depth(depth)

    def tuner_scalars(self) -> Dict[str, np.generic]:
        """Current tuner values as fixed-dtype numpy scalars for the device
        chain (int32/float64/bool_)."""
        out: Dict[str, np.generic] = {}
        for name, tuner in self._tuner_sources.items():
            v = tuner.value
            if isinstance(v, bool):
                out[name] = np.bool_(v)
            elif isinstance(v, int):
                out[name] = np.int32(v)
            else:
                out[name] = np.float64(v)
        return out

    def __str__(self) -> str:
        return (
            f"ModuleManager(name={self._module_name}, "
            f"video_sources={self._video_sources}, "
            f"tuner_sources={self._tuner_sources})"
        )

    def __enter__(self) -> "ModuleManager":
        if self._inside_ctx:
            raise RuntimeError("double dipped in context manager for ModuleManager")
        self._inside_ctx = True
        self._exit_stack.__enter__()
        try:
            for accessor in self._video_accessor.values():
                self._exit_stack.enter_context(accessor)
            for accessor in self._tuner_accessor.values():
                self._exit_stack.enter_context(accessor)
            if self._first:
                self._first = False
                for tuner in self._tuner_sources.values():
                    data = np.frombuffer(tuner.serialize(), dtype=np.uint8)
                    self._tuner_accessor[tuner.name].write_frame(
                        int(time.monotonic() * 1000), data
                    )
        except BaseException:
            self._exit_stack.__exit__(None, None, None)
            self._inside_ctx = False
            raise
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self._exit_stack.__exit__(exc_type, exc_val, exc_tb)
        self._post_accessor.clear()
        self._inside_ctx = False


# ---------------------------------------------------------------------------
# ModuleReader (GUI bridge)
# ---------------------------------------------------------------------------


class ModuleReader:
    """Discovers a module's post/tune blocks, polls them, and pushes tuner
    edits back (the WebGUI side of the bus).

    Unlike the reference (which discovers only at construction, reference
    base.py:325-364), the poll loop RE-discovers: post/tune blocks the
    module creates later are picked up within ``rediscover_every_s``.
    """

    def __init__(self, module_name: str, rediscover_every_s: float = 1.0):
        # set before any raise so __del__ is safe on failed construction
        self._thread: Optional[threading.Thread] = None
        if module_name not in ModuleReader.get_active_modules():
            raise RuntimeError("Module name is not active")

        self._base_module_name = module_name
        self._module_name = f"module_{module_name}"
        self._post_name = f"{self._module_name}_post%"
        self._tune_name = f"{self._module_name}_tune%"
        self._quit_flag = threading.Event()

        self._post_udls: List[Callable[[str, str, int, np.ndarray, str], None]] = []
        self._tuner_udls: List[Callable[[str, str, int, TunerBase], None]] = []

        # name -> (idx, accessor, color_space)
        self._all_posts: Dict[str, Tuple[int, BlockAccessor, str]] = {}
        # name -> (idx, accessor, tuner)
        self._all_tuners: Dict[str, Tuple[int, BlockAccessor, TunerBase]] = {}
        self._tuner_guard = False
        self._framework_deleted = False
        self._rediscover_every_s = rediscover_every_s

        for post_block in self.active_posts:
            idx, name, color_space = self.parse_post_name(post_block)
            self._all_posts[name] = (idx, BlockAccessor(post_block), color_space)
        for tune_block in self.active_tuners:
            idx, tuner, name = self.parse_tune_name(tune_block)
            self._all_tuners[name] = (idx, BlockAccessor(tune_block), tuner)

    @property
    def known_posts(self) -> List[str]:
        """Post names currently tracked (grows as the module posts more)."""
        return list(self._all_posts)

    @property
    def known_tuners(self) -> List[str]:
        return list(self._all_tuners)

    def tuner_values(self) -> Dict[str, Any]:
        """Current value of every known tuner (GUI surface)."""
        # snapshot: the poll thread's _rediscover may grow the dict while
        # an HTTP thread iterates here
        return {
            name: entry[2].value
            for name, entry in list(self._all_tuners.items())
        }

    def tuner_cast(self, name: str, raw: str) -> Any:
        """Parse a string (e.g. an HTTP form value) into the tuner's type."""
        current = self._all_tuners[name][2].value
        if isinstance(current, bool):
            return raw.strip().lower() in ("1", "true", "on", "yes")
        return type(current)(float(raw))

    def _rediscover(self, exit_stack: contextlib.ExitStack) -> None:
        """Pick up post/tune blocks created after construction."""
        for post_block in self.active_posts:
            idx, name, color_space = self.parse_post_name(post_block)
            if name not in self._all_posts:
                accessor = BlockAccessor(post_block)
                exit_stack.enter_context(accessor)
                self._all_posts[name] = (idx, accessor, color_space)
        for tune_block in self.active_tuners:
            idx, tuner, name = self.parse_tune_name(tune_block)
            if name not in self._all_tuners:
                accessor = BlockAccessor(tune_block)
                exit_stack.enter_context(accessor)
                self._all_tuners[name] = (idx, accessor, tuner)

    @classmethod
    def get_active_modules(cls) -> List[str]:
        names = set()
        for path in glob.glob(f"{BLOCK_STUB}module_*"):
            # /dev/shm/auv_visiond_module_<Name-on-src>_post%... -> <Name-on-src>
            rest = path[len(BLOCK_STUB) + len("module_") :]
            for marker in ("_post%", "_tune%"):
                if marker in rest:
                    names.add(rest.split(marker)[0])
                    break
        return list(names)

    @property
    def active_posts(self) -> List[str]:
        return [
            p[len(BLOCK_STUB) :] for p in glob.glob(BLOCK_STUB + self._post_name + "*")
        ]

    @property
    def active_tuners(self) -> List[str]:
        return [
            p[len(BLOCK_STUB) :] for p in glob.glob(BLOCK_STUB + self._tune_name + "*")
        ]

    @property
    def framework_deleted(self) -> bool:
        return self._framework_deleted

    def parse_post_name(self, s: str) -> Tuple[int, str, str]:
        """``module_X_post%idx%name#COLORSPACE`` -> (idx, name, colorspace)."""
        _, idx, name_with_colorspace = s.split("%")
        if "#" in name_with_colorspace:
            name, color_space = name_with_colorspace.split("#", 1)
        else:
            name, color_space = name_with_colorspace, "BGR"
        return int(idx), name, color_space

    def parse_tune_name(self, s: str) -> Tuple[int, TunerBase, str]:
        """``module_X_tune%idx%Type_name`` -> (idx, tuner, name)."""
        _, idx, tuner_str = s.split("%")
        tuner_type, tuner_name = tuner_str.split("_", maxsplit=1)
        tuner: TunerBase
        if tuner_type == "IntTuner":
            tuner = IntTuner(tuner_name, 0)
        elif tuner_type == "DoubleTuner":
            tuner = DoubleTuner(tuner_name, 0)
        else:
            tuner = BoolTuner(tuner_name, False)
        return int(idx), tuner, tuner_name

    def register_post_udl(
        self, udl: Callable[[str, str, int, np.ndarray, str], None]
    ) -> None:
        self._post_udls.append(udl)

    def register_tuner_udl(
        self, udl: Callable[[str, str, int, TunerBase], None]
    ) -> None:
        self._tuner_udls.append(udl)

    def run_forever(self, fps: int = 60) -> None:
        if self._thread is not None:
            raise RuntimeError("cannot run already running module reader")
        self._quit_flag = threading.Event()
        # enter the construction-time accessors HERE, not in the loop
        # thread: callers may update_tuner_value immediately after this
        # returns, and racing the thread's startup would raise
        # "not in a context manager"
        self._exit_stack = contextlib.ExitStack()
        try:
            for _, accessor, _ in self._all_posts.values():
                self._exit_stack.enter_context(accessor)
            for _, accessor, _ in self._all_tuners.values():
                self._exit_stack.enter_context(accessor)
        except BaseException:
            # unwind the accessors already entered — otherwise a single bad
            # block leaks every earlier mapping for the process lifetime
            self._exit_stack.close()
            self._exit_stack = None
            raise
        self._thread = threading.Thread(target=self._loop, args=(fps,))
        self._thread.start()

    def allow_resend_tuners_once(self) -> None:
        self._tuner_guard = True

    def update_tuner_value(self, name: str, value: Any) -> None:
        _, accessor, tuner = self._all_tuners[name]
        tuner._current_value = value
        data = np.frombuffer(tuner.serialize(), dtype=np.uint8)
        accessor.write_frame(int(time.monotonic() * 1000), data)

    def _loop(self, fps: int) -> None:
        # construction-time accessors were entered in run_forever (so
        # update_tuner_value works the moment it returns); this stack also
        # adopts blocks found by _rediscover and closes everything on exit
        with self._exit_stack as exit_stack:
            wait_time = 1.0 / fps
            last_scan = time.monotonic()
            while not self._quit_flag.is_set():
                tick_start = time.monotonic()

                if tick_start - last_scan >= self._rediscover_every_s:
                    last_scan = tick_start
                    self._rediscover(exit_stack)

                for name, (idx, accessor, color_space) in list(
                    self._all_posts.items()
                ):
                    status, data, _ = accessor.read_frame()
                    if status == ReadStatus.SUCCESS and data is not None:
                        for udl in self._post_udls:
                            udl(self._base_module_name, name, idx, data, color_space)
                    elif status == ReadStatus.FRAMEWORK_DELETED:
                        print(
                            f"ModuleReader: {self._base_module_name} framework deleted"
                        )
                        self._framework_deleted = True
                        self._quit_flag.set()

                resent = False
                for name, (idx, accessor, tuner) in list(
                    self._all_tuners.items()
                ):
                    status, data, _ = accessor.read_frame()
                    if (
                        self._tuner_guard or status == ReadStatus.SUCCESS
                    ) and data is not None:
                        resent = resent or self._tuner_guard
                        tuner.deserialize(data.tobytes("C"))
                        for udl in self._tuner_udls:
                            udl(self._base_module_name, name, idx, tuner)
                    elif status == ReadStatus.FRAMEWORK_DELETED:
                        print(
                            f"ModuleReader: {self._base_module_name} framework deleted"
                        )
                        self._framework_deleted = True
                        self._quit_flag.set()
                if resent:
                    self._tuner_guard = False

                elapsed = time.monotonic() - tick_start
                time.sleep(max(0.0, wait_time - elapsed))

    def unblock(self) -> None:
        if self._thread is None:
            print(f"[WARNING]: {self._module_name} was already terminated")
            return
        self._quit_flag.set()
        self._thread.join()
        self._thread = None

    def __del__(self) -> None:
        if self._thread is not None:
            print(
                "[WARNING]: object garbage collected without freeing "
                "underlying resources"
            )
            self._quit_flag.set()
            if self._thread is not threading.current_thread():
                self._thread.join()


# ---------------------------------------------------------------------------
# Per-source metadata
# ---------------------------------------------------------------------------


@dataclass
class VideoSourceMetadata:
    """Rolling latency / shape / liveness stats per direction."""

    _frames_read: int = 0
    _shape: Tuple[int, int] = (1, 1)
    _acquisition_times: Deque[int] = field(default_factory=lambda: deque(maxlen=30))
    _dead_counter: int = 0

    def update(
        self,
        mat: Union[np.ndarray, Tuple[np.ndarray, ...]],
        acquisition_time: int,
    ) -> None:
        now = int(time.monotonic() * 1000)
        self._acquisition_times.append(now - acquisition_time)

        primary = mat[0] if isinstance(mat, tuple) else mat
        if primary is None:
            return
        self._shape = (primary.shape[0], primary.shape[1])
        self._frames_read += 1
        self._dead_counter = max(0, self._dead_counter - 1)

    def mark_as_dead(self) -> bool:
        """3-strike dead-source detector; returns True when freshly dead
        (reference base.py:542-546)."""
        alive = self._dead_counter == 0
        self._dead_counter = 3
        return alive

    def get_latency(self) -> int:
        if not self._acquisition_times:
            return 0
        return int(sum(self._acquisition_times) / len(self._acquisition_times))

    def normalize_axis(self, coord: float, axis: int) -> float:
        """Pixel -> centered coordinate divided by *width* for both axes
        (reference base.py:553-563)."""
        return (coord - self._shape[1 - axis] / 2) / self._shape[1]

    def normalize_coord(self, coord: Tuple[float, float]) -> Tuple[float, float]:
        """(y, x) pixels -> (y, x) normalized."""
        return self.normalize_axis(coord[0], 1), self.normalize_axis(coord[1], 0)


# ---------------------------------------------------------------------------
# ModuleBase
# ---------------------------------------------------------------------------


class ModuleBase(ABC):
    """The user-facing vision module.

    Subclass, decorate handlers with ``@sources(...)`` (or override
    ``process``), construct with default sources/tuners, and call the
    instance to run. CLI args override the defaults.
    """

    def __init__(
        self,
        video_sources: List[Union[VideoSource, str]] = [],
        tuners: List[TunerBase] = [],
        fps: int = 10,
        argv: Optional[List[str]] = None,
        **kwargs,
    ):
        parser = argparse.ArgumentParser(
            f"{__file__}",
            description="CLI to run this particular vision module",
            formatter_class=argparse.RawTextHelpFormatter,
        )
        parser.add_argument(
            "-f",
            "--fps",
            type=int,
            default=fps,
            help="maximum fps to run (capped at the speed of the video sources)",
        )
        parser.add_argument(
            "--verbose", action="store_true", help="display debug messages"
        )
        parser.add_argument(
            "--enable-performance",
            action="store_true",
            help="disable posting to help with performance during competition runs",
        )
        parser.add_argument(
            "--device",
            default=os.environ.get("CUAUV_TPU_DEVICE"),
            help=(
                "run this module's device chain on cuda:N (default 0, or "
                "$CUAUV_TPU_DEVICE, which a launcher sets to pin one module "
                "per device), or 'cpu' to run it on the host; without a CUDA "
                "device and without 'cpu' the module refuses to start"
            ),
        )
        parser.add_argument(
            "sources",
            nargs="*",
            type=str,
            help=(
                "Video sources as {name}[aliases]:<types>; empty uses the "
                "module's defaults.\n"
                "types: u8/i8 (1-byte), u32/i32/f32 (4-byte), u64/i64/f64 "
                "(8-byte)\n"
                "example: 'forward:f64' decodes 8-byte planes as f64"
            ),
        )
        args = parser.parse_args(argv)

        if "_" in self.__class__.__name__:
            raise RuntimeError(
                f"Class name '{self.__class__.__name__}' cannot have an underscore"
            )

        src_specs = args.sources if len(args.sources) > 0 else video_sources
        src = [VideoSource.create(s) for s in src_specs]

        self._name = (
            self.__class__.__name__ + "-on-" + "-".join(s.name for s in src)
        )
        self._fps: int = args.fps if args.fps else fps
        self._verbose: bool = args.verbose
        self._module_manager = ModuleManager(self._name, src, tuners)
        self._post_queue: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._post_color_spaces: Dict[str, str] = {}
        self._performance_enabled: bool = args.enable_performance
        self.device: torch.device = resolve_device(args.device)
        self._retry = True

        # the device lane of the @device_fn chain, or None; found on first
        # use ("unset" sentinel so tests driving _loop directly still find it)
        self._lane: Any = "unset"

        self._video_metadata: Dict[str, VideoSourceMetadata] = {}
        for source in src:
            self._video_metadata[source.name] = VideoSourceMetadata()
            for alias in source.plane_aliases:
                self._video_metadata.setdefault(alias, VideoSourceMetadata())
        self._current_direction = ""
        self._current_acquisition_time = int(time.monotonic() * 1000)

    # -- public API ---------------------------------------------------------

    @property
    def tuners(self) -> ModuleManager:
        return self._module_manager

    @property
    def name(self) -> str:
        return self._name

    def post(
        self, name: str, image: np.ndarray, color_space: str = "BGR"
    ) -> None:
        """Queue a u8 debug image for the WebGUI (copied; disabled in
        performance mode, reference base.py:846-876)."""
        if self._performance_enabled:
            return
        if "%" in name:
            raise RuntimeError("Cannot have % in name")

        image = np.array(image, np.uint8, copy=True, order="C", ndmin=1)
        color_space = color_space.upper()
        if color_space not in VALID_COLOR_SPACES:
            color_space = "BGR"
        self._post_queue[name] = image
        self._post_color_spaces[name] = color_space

    def get_latency(self) -> int:
        """Rolling average camera->module latency (ms) for the current
        direction."""
        return self._video_metadata[self._current_direction].get_latency()

    def camera_latency_ms(self) -> int:
        """Camera-to-now latency (ms) of the frame(s) driving the current
        handler — per-frame, not rolling; call at the end of a handler for
        the camera-to-detection number."""
        return int(time.monotonic() * 1000) - self._current_acquisition_time

    def normalize(self, coordinate: Tuple[float, float]) -> Tuple[float, float]:
        """(y, x) pixels -> (y, x) normalized for the current direction."""
        return self._video_metadata[self._current_direction].normalize_coord(
            coordinate
        )

    def normalize_axis(self, coordinate: float, axis: int) -> float:
        return self._video_metadata[self._current_direction].normalize_axis(
            coordinate, axis
        )

    def process(self, direction: str, image: np.ndarray):
        """Default no-op per-alias processing; override or use @sources."""
        return None

    def on_device_result(
        self, result: Any, posts: Dict[str, np.ndarray], meta: DeviceResultMeta
    ) -> None:
        """Called with each materialized @device_fn result (numpy pytrees).

        ``posts`` is empty in performance mode. ``meta.latency_ms()`` is the
        camera-to-result latency of this bundle. Override in modules that
        register a @device_fn.
        """
        raise NotImplementedError(
            f"{self.__class__.__name__} registered a @device_fn but does not "
            "override on_device_result"
        )

    def process_bundle(
        self,
        direction: str,
        frames: Tuple[np.ndarray, ...],
        aliases: Tuple[str, ...],
        acquisition_time: int,
    ) -> None:
        """Manual fan-out helper (reference base.py:916-934)."""
        if aliases and len(aliases) != len(frames):
            raise RuntimeError(
                f"direction '{direction}' provided {len(frames)} planes but "
                f"{len(aliases)} aliases"
            )
        if not aliases:
            aliases = tuple(f"{direction}[{i}]" for i in range(len(frames)))
        for alias, frame in zip(aliases, frames):
            self._touch_metadata(alias, frame, acquisition_time)
            self._current_direction = alias
            self._current_acquisition_time = acquisition_time
            self.process(alias, frame)

    # -- run loop -----------------------------------------------------------

    def __call__(self) -> None:
        logger = getattr(auvlog, self._name)
        logger(f"Running {self._name}", True)
        if self._performance_enabled:
            logger("Module running in performance mode", True)

        original_sigint_handler = signal.getsignal(signal.SIGINT)
        quit_flag = threading.Event()

        def sigh(*args):
            if quit_flag.is_set():
                # second SIGINT: the loop thread never came back — it is
                # blocked inside a device call that will not return. Force
                # exit so the operator regains the process; shm blocks are
                # reclaimed by the next startup's create path. Only
                # async-signal-safe calls here: the first handler may have
                # been interrupted INSIDE logger()'s non-reentrant lock.
                os.write(2, b"\nCaught signal twice: force exit without cleanup.\n")
                os._exit(130)
            quit_flag.set()  # before logging: a nested SIGINT must see it
            logger(
                f"Caught signal: {args[0]}. It may take up to 2 seconds to "
                "clean up.",
                self._verbose,
            )

        logger(f"Target FPS = {self._fps}", self._verbose)

        if self._lane == "unset":
            self._lane = DeviceLane.find(self, logger)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            name = torch.cuda.get_device_name(self.device)
        else:
            name = "host CPU"
        logger(f"Device: {self.device} ({name})", True)
        maybe_start_device_profile(self.device, logger)

        while self._retry:
            self._retry = False
            quit_flag.clear()
            with self._module_manager:
                try:
                    signal.signal(signal.SIGINT, sigh)
                    logger("Registered SIGINT handler", self._verbose)
                except ValueError:
                    pass  # not on the main thread
                logger(f"Initialized module manager {self._module_manager}",
                       self._verbose)
                main_thread = threading.Thread(
                    target=self._loop, args=(quit_flag, logger)
                )
                main_thread.start()
                main_thread.join()

            if self._retry:
                try:
                    signal.signal(signal.SIGINT, original_sigint_handler)
                    logger("Unregistered SIGINT handler", self._verbose)
                except ValueError:
                    pass

        logger(f"kernel launches: {json.dumps(launch_counts())}", True)
        if self.device.type == "cuda":
            # the caching allocator's use over the run (the CUDA context's
            # own memory is not in it)
            mib = float(2**20)
            memory = {"reserved_mib": torch.cuda.memory_reserved(self.device) / mib,
                      "max_reserved_mib": torch.cuda.max_memory_reserved(self.device) / mib,
                      "max_allocated_mib": torch.cuda.max_memory_allocated(self.device) / mib}
            logger(f"device memory: {json.dumps(memory)}", True)
        logger(f"Cleaning {self.__class__.__name__}", True)
        if self._lane is not None and self._lane.abandoned:
            # abandoned in-flight device work means runtime worker threads
            # are blocked inside calls that will not return; interpreter/
            # C++ teardown may then abort the process. All shm state
            # is already cleaned above — exit without running destructors.
            # os._exit skips atexit, so dump the incident's traces (the
            # ones you most want: host spans and the device profile) and
            # flush streams explicitly first.
            import sys

            trace_dir = os.environ.get("CUAUV_TRACE_DIR")
            if trace_dir:
                tracer.dump(
                    os.path.join(
                        trace_dir,
                        f"trace-{os.getpid()}-{int(time.time())}.json",
                    )
                )
            stop_device_profile()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(0)

    def _discover_handlers(
        self, logger: Logger
    ) -> List[Tuple[Callable[..., None], Tuple[str, ...]]]:
        handlers: List[Tuple[Callable[..., None], Tuple[str, ...]]] = []
        for attr_name in dir(self):
            try:
                maybe = getattr(self, attr_name)
            except Exception:
                continue
            aliases = getattr(maybe, "_sources_aliases", None)
            if aliases is None and hasattr(maybe, "__func__"):
                aliases = getattr(maybe.__func__, "_sources_aliases", None)
            if aliases:
                handlers.append((maybe, tuple(aliases)))
                logger(
                    f"Registered multi-source handler {attr_name} with "
                    f"aliases: {aliases}",
                    True,
                )
        return handlers

    def _deliver(self, result: Any, posts: Dict[str, np.ndarray], meta: DeviceResultMeta) -> None:
        self._current_direction = meta.aliases[0]
        self._current_acquisition_time = meta.acquisition_time
        with tracer.span("on_device_result"):
            self.on_device_result(result, posts, meta)

    def _loop(self, quit_flag: threading.Event, logger: Logger) -> None:
        # alias -> (frame, acquisition_time)
        frame_cache: Dict[str, Tuple[np.ndarray, int]] = {}
        ms_handlers = self._discover_handlers(logger)
        handled_aliases = {a for _, aliases in ms_handlers for a in aliases}
        logged_missing: set = set()

        if self._lane == "unset":
            self._lane = DeviceLane.find(self, logger)
        lane: Optional[DeviceLane] = self._lane
        if lane is not None:
            lane.open(list(self._module_manager._video_sources))
            # the views of the last depth+1 reads stay valid. No transfer
            # needs that (to_device has copied a frame when it returns);
            # whether frame_cache's views across ticks do is unverified
            self._module_manager.set_staging_depth(lane.depth + 1)

        while not quit_flag.is_set():
            tick_start = time.monotonic()

            try:
                with tracer.span("read_messages"):
                    video_messages = self._module_manager.read_messages(
                        batch=lane.read_request() if lane is not None else None
                    )
            except RuntimeError as e:
                logger(f"Error: {e}", True)
                quit_flag.set()
                self._retry = True
                break

            updated_aliases: set = set()
            for message in video_messages:
                source = message.source
                if message.status == ReadStatus.SUCCESS and message.data is not None:
                    image = message.data
                    acq_time = message.acquisition_time
                    # NOTE: frames are writable views into the accessor's
                    # staging buffer — valid until the next read on that
                    # accessor; no defensive copy needed.
                    self._touch_metadata(source.name, image, acq_time)
                    self._current_direction = source.name

                    multi_plane = isinstance(image, tuple)
                    planes = image if multi_plane else (image,)
                    aliases = self._plane_aliases_for(message)
                    if lane is not None:
                        lane.note(source.name, aliases, message)
                    for alias, frame in zip(aliases, planes):
                        frame_cache[alias] = (frame, acq_time)
                        updated_aliases.add(alias)
                        if multi_plane or alias != source.name:
                            self._touch_metadata(alias, frame, acq_time)
                        if alias not in handled_aliases and (lane is None or alias not in lane.aliases):
                            self._current_direction = alias
                            self._current_acquisition_time = acq_time
                            self.process(alias, frame)
                elif message.status == ReadStatus.NO_NEW_FRAME:
                    if self._video_metadata[source.name].mark_as_dead():
                        logger(
                            f"{source.name} appears to be slow or dead!",
                            self._verbose,
                        )

            for handler, aliases in ms_handlers:
                missing = [a for a in aliases if a not in frame_cache]
                if missing and handler not in logged_missing:
                    logged_missing.add(handler)
                    logger(
                        f"Handler {handler.__name__} waiting for aliases: "
                        f"{missing}. Available: {list(frame_cache.keys())}",
                        True,
                    )
                if not missing and any(a in updated_aliases for a in aliases):
                    imgs = [frame_cache[a][0] for a in aliases]
                    self._current_acquisition_time = max(
                        frame_cache[a][1] for a in aliases
                    )
                    with tracer.span("handler", fn=handler.__name__):
                        handler(*imgs)

            if lane is not None:
                for delivery in lane.offer(
                    frame_cache,
                    updated_aliases,
                    self._module_manager.tuner_scalars,
                    want_posts=not self._performance_enabled,
                ):
                    self._deliver(*delivery)

            with tracer.span("drain_posts", n=len(self._post_queue)):
                self._drain_post_queue()
            time.sleep(max((1 / self._fps) - (time.monotonic() - tick_start), 0))

        if lane is not None:
            for delivery in lane.close(logger):
                self._deliver(*delivery)
            self._drain_post_queue()

    def _plane_aliases_for(self, message: VideoMessage) -> Tuple[str, ...]:
        """The alias of each plane of a frame: bus plane names win, then
        declared aliases, then a positional fallback (reference
        base.py:773-800). A single-plane frame honours a bus plane name or
        declared alias too, so @sources handlers match blocks that aren't
        named like their alias (e.g. the hypertune harness's private
        block), and falls back to its source's name."""
        multi_plane = isinstance(message.data, tuple)
        n = len(message.data) if multi_plane else 1
        if len(message.plane_names) == n and all(len(str(p)) > 0 for p in message.plane_names):
            return tuple(str(p) for p in message.plane_names)
        source = message.source
        if len(source.plane_aliases) == n:
            return source.plane_aliases
        if not multi_plane:
            return (source.name,)
        return tuple(f"{source.name}[{i}]" for i in range(n))

    def _drain_post_queue(self) -> None:
        # posts carry the CAMERA acquisition time of the frame that produced
        # them, so downstream readers can compute camera->GUI latency
        # (reference base.py:521-551, modules/poster.py:56-72)
        for idx, (name, data) in enumerate(self._post_queue.items()):
            color_space = self._post_color_spaces.get(name, "BGR")
            self._module_manager.post(
                f"{name}#{color_space}", idx, self._current_acquisition_time, data
            )
        self._post_queue.clear()
        self._post_color_spaces.clear()

    def _touch_metadata(
        self,
        direction: str,
        frame: Union[np.ndarray, Tuple[np.ndarray, ...]],
        acquisition_time: int,
    ) -> None:
        self._video_metadata.setdefault(
            direction, VideoSourceMetadata()
        ).update(frame, acquisition_time)
