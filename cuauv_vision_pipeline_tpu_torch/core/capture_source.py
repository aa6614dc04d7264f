"""Capture-source harness: thread-per-UDL generators feeding the frame bus.

Behavioral parity with the reference capture framework
(reference core/capture_source.py:23-238):

* ``FpsLimiter(name, quit_flag).rate(fps)`` — an iterator that sleeps to cap
  the rate and yields epoch-milliseconds; fps=0 means uncapped; logs
  slow/recovered transitions; stops when the shared quit flag is set.
* ``CaptureSource.register_capture_udl(name, generator_udl, args)`` — the UDL
  is a generator yielding ``(direction, time_ms, frames)`` or
  ``(direction, time_ms, frames, names)``; frames may be one ndarray or a
  sequence; blocks are lazily created per direction, sized to the first
  frame (reference capture_source.py:183-234).
* ``register_logical_udl`` for non-frame side loops (calibration watchers).
* any UDL exception sets the shared quit flag and unwinds every sibling
  thread (reference capture_source.py:124-127, 162-167).
* ``run_event_loop()`` installs a SIGINT handler, starts threads, joins.
"""

from __future__ import annotations

import os
import signal
import threading
import time
import traceback
from typing import (
    Any,
    Callable,
    Dict,
    Generator,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

from numpy import ndarray

from .bindings.frame_bus import BlockAccessor
from .log import Logger, log as auvlog
from .trace import tracer


class FpsLimiter:
    """Rate-capping iterator yielding epoch-ms timestamps."""

    def __init__(self, name: str, quit_flag: threading.Event):
        self._logger: Logger = getattr(
            auvlog.vision.capture_source.fps_limiter, name or "anonymous"
        )
        self._slow = False
        self._quit_flag = quit_flag
        self._fps = 0
        self._target = 0.0
        self._last_time = 0.0

    def rate(self, fps: Optional[int]) -> "FpsLimiter":
        fps = fps if fps else 0
        assert fps >= 0, "given negative fps which is invalid"
        self._fps = fps
        self._target = 1.0 / fps if fps > 0 else 0.0
        self._last_time = 0.0
        return self

    def __iter__(self) -> "FpsLimiter":
        self._last_time = time.monotonic()
        return self

    def __next__(self) -> int:
        if self._quit_flag.is_set():
            raise StopIteration

        elapsed = time.monotonic() - self._last_time
        time_to_sleep = 0.0
        if elapsed < self._target:
            if self._slow:
                self._slow = False
                self._logger("recovered!", True)
            time_to_sleep = self._target - elapsed
        elif self._target > 0 and not self._slow:
            self._slow = True
            self._logger("too slow! dropped frames!", True)

        if time_to_sleep > 0:
            time.sleep(time_to_sleep)

        self._last_time = time.monotonic()
        return int(self._last_time * 1000)


CaptureYield = Union[
    Tuple[str, int, Union[ndarray, Sequence[ndarray]]],
    Tuple[str, int, Union[ndarray, Sequence[ndarray]], Sequence[str]],
]


class CaptureSource:
    """Base class for capture sources. Subclass and register UDLs."""

    def __init__(self) -> None:
        name = self.__class__.__name__
        self._logger: Logger = getattr(auvlog.vision.capture_source, name)
        self._frameworks: Dict[str, BlockAccessor] = {}
        self._threads: List[threading.Thread] = []
        self._quit_flag = threading.Event()

    @property
    def quit_flag(self) -> threading.Event:
        return self._quit_flag

    def run_event_loop(self) -> None:
        def signal_handler(sig, frame):
            print("\n\nCtrl-C Caught")
            self._quit_flag.set()

        try:
            signal.signal(signal.SIGINT, signal_handler)
        except ValueError:
            pass  # not the main thread (e.g. under a test harness)

        for t in self._threads:
            t.start()

        while not self._quit_flag.is_set():
            time.sleep(0.1)

        for t in self._threads:
            t.join()
        self._close_frameworks()
        self._logger("graceful shut down", True)

    def register_logical_udl(
        self,
        udl: Callable[[FpsLimiter, Tuple[Any, ...]], None],
        args: Tuple[Any, ...] = (),
    ) -> None:
        def callback() -> None:
            fps_limiter = FpsLimiter("", self._quit_flag)
            try:
                udl(fps_limiter, args)
            except Exception:
                self._logger(
                    "Caught exception printing stack trace and unwinding ..."
                )
                traceback.print_exc()
                self._quit_flag.set()

        self._threads.append(threading.Thread(target=callback))

    def register_capture_udl(
        self,
        name: str,
        udl: Callable[
            [FpsLimiter, Tuple[Any, ...]], Generator[CaptureYield, None, None]
        ],
        args: Tuple[Any, ...] = (),
    ) -> None:
        def callback() -> None:
            self._logger(f"starting capture udl '{name}'", True)
            fps_limiter = FpsLimiter(name, self._quit_flag)
            try:
                for yielded in udl(fps_limiter, args):
                    if not isinstance(yielded, tuple):
                        raise RuntimeError(
                            f"capture UDL '{name}' yielded unsupported type "
                            f"{type(yielded)}"
                        )
                    if len(yielded) == 3:
                        direction, acquisition_time, img = yielded
                        names = None
                    elif len(yielded) == 4:
                        direction, acquisition_time, img, names = yielded
                    else:
                        raise RuntimeError(
                            f"capture UDL '{name}' yielded tuple of unexpected "
                            f"length {len(yielded)}"
                        )
                    self._send(direction, acquisition_time, img, names)
            except Exception:
                self._logger(
                    f"Caught exception in {name} printing stack trace and "
                    "unwinding ..."
                )
                traceback.print_exc()
                self._quit_flag.set()

            ive_set = not self._quit_flag.is_set()
            self._quit_flag.set()
            if ive_set:
                self._logger(f"capture udl '{name}' exhausted", True)
            else:
                self._logger(
                    f"capture udl '{name}' stopped as a result of another "
                    "stop signal",
                    True,
                )

        self._threads.append(threading.Thread(target=callback))

    def _send(
        self,
        direction: str,
        acquisition_time: int,
        img: Union[ndarray, Sequence[ndarray]],
        names: Optional[Sequence[str]] = None,
    ) -> None:
        if isinstance(img, ndarray):
            planes: Tuple[ndarray, ...] = (img,)
        elif isinstance(img, Sequence):
            if len(img) == 0:
                raise ValueError("capture source yielded an empty frame sequence")
            for idx, plane in enumerate(img):
                if not isinstance(plane, ndarray):
                    raise TypeError(
                        f"frame at index {idx} for direction '{direction}' is "
                        "not an ndarray"
                    )
            planes = tuple(img)
        else:
            raise TypeError(
                f"unsupported frame type {type(img)} for direction '{direction}'"
            )

        if direction not in self._frameworks:
            # Lazily size the block to the first frame, with the native
            # per-plane 128-byte alignment accounted for.
            from .bindings.frame_bus import frame_bytes

            total_bytes = frame_bytes(
                *((plane.shape, plane.dtype) for plane in planes)
            )
            if total_bytes <= 0:
                raise ValueError(
                    f"total serialized size for direction '{direction}' must "
                    "be positive"
                )
            # 8 ring slots (vs the bus default 4): gives downstream latest-K
            # batching readers (@device_fn(batch=N)) a stable window of 7
            # frames before the writer laps them; ~8 frames of /dev/shm.
            slots = int(os.environ.get("CUAUV_BUS_SLOTS", "8"))
            accessor = BlockAccessor(
                direction,
                max_entry_size_bytes=total_bytes,
                slot_count=slots,
            )
            accessor.__enter__()
            self._frameworks[direction] = accessor

        payload: Union[
            ndarray, Tuple[ndarray, ...], Tuple[Tuple[str, ndarray], ...]
        ]
        tracer.instant("frame", direction=direction, t=acquisition_time)
        if names is not None:
            if len(names) != len(planes):
                raise ValueError(
                    f"direction '{direction}' provided {len(planes)} planes "
                    f"but {len(names)} names"
                )
            payload = tuple((n, p) for n, p in zip(names, planes))
        else:
            payload = planes[0] if len(planes) == 1 else planes
        self._frameworks[direction].write_frame(acquisition_time, payload)

    def _close_frameworks(self) -> None:
        for accessor in self._frameworks.values():
            accessor.__exit__(None, None, None)
        self._frameworks.clear()

    def __del__(self) -> None:
        self._close_frameworks()
