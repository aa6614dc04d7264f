"""Python binding for the native frame bus (libframebus.so), over ctypes.

The C ABI is ``native/src/framebus_c.cpp``; the structs below mirror it
field for field.

Behavioral parity with the reference's BlockAccessor binding
(reference: core/bindings/camera_message_framework.py:73-441):

* ``BlockAccessor(direction, max_entry_size_bytes=None, ...)`` — ``None``
  means *open mode* with a 1 Hz retry loop until the block appears
  (reference bindings:399-416); an integer means *create mode*.
* ``write_frame(time_ms, frame)`` accepts a single ndarray, a sequence of
  ndarrays, or a sequence of ``(name, ndarray)`` pairs; 1-3 dims.
* ``read_frame() -> (ReadStatus, payload, acquisition_time_ms)`` where the
  payload is a single ndarray (one plane) or a tuple of ndarrays.
* context-manager enforced access; ``ReadStatus``/``WriteStatus`` enums;
  ``BLOCK_STUB``; latest-wins / NO_NEW_FRAME / FRAMEWORK_DELETED semantics.

Differences from the reference (new capabilities, not translations):

* **staging reads** — ``read_frame`` lands frame bytes directly in a
  reusable staging buffer via the native ``read_frame_into``, and the
  returned arrays are *writable* views into it. This removes the
  reference's defensive second copy (reference core/base.py:761-768) and
  gives the engine a stable host buffer for the host-to-device copy.
* 2-byte dtypes (float16/bfloat16 payloads) are supported in addition to
  the reference's 1/4/8-byte widths.
* configurable ring depth (``slot_count``) for latest-K batching readers.
"""

from __future__ import annotations

import enum
import sys
import time
from typing import Any, List, Optional, Sequence, Tuple, Union

import ctypes

import numpy as np

from ...native import library_path

_c = ctypes
_P = _c.c_void_p  # every pointer (Bus*, data buffers) crosses as a void*


class CFramePlane(_c.Structure):
    _fields_ = [
        ("width", _c.c_size_t),
        ("height", _c.c_size_t),
        ("depth", _c.c_size_t),
        ("type_size", _c.c_size_t),
        ("offset", _c.c_size_t),
        ("name", _c.c_char * 32),
    ]


class CFrame(_c.Structure):
    _fields_ = [
        ("width", _c.c_size_t),
        ("height", _c.c_size_t),
        ("depth", _c.c_size_t),
        ("type_size", _c.c_size_t),
        ("acquisition_time", _c.c_uint64),
        ("uid", _c.c_uint64),
        ("data", _P),
        ("total_size", _c.c_size_t),
        ("plane_count", _c.c_size_t),
        ("planes", CFramePlane * 8),
        ("impl", _P),
    ]


class CFramePlaneWrite(_c.Structure):
    _fields_ = [
        ("width", _c.c_size_t),
        ("height", _c.c_size_t),
        ("depth", _c.c_size_t),
        ("type_size", _c.c_size_t),
        ("data", _P),
        ("name", _c.c_char_p),
    ]


_FRAME = _c.POINTER(CFrame)
_SIGNATURES = {
    "create_block": (_P, [_c.c_char_p, _c.c_size_t]),
    "create_block_slots": (_P, [_c.c_char_p, _c.c_size_t, _c.c_uint32]),
    "open_block": (_P, [_c.c_char_p]),
    "delete_block": (None, [_P]),
    "write_frame_planes": (
        _c.c_int, [_P, _c.c_uint64, _c.POINTER(CFramePlaneWrite), _c.c_size_t]
    ),
    "read_frame": (_c.c_int, [_P, _FRAME, _c.c_bool]),
    "read_frame_into": (_c.c_int, [_P, _FRAME, _P, _c.c_size_t, _c.c_bool]),
    "read_frame_batch_into": (
        _c.c_int,
        [_P, _FRAME, _P, _c.c_size_t, _c.c_uint32,
         _c.POINTER(_c.c_uint64), _c.POINTER(_c.c_uint32), _c.c_bool],
    ),
    "create_frame": (_FRAME, []),
    "delete_frame": (None, [_FRAME]),
    "block_max_entry_size": (_c.c_size_t, [_P]),
    "block_latest_uid": (_c.c_uint64, [_P]),
}

_dllib: Any = _c.CDLL(library_path())
for _name, (_restype, _argtypes) in _SIGNATURES.items():
    _fn = getattr(_dllib, _name)
    _fn.restype = _restype
    _fn.argtypes = _argtypes


def _const(name: str) -> int:
    return _c.c_int.in_dll(_dllib, name).value


_SUCCESS = _const("SUCCESS")
_FRAMEBUS_ERROR = _const("FRAMEBUS_ERROR")


class ReadStatus(enum.Enum):
    """Read status of the frame bus (reference bindings:73-78)."""

    SUCCESS = _SUCCESS
    NO_NEW_FRAME = _const("NO_NEW_FRAME")
    FRAMEWORK_DELETED = _const("FRAMEWORK_DELETED")
    ERROR = _FRAMEBUS_ERROR


class WriteStatus(enum.Enum):
    """Write status of the frame bus (reference bindings:81-85)."""

    SUCCESS = _SUCCESS
    FRAMEWORK_DELETED = _const("FRAMEWORK_DELETED")
    ERROR = _FRAMEBUS_ERROR


BLOCK_STUB: str = _c.c_char_p.in_dll(_dllib, "BLOCK_STUB_CSTR").value.decode()

MAX_PLANE_CNT = 8
_DATA_ALIGN = 128


def encode_str(s: str) -> np.ndarray:
    """Encode a string as a uint8 ndarray (reference bindings:91-101)."""
    return np.frombuffer(s.encode("utf-8"), dtype=np.uint8)


def decode_str(arr: np.ndarray) -> str:
    """Decode a uint8 ndarray back into a string (reference bindings:104-114)."""
    return arr.tobytes().decode("utf-8")


def _align_up(v: int, a: int = _DATA_ALIGN) -> int:
    return (v + a - 1) // a * a


def frame_bytes(*shapes_dtypes: Tuple[Tuple[int, ...], Any]) -> int:
    """Compute the max_entry_size needed to hold the given planes, matching
    the native 128-byte per-plane alignment."""
    total = 0
    for shape, dtype in shapes_dtypes:
        total += _align_up(int(np.prod(shape)) * np.dtype(dtype).itemsize)
    return total


class BlockAccessor:
    """Shared-memory frame block accessor (create or open mode).

    Supports numpy planes of 1-3 dimensions with element widths of 1, 2, 4,
    or 8 bytes. Access only inside a context manager.
    """

    def __init__(
        self,
        direction: str,
        max_entry_size_bytes: Optional[int] = None,
        byte_type: type = np.uint8,
        half_type: type = np.float16,
        short_type: type = np.float32,
        long_type: type = np.float64,
        block_thread: bool = False,
        slot_count: int = 0,
        staging: bool = True,
    ):
        assert (max_entry_size_bytes is None) or (
            max_entry_size_bytes > 0
        ), "max_entry_size_bytes, when specified, should be a positive integer"
        assert np.dtype(byte_type).itemsize == 1, "byte type must be 1 byte wide"
        assert np.dtype(half_type).itemsize == 2, "half type must be 2 bytes wide"
        assert np.dtype(short_type).itemsize == 4, "short type must be 4 bytes wide"
        assert np.dtype(long_type).itemsize == 8, "long type must be 8 bytes wide"

        self._direction = direction
        self._max_entry_size_bytes = max_entry_size_bytes
        self._slot_count = slot_count
        self._type_lookup = {
            1: byte_type,
            2: half_type,
            4: short_type,
            8: long_type,
        }
        self._staging_enabled = staging
        self._staging: Optional[np.ndarray] = None
        # staging rotation: with depth N, views from the last N reads stay
        # valid — required when an async host-to-device copy may
        # still be reading a previous frame's staging buffer while the next
        # read_frame lands bytes (the engine's pipelined fast path)
        self._staging_pool: List[np.ndarray] = []
        self._staging_idx = 0
        self._staging_depth = 1
        self._batch_staging_pool: List[np.ndarray] = []
        self._batch_staging_idx = 0
        # writer-side fault injection (None unless $CUAUV_BUS_FAULTS is set)
        from .fault_injection import FaultPlan

        self._faults = FaultPlan.from_env()

        self._inside_ctx_manager = False
        self._block_ptr: Optional[int] = None
        self._frame_ptr: Any = None
        self._frame_data: Optional[Union[np.ndarray, Tuple[np.ndarray, ...]]] = None
        self._last_plane_names: Tuple[str, ...] = tuple()
        self._block_thread = block_thread
        self._acquisition_time: int = 0

    # -- properties / builder ------------------------------------------------

    @property
    def direction(self) -> str:
        return self._direction

    def block_thread(self) -> "BlockAccessor":
        """Builder: let read_frame block briefly when no new frame exists."""
        self._block_thread = True
        return self

    def unblock_thread(self) -> "BlockAccessor":
        """Builder: make read_frame return immediately when no new frame."""
        self._block_thread = False
        return self

    def last_plane_names(self) -> Tuple[str, ...]:
        return self._last_plane_names

    def set_staging_depth(self, depth: int) -> "BlockAccessor":
        """Keep the last ``depth`` reads' staging buffers alive.

        Views returned by ``read_frame`` stay valid for the next
        ``depth - 1`` successful reads instead of just until the next one —
        the contract a depth-N StreamExecutor needs while transfers are in
        flight.
        """
        if depth < 1:
            raise ValueError("staging depth must be >= 1")
        self._staging_depth = depth
        return self

    @property
    def latest_uid(self) -> int:
        if self._block_ptr is None:
            return 0
        return int(_dllib.block_latest_uid(self._block_ptr))

    @property
    def last_frame_data(
        self,
    ) -> Optional[Union[np.ndarray, Tuple[np.ndarray, ...]]]:
        """Payload of the most recent successful read (what ``read_frame``
        re-returns on NO_NEW_FRAME); None before the first frame."""
        return self._frame_data

    @property
    def last_acquisition_time(self) -> int:
        """Acquisition stamp (ms) of the most recent successful read."""
        return self._acquisition_time

    @property
    def max_entry_size(self) -> int:
        if self._block_ptr is None:
            return 0
        return int(_dllib.block_max_entry_size(self._block_ptr))

    # -- write ----------------------------------------------------------------

    def write_frame(
        self,
        acquisition_time_ms: int,
        frame: Union[
            np.ndarray,
            Sequence[np.ndarray],
            Sequence[Tuple[str, np.ndarray]],
        ],
    ) -> WriteStatus:
        """Write one or more numpy planes into the block (latest-wins)."""
        self._require_ctx()

        plane_names: List[str] = []
        planes: List[np.ndarray] = []
        if isinstance(frame, np.ndarray):
            planes = [frame]
            plane_names = [""]
        elif isinstance(frame, Sequence):
            if len(frame) == 0:
                raise ValueError("empty frame sequence passed to write_frame")
            for idx, item in enumerate(frame):
                if (
                    isinstance(item, tuple)
                    and len(item) == 2
                    and isinstance(item[0], str)
                    and isinstance(item[1], np.ndarray)
                ):
                    plane_names.append(item[0])
                    planes.append(item[1])
                elif isinstance(item, np.ndarray):
                    plane_names.append("")
                    planes.append(item)
                else:
                    raise TypeError(
                        f"frame at index {idx} must be an ndarray or (name, ndarray)"
                    )
        else:
            raise TypeError("frame must be an ndarray or a sequence of ndarrays")

        if len(planes) > MAX_PLANE_CNT:
            raise RuntimeError(
                f"{len(planes)} planes exceeds the bus limit of {MAX_PLANE_CNT}"
            )

        if self._faults is not None:
            faulted = self._faults.apply_write(planes)
            if faulted is None:
                return WriteStatus.SUCCESS  # dropped: producer never saw it
            planes = faulted

        plane_array = (CFramePlaneWrite * len(planes))()
        keepalive: List[Any] = []
        for idx, plane in enumerate(planes):
            contiguous = np.ascontiguousarray(plane)
            if contiguous.ndim == 0 or contiguous.ndim > 3:
                raise RuntimeError(
                    f"plane {idx} has {contiguous.ndim} dims, expected 1-3"
                )
            if contiguous.itemsize not in self._type_lookup:
                raise RuntimeError(
                    f"plane {idx} has unsupported element width "
                    f"{contiguous.itemsize} bytes"
                )
            height = contiguous.shape[0]
            width = contiguous.shape[1] if contiguous.ndim > 1 else 1
            depth = contiguous.shape[2] if contiguous.ndim > 2 else 1

            name_c = plane_names[idx].encode("utf-8")
            keepalive.extend((contiguous, name_c))
            plane_array[idx].width = width
            plane_array[idx].height = height
            plane_array[idx].depth = depth
            plane_array[idx].type_size = contiguous.itemsize
            plane_array[idx].data = contiguous.ctypes.data
            plane_array[idx].name = name_c

        status = _dllib.write_frame_planes(
            self._block_ptr,
            int(acquisition_time_ms),
            plane_array,
            len(planes),
        )
        if status == _FRAMEBUS_ERROR:
            raise RuntimeError(
                f"write to '{self._direction}' failed (frame exceeds the "
                f"block's max_entry_size of {self.max_entry_size} bytes?)"
            )
        return WriteStatus(status)

    # -- read -----------------------------------------------------------------

    def read_frame(
        self,
    ) -> Tuple[ReadStatus, Optional[Union[np.ndarray, Tuple[np.ndarray, ...]]], int]:
        """Read the newest frame, if newer than the last one consumed.

        Returns (status, payload, acquisition_time_ms). The payload arrays are
        views into this accessor's staging buffer: valid and writable until
        the next read_frame call on this accessor.
        """
        self._require_ctx()

        if self._staging_enabled:
            need = max(self.max_entry_size, 1)
            slot = self._staging_idx % self._staging_depth
            while len(self._staging_pool) <= slot:
                self._staging_pool.append(np.empty(need, dtype=np.uint8))
            if self._staging_pool[slot].nbytes < need:
                self._staging_pool[slot] = np.empty(need, dtype=np.uint8)
            self._staging = self._staging_pool[slot]
            status_i = _dllib.read_frame_into(
                self._block_ptr,
                self._frame_ptr,
                self._staging.ctypes.data,
                self._staging.nbytes,
                self._block_thread,
            )
        else:
            status_i = _dllib.read_frame(
                self._block_ptr, self._frame_ptr, self._block_thread
            )

        status = ReadStatus(status_i)
        if status != ReadStatus.SUCCESS:
            return status, self._frame_data, self._acquisition_time

        frame = self._frame_ptr.contents
        acquisition_time = int(frame.acquisition_time)
        plane_count = int(frame.plane_count)
        total_bytes = int(frame.total_size)

        if plane_count == 0 or total_bytes == 0:
            self._frame_data = None
            self._acquisition_time = acquisition_time
            self._last_plane_names = tuple()
            return status, None, acquisition_time

        if self._staging_enabled:
            backing = self._staging
        else:
            raw = (_c.c_uint8 * total_bytes).from_address(frame.data)
            backing = np.frombuffer(raw, dtype=np.uint8)

        planes: List[np.ndarray] = []
        names: List[str] = []
        for idx in range(plane_count):
            meta = frame.planes[idx]
            width = int(meta.width)
            height = int(meta.height)
            depth = int(meta.depth)
            itemsize = int(meta.type_size)
            offset = int(meta.offset)
            names.append(meta.name.decode())

            dtype = self._type_lookup.get(itemsize)
            if dtype is None:
                raise RuntimeError(
                    f"unsupported type size {itemsize} reading plane {idx}"
                )
            nbytes = width * height * depth * itemsize
            if offset + nbytes > total_bytes:
                raise RuntimeError(
                    f"plane {idx} ({nbytes} B at offset {offset}) exceeds "
                    f"frame size {total_bytes}"
                )
            view = backing[offset : offset + nbytes].view(dtype)
            planes.append(view.reshape(height, width, depth))

        self._acquisition_time = acquisition_time
        self._frame_data = planes[0] if plane_count == 1 else tuple(planes)
        self._last_plane_names = tuple(names)
        if self._staging_enabled:
            self._staging_idx += 1  # next read lands in the next pool slot
        return status, self._frame_data, self._acquisition_time

    def read_frame_batch(
        self, max_frames: int
    ) -> Tuple[
        ReadStatus,
        List[Union[np.ndarray, Tuple[np.ndarray, ...]]],
        List[int],
    ]:
        """Drain up to ``max_frames`` unseen frames in ONE native call
        (oldest first) — the latest-K reader behind queue-depth batching.

        Returns (status, frames, acq_times_ms); ``frames[i]`` is the i-th
        frame's payload (ndarray, or tuple of plane ndarrays), each a view
        into one row of a contiguous ``[max_frames, stride]`` staging
        buffer. Single-plane batches are therefore strided slices of ONE
        buffer and stack into a ``[B, H, W, C]`` batch without copying when
        stride == frame bytes. Views stay valid for ``staging_depth - 1``
        further batch reads (same contract as read_frame).
        """
        self._require_ctx()
        if max_frames < 1:
            raise ValueError("max_frames must be >= 1")

        stride = max(self.max_entry_size, 1)
        need = stride * max_frames
        slot = self._batch_staging_idx % self._staging_depth
        while len(self._batch_staging_pool) <= slot:
            self._batch_staging_pool.append(np.empty(need, dtype=np.uint8))
        if self._batch_staging_pool[slot].nbytes < need:
            self._batch_staging_pool[slot] = np.empty(need, dtype=np.uint8)
        staging = self._batch_staging_pool[slot]
        acqs_c = (_c.c_uint64 * max_frames)()
        count_c = _c.c_uint32(0)
        status_i = _dllib.read_frame_batch_into(
            self._block_ptr,
            self._frame_ptr,
            staging.ctypes.data,
            stride,
            max_frames,
            acqs_c,
            _c.byref(count_c),
            self._block_thread,
        )
        status = ReadStatus(status_i)
        if status != ReadStatus.SUCCESS:
            return status, [], []

        count = int(count_c.value)
        frame = self._frame_ptr.contents
        plane_count = int(frame.plane_count)
        total_bytes = int(frame.total_size)
        if count == 0 or plane_count == 0 or total_bytes == 0:
            return ReadStatus.NO_NEW_FRAME, [], []

        metas = []
        for idx in range(plane_count):
            m = frame.planes[idx]
            dtype = self._type_lookup.get(int(m.type_size))
            if dtype is None:
                raise RuntimeError(
                    f"unsupported type size {int(m.type_size)} in batch read"
                )
            metas.append(
                (int(m.width), int(m.height), int(m.depth), int(m.offset),
                 dtype, int(m.type_size))
            )
        self._last_plane_names = tuple(
            frame.planes[i].name.decode()
            for i in range(plane_count)
        )

        frames: List[Union[np.ndarray, Tuple[np.ndarray, ...]]] = []
        for i in range(count):
            row = staging[i * stride : i * stride + total_bytes]
            planes = []
            for w, h, d, off, dtype, ts in metas:
                nbytes = w * h * d * ts
                planes.append(
                    row[off : off + nbytes].view(dtype).reshape(h, w, d)
                )
            frames.append(planes[0] if plane_count == 1 else tuple(planes))
        acqs = [int(acqs_c[i]) for i in range(count)]
        self._acquisition_time = acqs[-1]
        self._frame_data = frames[-1]
        self._batch_staging_idx += 1
        return status, frames, acqs

    # -- context management -----------------------------------------------

    def _require_ctx(self) -> None:
        if not self._inside_ctx_manager:
            raise RuntimeError(
                "Attempted to access block while not in a context manager: "
                f"{__file__}:{sys._getframe(2).f_lineno}"
            )

    def __enter__(self) -> "BlockAccessor":
        if self._inside_ctx_manager:
            raise RuntimeError(
                f"Double dip in context manager: {__file__}:"
                f"{sys._getframe(1).f_lineno}"
            )

        name_c = self._direction.encode("utf-8")
        if self._max_entry_size_bytes is None:
            # Open mode: retry at 1 Hz until the block appears
            # (reference bindings:399-416).
            retried = False
            retry_count = 0
            self._block_ptr = _dllib.open_block(name_c)
            while self._block_ptr is None:
                retry_count += 1
                print(
                    f"trying again to access {self._direction} in 1s, "
                    f"retry count={retry_count:<2}",
                    end="\r",
                    flush=True,
                )
                retried = True
                time.sleep(1)
                self._block_ptr = _dllib.open_block(name_c)
            if retried:
                print(f"\nfound {self._direction}!!!", flush=True)
        else:
            if self._slot_count > 0:
                self._block_ptr = _dllib.create_block_slots(
                    name_c,
                    self._max_entry_size_bytes,
                    self._slot_count,
                )
            else:
                self._block_ptr = _dllib.create_block(
                    name_c, self._max_entry_size_bytes
                )
            if self._block_ptr is None:
                raise RuntimeError(f"Failed to access {self._direction}")

        self._frame_ptr = _dllib.create_frame()
        self._acquisition_time = 0
        self._frame_data = None
        self._inside_ctx_manager = True
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        if self._block_ptr is not None:
            _dllib.delete_block(self._block_ptr)
        if self._frame_ptr:
            _dllib.delete_frame(self._frame_ptr)
        self._block_ptr = None
        self._frame_ptr = None
        self._inside_ctx_manager = False

    def __str__(self) -> str:
        type_str = ":".join(
            f"{size}->{np.dtype(dtype).name}"
            for size, dtype in sorted(self._type_lookup.items())
        )
        return f"Accessor(direction={self._direction}, datatypes={type_str})"
