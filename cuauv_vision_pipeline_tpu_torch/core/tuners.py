"""Live-tunable module parameters, serialized through frame-bus blocks.

Behavioral parity with the reference tuner system (reference core/tuners.py):

* ``TunerBase(name, default)`` with ``serialize()/deserialize()/byte_size()``
  and ``value``; the tuner *type* is encoded in ``str(tuner)`` as
  ``ClassName_name`` and ends up in the tune-block name
  (reference core/tuners.py:25-26, core/base.py:204-210).
* ``IntTuner``/``DoubleTuner`` pack ``{len}s`` + value/min/max (``iii``/
  ``ddd``) and clamp updates through a validator
  (reference core/tuners.py:49-112).
* ``BoolTuner`` packs ``{len}s?`` (reference core/tuners.py:115-135).
* names may not contain spaces or slashes (reference core/tuners.py:12-13).

``tuner_from_bytes`` here actually dispatches on the type name — the
reference's version is a stubbed leftover (reference core/tuners.py:138-155).
"""

from __future__ import annotations

import struct
from abc import ABC, abstractmethod
from typing import Callable, Generic, TypeVar

T = TypeVar("T")


class TunerBase(ABC, Generic[T]):
    def __init__(self, name: str, default_value: T):
        assert name.count(" ") == 0, f"Tuner name '{name}' cannot have spaces"
        assert name.count("/") == 0, f"Tuner name '{name}' cannot have slashes"
        assert name.count("%") == 0, f"Tuner name '{name}' cannot have percents"
        self._name = name
        self._current_value = default_value

    def __hash__(self) -> int:
        return hash(str(self))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, self.__class__) and self._name == other._name

    def __str__(self) -> str:
        return f"{self.__class__.__name__}_{self._name}"

    @property
    def name(self) -> str:
        return self._name

    @property
    def value(self) -> T:
        return self._current_value

    @abstractmethod
    def byte_size(self) -> int:
        raise NotImplementedError

    @abstractmethod
    def serialize(self) -> bytes:
        raise NotImplementedError

    @abstractmethod
    def deserialize(self, buffer: bytes) -> None:
        raise NotImplementedError


class IntTuner(TunerBase[int]):
    def __init__(
        self,
        name: str,
        default_value: int,
        min_value: int = 0,
        max_value: int = 255,
        validator: Callable[[int], bool] = lambda x: True,
    ):
        assert min_value <= max_value, (
            f"min value = {min_value} is not leq to max value = {max_value}"
        )
        super().__init__(name, default_value)
        self._min_value = min_value
        self._max_value = max_value
        self._packing_format = f"{len(self._name)}siii"
        self._validator = lambda x: validator(x) and min_value <= x <= max_value

    @property
    def min_value(self) -> int:
        return self._min_value

    @property
    def max_value(self) -> int:
        return self._max_value

    def byte_size(self) -> int:
        return struct.calcsize(self._packing_format)

    def serialize(self) -> bytes:
        return struct.pack(
            self._packing_format,
            self._name.encode(),
            self._current_value,
            self._min_value,
            self._max_value,
        )

    def deserialize(self, buffer: bytes) -> None:
        name, current_value, self._min_value, self._max_value = struct.unpack(
            self._packing_format, buffer
        )
        self._name = name.decode()
        if self._validator(current_value):
            self._current_value = current_value


class DoubleTuner(TunerBase[float]):
    def __init__(
        self,
        name: str,
        default_value: float,
        min_value: float = -10_000,
        max_value: float = 10_000,
        validator: Callable[[float], bool] = lambda x: True,
    ):
        assert min_value <= max_value, (
            f"min value = {min_value} is not leq to max value = {max_value}"
        )
        super().__init__(name, default_value)
        self._min_value = min_value
        self._max_value = max_value
        self._packing_format = f"{len(self._name)}sddd"
        self._validator = lambda x: validator(x) and min_value <= x <= max_value

    @property
    def min_value(self) -> float:
        return self._min_value

    @property
    def max_value(self) -> float:
        return self._max_value

    def byte_size(self) -> int:
        return struct.calcsize(self._packing_format)

    def serialize(self) -> bytes:
        return struct.pack(
            self._packing_format,
            self._name.encode(),
            self._current_value,
            self._min_value,
            self._max_value,
        )

    def deserialize(self, buffer: bytes) -> None:
        name, current_value, self._min_value, self._max_value = struct.unpack(
            self._packing_format, buffer
        )
        self._name = name.decode()
        if self._validator(current_value):
            self._current_value = current_value


class BoolTuner(TunerBase[bool]):
    def __init__(self, name: str, default_value: bool):
        super().__init__(name, default_value)
        self._packing_format = f"{len(self._name)}s?"

    def byte_size(self) -> int:
        return struct.calcsize(self._packing_format)

    def serialize(self) -> bytes:
        return struct.pack(
            self._packing_format, self._name.encode(), self._current_value
        )

    def deserialize(self, buffer: bytes) -> None:
        name, current_value = struct.unpack(self._packing_format, buffer)
        self._name = name.decode()
        self._current_value = current_value


def tuner_from_bytes(type_and_name: str, data: bytes) -> TunerBase:
    """Reconstruct a tuner from its block-name type tag and serialized bytes.

    ``type_and_name`` is the ``ClassName_name`` string embedded in the tune
    block name (e.g. ``IntTuner_thresh_min``).
    """
    tuner_type, tuner_name = type_and_name.split("_", maxsplit=1)
    tuner: TunerBase
    if tuner_type == "IntTuner":
        tuner = IntTuner(tuner_name, 0)
    elif tuner_type == "DoubleTuner":
        tuner = DoubleTuner(tuner_name, 0.0)
    elif tuner_type == "BoolTuner":
        tuner = BoolTuner(tuner_name, False)
    else:
        raise ValueError(f"'{type_and_name}' is not a valid tuner tag")
    tuner.deserialize(data)
    return tuner
