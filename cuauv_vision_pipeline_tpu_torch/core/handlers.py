"""Handler hooks: pluggable post-processors that impersonate a module.

Copy of ``cuauv_vision_pipeline_tpu.core.handlers``.

Behavioral parity with the reference handler system (reference
core/handlers.py:18-100): a HandlerBase gains the parent module's
``normalize_axis/normalize/post/tuners/get_latency`` on ``register`` so the
handler body reads like a vision module; ``HandlerMixin`` indexes handlers by
unique name and registers each against the mixing module. The primary use is
YOLO post-processing (reference modules/yolo.py:155-163).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional

import numpy as np


class HandlerBase(ABC):
    def __init__(self, name: str, parent: Optional[object] = None):
        """A handler for a module. If ``parent`` is None (the common case),
        :meth:`register` must be called before use — HandlerMixin does this.
        """
        self._name = name
        self._parent = parent
        if parent is not None:
            self._initialize_methods()

    def register(self, parent: object) -> None:
        self._parent = parent
        self._initialize_methods()

    def _initialize_methods(self) -> None:
        """Proxy the parent module's capabilities onto the handler so it can
        be written like a module (reference core/handlers.py:48-58)."""
        parent = self._parent
        self.normalize_axis = parent.normalize_axis
        self.normalize = parent.normalize
        self.post = parent.post
        self.tuners = parent.tuners
        self.get_latency = parent.get_latency

    @property
    def performance(self) -> bool:
        """True when the parent module runs in performance mode: posts are
        no-ops, so handlers should skip annotation work (image copies,
        polyline rasterization) and only write shm results — measured at
        ~3-8 ms of drawing per detection otherwise."""
        return bool(getattr(self._parent, "_performance_enabled", False))

    @abstractmethod
    def process(self, direction: str, image: np.ndarray, *args, **kwargs):
        """Process step; the parent module decides when to call this and with
        which extra detection arguments."""
        raise NotImplementedError("HandlerBase.process")

    @property
    def name(self) -> str:
        return self._name


class HandlerMixin:
    def __init__(self, handlers: List[HandlerBase] = []):
        self._handlers: Dict[str, HandlerBase] = {}
        self._handler_names = set()
        for handler in handlers:
            if handler.name in self._handler_names:
                raise KeyError("Duplicate handler names found!")
            self._handlers[handler.name] = handler
            self._handler_names.add(handler.name)

        for handler in self._handlers.values():
            handler.register(self)

    @property
    def handlers(self) -> Dict[str, HandlerBase]:
        return self._handlers

    @property
    def handler_names(self):
        return self._handler_names
