"""Dynamically resizable thread pool.

Port of ``cuauv_vision_pipeline_tpu.misc.resizable_tpool``, a copy. Parity
target: the reference vendors a forked eventlet tpool that can grow
its thread count at runtime for the WebGUI stack
(reference resizable_eventlet_tpool.py:1-5). Eventlet isn't in this
environment; this is a plain-threading equivalent with the same capability:
``execute()`` proxies blocking calls into the pool, ``set_num_threads``
grows/shrinks it live.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Any, Callable, List


class ResizableThreadPool:
    def __init__(self, num_threads: int = 4):
        self._tasks: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._workers: List[threading.Thread] = []
        self._target = 0
        self.set_num_threads(num_threads)

    def _worker(self) -> None:
        while True:
            item = self._tasks.get()
            if item is None:  # shrink signal
                with self._lock:
                    if len(self._workers) > self._target:
                        try:
                            self._workers.remove(threading.current_thread())
                        except ValueError:
                            pass
                        return
                continue
            future, fn, args, kwargs = item
            if future.set_running_or_notify_cancel():
                try:
                    future.set_result(fn(*args, **kwargs))
                except BaseException as e:  # deliver into the future
                    future.set_exception(e)

    def set_num_threads(self, n: int) -> None:
        """Grow or shrink the pool to n threads (live)."""
        assert n >= 0
        with self._lock:
            self._target = n
            while len(self._workers) < n:
                t = threading.Thread(target=self._worker, daemon=True)
                self._workers.append(t)
                t.start()
            excess = len(self._workers) - n
        for _ in range(max(0, excess)):
            self._tasks.put(None)

    @property
    def num_threads(self) -> int:
        with self._lock:
            return len(self._workers)

    def submit(self, fn: Callable, *args: Any, **kwargs: Any) -> Future:
        future: Future = Future()
        self._tasks.put((future, fn, args, kwargs))
        return future

    def execute(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        """Blocking proxy call (the eventlet tpool.execute shape)."""
        return self.submit(fn, *args, **kwargs).result()
