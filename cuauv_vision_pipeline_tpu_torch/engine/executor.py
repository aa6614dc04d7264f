"""Device executors: a chain on one device + software-pipelined streaming.

Port of ``cuauv_vision_pipeline_tpu.engine.executor``. The reference overlaps
SDK retrieval with postprocessing using a double-buffered thread pool
(reference capture_sources/zed.py:14-20, 129-253). With PyTorch on CUDA the
same overlap comes from asynchronous launches: ``submit`` copies a frame to
the device and enqueues its chain without waiting, records a CUDA event
behind it, and materializes older results only later — so the card computes
frame N while the host reads frame N+1 off the bus.

* **packed results** (``pack_result``/``unpack_result``): every leaf of a
  result tree is packed at native width into ONE byte vector on the
  device, so a whole result (multi-megabyte u8 debug images included)
  costs one device-to-host copy.
* **async fetch** (``StreamExecutor(async_fetch=True)``): a worker thread
  waits on each dispatch's CUDA event and then copies the result, so the
  next frame's upload and launches overlap the previous readback.
* **spans** (``core/trace.py``, recorded while the tracer is enabled), each
  with the ``dispatch`` id ``submit`` gives: ``executor.submit`` (args
  ``frames``, ``inflight``), ``executor.h2d`` per camera array (``bytes``),
  ``executor.launch`` (the chain call), ``executor.pack``,
  ``executor.backpressure`` (``submit`` held for a free slot),
  ``executor.event_wait`` and ``executor.d2h`` (``bytes``) on the thread that
  fetches: the worker with async fetch, else the caller.

There is no compile step: ``DevicePipeline.warmup`` just runs the chain once.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core.trace import tracer
from ..utils.tree import TreeDef, tree_flatten, tree_map, tree_unflatten

_ALIGN = 8  # every leaf starts 8-byte aligned in the packed vector


# ---------------------------------------------------------------------------
# result packing: one device->host copy per result tree
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PackSpec:
    """How to cut a packed byte vector back into its tree."""

    treedef: TreeDef
    # per leaf: (shape, numpy dtype, bytes taken in the packed vector)
    leaves: Tuple[Tuple[Tuple[int, ...], np.dtype, int], ...]


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def pack_result(result: Any) -> Tuple[torch.Tensor, PackSpec]:
    """Flatten a result tree of tensors into ONE uint8 vector on their
    device, each leaf at its native width (bools as one byte), zero-padded
    to an 8-byte boundary. Returns ``(packed, spec)``."""
    leaves, treedef = tree_flatten(result)
    metas = []
    parts: List[torch.Tensor] = []
    for leaf in leaves:
        t = torch.as_tensor(leaf)
        flat = t.reshape(-1).contiguous()
        if flat.dtype == torch.bool:
            flat = flat.to(torch.uint8)
        data = flat.view(torch.uint8)
        pad = (-data.numel()) % _ALIGN
        if pad:
            data = torch.cat([data, data.new_zeros(pad)])
        metas.append((tuple(t.shape), _np_dtype(t.dtype), int(data.numel())))
        parts.append(data)
    packed = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.uint8)
    return packed, PackSpec(treedef, tuple(metas))


def unpack_result(packed: np.ndarray, spec: PackSpec) -> Any:
    """Invert :func:`pack_result` on the host (zero-copy numpy views)."""
    packed = np.asarray(packed, dtype=np.uint8)
    out = []
    off = 0
    for shape, dt, nbytes in spec.leaves:
        n = int(np.prod(shape)) if shape else 1
        chunk = packed[off : off + n * dt.itemsize]
        off += nbytes
        out.append(chunk.view(dt).reshape(shape))
    return tree_unflatten(spec.treedef, out)


def _stack_lanes(lanes: List[Any]) -> Any:
    """[tree per lane] -> one tree whose leaves gain a leading lane axis."""
    flat = [tree_flatten(lane) for lane in lanes]
    treedef = flat[0][1]
    stacked = [torch.stack(group) for group in zip(*(leaves for leaves, _ in flat))]
    return tree_unflatten(treedef, stacked)


def _pack(out: Any, stack: bool) -> Tuple[torch.Tensor, PackSpec]:
    """``pack_result`` of a result tree, or of per-lane trees stacked first
    (``stack``), in an ``executor.pack`` span."""
    with tracer.span("executor.pack"):
        return pack_result(_stack_lanes(out) if stack else out)


def build_packed_fn(
    dev_bound: Callable, dev_batch: int, dev_batch_mode: str
) -> Callable:
    """The callable ModuleBase dispatches for a @device_fn: runs the
    module's chain and packs ``(result, posts)`` for one fetch, returning
    ``(packed, spec)``.

    With ``dev_batch > 1`` the first argument is a ``[lanes, ...]`` batch of
    fresh frames: ``"map"`` runs the per-frame chain lane by lane and
    stacks the results, ``"vmap"`` hands the whole batch to the chain (which
    must then accept a leading batch dimension)."""
    if dev_batch > 1:

        def packed_fn(batched, *, tuners, want_posts):
            if dev_batch_mode == "map":
                lanes = [dev_bound(f, tuners=tuners, want_posts=want_posts) for f in batched]
                return _pack(lanes, stack=True)
            return _pack(dev_bound(batched, tuners=tuners, want_posts=want_posts), stack=False)

    else:

        def packed_fn(*frames, tuners, want_posts):
            return _pack(dev_bound(*frames, tuners=tuners, want_posts=want_posts), stack=False)

    return packed_fn


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------


def _to_host(x: Any) -> Any:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def _materialize(result: Any) -> Any:
    return tree_map(_to_host, result)


def _host_bytes(result: Any) -> int:
    return sum(int(x.nbytes) for x in tree_flatten(result)[0] if isinstance(x, np.ndarray))


def dispatch_frames(args: Tuple[Any, ...]) -> int:
    """Frames in one dispatch's camera arrays: a 4-D array is a batch of
    frames along its first axis (``[lanes, H, W, C]``), anything else one
    frame (a bus frame is ``[H, W, C]``)."""
    return sum(int(a.shape[0]) if getattr(a, "ndim", 0) == 4 else 1 for a in args)


class DevicePipeline:
    """A frame chain bound to one device.

    ``fn`` is any callable over tensors. Call sites pass numpy arrays or
    tensors; numpy arrays are copied to ``device`` first. Results are
    device tensors (launched, not waited for)."""

    def __init__(self, fn: Callable, device: torch.device):
        self._fn = fn
        self.device = torch.device(device)

    def to_device(self, a: Any) -> Any:
        if isinstance(a, np.ndarray):
            with tracer.span("executor.h2d", bytes=a.nbytes):
                return torch.from_numpy(a).to(self.device)
        return a

    def warmup(self, *args: Any, **kwargs: Any) -> None:
        """Run the chain once and wait for it (there is nothing to compile;
        this takes first-use costs such as a kernel build off the stream)."""
        self(*args, **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        on_device = tuple(self.to_device(a) for a in args)
        with tracer.span("executor.launch"):
            return self._fn(*on_device, **kwargs)

    def run_sync(self, *args: Any, **kwargs: Any) -> Any:
        """Run and materialize the results as numpy (blocking)."""
        return _materialize(self(*args, **kwargs))


class StreamExecutor:
    """Depth-N software pipeline over a DevicePipeline.

    ``submit(frame)`` copies the frame to the device, enqueues the chain,
    records a CUDA event behind it, and returns a list of completed older
    results (possibly empty). With ``async_fetch=True`` a worker thread
    waits on each event and materializes the result, overlapping readback
    with the next frame's upload (in-flight work is still capped at
    ``depth``). ``poll()`` returns already-finished results without
    blocking; ``flush()`` drains everything.
    """

    def __init__(
        self,
        pipeline: DevicePipeline,
        depth: int = 1,
        async_fetch: bool = False,
    ):
        if depth < 1:
            raise ValueError("pipeline depth must be >= 1")
        self.pipeline = pipeline
        self.depth = depth
        self.async_fetch = async_fetch
        self._dispatches = 0  # the id of the last dispatch submitted
        self._queue: "deque[Tuple[Any, Any, Any, int]]" = deque()  # sync mode
        if async_fetch:
            self._inflight: "queue.Queue" = queue.Queue()
            self._done: "queue.Queue" = queue.Queue()
            self._n_inflight = 0
            self._worker = threading.Thread(target=self._fetch_loop, daemon=True)
            self._worker.start()

    @staticmethod
    def _wait_and_fetch(fut: Any, event: Optional[torch.cuda.Event], dispatch: int) -> Any:
        with tracer.span("executor.event_wait", dispatch=dispatch):
            if event is not None:
                event.synchronize()
        with tracer.span("executor.d2h", dispatch=dispatch) as span:
            out = _materialize(fut)
            if span:
                span.set(bytes=_host_bytes(out))
        return out

    def _fetch_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                return
            fut, event, meta, dispatch = item
            try:
                self._done.put((self._wait_and_fetch(fut, event, dispatch), meta))
            except Exception as e:  # deliver failures in order too
                self._done.put((e, meta))

    @property
    def pending(self) -> int:
        if self.async_fetch:
            return self._n_inflight
        return len(self._queue)

    def submit(
        self, args: Tuple[Any, ...], meta: Any = None, **kwargs: Any
    ) -> List[Tuple[Any, Any]]:
        self._dispatches += 1
        dispatch = self._dispatches
        with tracer.span("executor.submit", dispatch=dispatch) as span:
            if span:
                span.set(frames=dispatch_frames(args), inflight=self.pending)
            fut = self.pipeline(*args, **kwargs)
            event = None
            if self.pipeline.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.pipeline.device))
            if not self.async_fetch:
                self._queue.append((fut, event, meta, dispatch))
                if len(self._queue) <= self.depth:
                    return []
                with tracer.span("executor.backpressure"):
                    out = self._pop_one()
                return [out] if out is not None else []
            self._inflight.put((fut, event, meta, dispatch))
            self._n_inflight += 1
            ready = self.poll()
            if self._n_inflight - len(ready) > self.depth:
                with tracer.span("executor.backpressure"):
                    while self._n_inflight - len(ready) > self.depth:
                        ready.append(self._pop_done_blocking())
            return ready

    def poll(self) -> List[Tuple[Any, Any]]:
        """Already-materialized results (async mode; [] in sync mode)."""
        out: List[Tuple[Any, Any]] = []
        if self.async_fetch:
            while True:
                try:
                    item = self._done.get_nowait()
                except queue.Empty:
                    break
                # decrement BEFORE _check may raise a worker-delivered
                # exception, or the popped item would inflate pending
                # forever and a later flush() would block on _done.get()
                self._n_inflight -= 1
                out.append(self._check(item))
        return out

    def _pop_done_blocking(
        self, timeout_s: Optional[float] = None
    ) -> Tuple[Any, Any]:
        item = self._done.get(timeout=timeout_s)  # raises queue.Empty
        self._n_inflight -= 1
        return self._check(item)

    @staticmethod
    def _check(item: Tuple[Any, Any]) -> Tuple[Any, Any]:
        if isinstance(item[0], Exception):
            raise item[0]
        return item

    def _pop_one(
        self, timeout_s: Optional[float] = None
    ) -> Optional[Tuple[Any, Any]]:
        if not self._queue:
            return None
        fut, event, meta, dispatch = self._queue[0]
        if timeout_s is None:
            self._queue.popleft()
            return self._wait_and_fetch(fut, event, dispatch), meta
        # bounded drain (shutdown): wait on a helper thread so a wedged
        # device can't hang the caller. On timeout the item stays queued
        # (pending accounting) for the caller to abandon; the daemon thread
        # dies with the process.
        box: dict = {}

        def _work() -> None:
            try:
                box["v"] = self._wait_and_fetch(fut, event, dispatch)
            except Exception as e:  # pragma: no cover - device-dependent
                box["e"] = e

        t = threading.Thread(target=_work, daemon=True)
        t.start()
        t.join(timeout_s)
        if t.is_alive():
            return None
        self._queue.popleft()
        if "e" in box:
            raise box["e"]
        return box["v"], meta

    def flush_one(
        self, timeout_s: Optional[float] = None
    ) -> Optional[Tuple[Any, Any]]:
        """Materialize the oldest in-flight result (blocking), or None.

        ``timeout_s`` bounds the wait in BOTH modes; on timeout the result
        stays in flight and None is returned."""
        if self.async_fetch:
            if self._n_inflight == 0:
                return None
            try:
                return self._pop_done_blocking(timeout_s)
            except queue.Empty:
                return None
        return self._pop_one(timeout_s)

    def flush(self, timeout_s: Optional[float] = None) -> List[Tuple[Any, Any]]:
        """Materialize every in-flight result, oldest first.

        ``timeout_s`` bounds the TOTAL drain (both modes): a device that
        never delivers must not be able to hang shutdown — remaining
        results stay in ``pending`` for the caller to abandon."""
        out: List[Tuple[Any, Any]] = []
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while self.pending:
            left = None
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
            item = self.flush_one(timeout_s=left)
            if item is None:
                break
            out.append(item)
        return out

    def close(self) -> None:
        if self.async_fetch:
            self._inflight.put(None)


class EmaTimer:
    """EMA stage timing (the reference's StageBenchmark pattern,
    reference capture_sources/zed.py:53-80)."""

    def __init__(self, alpha: float = 0.1, report_every_s: float = 3.0):
        self.alpha = alpha
        self.report_every_s = report_every_s
        self.stages: dict = {}
        self._last_report = time.monotonic()

    def record(self, stage: str, seconds: float) -> None:
        prev = self.stages.get(stage)
        self.stages[stage] = (
            seconds if prev is None else prev * (1 - self.alpha) + seconds * self.alpha
        )

    def maybe_report(self, log_fn: Callable[[str], None]) -> None:
        now = time.monotonic()
        if now - self._last_report >= self.report_every_s:
            self._last_report = now
            parts = ", ".join(
                f"{name}={sec * 1000:.2f}ms" for name, sec in self.stages.items()
            )
            log_fn(f"stage timings (EMA a={self.alpha}): {parts}")
