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
* **CUDA graphs** (``build_packed_fn`` returns a :class:`PackedFn`): on a
  card the packed call of each key (shapes, tuners, ``want_posts``) is
  captured on its ``CAPTURE_AT``-th call and replayed after, so a dispatch
  costs one graph launch where the eager chain makes ~150 launches a frame.
* **staged uploads** (:class:`DevicePipeline`): on a card each camera array
  is copied into a page-locked slot and sent by an async DMA on a copy
  stream that the compute stream waits on, so the upload of frame N+1
  overlaps frame N's chain.
* **spans** (``core/trace.py``, recorded while the tracer is enabled), each
  with the ``dispatch`` id ``submit`` gives: ``executor.submit`` (args
  ``frames``, ``inflight``), ``executor.h2d`` per camera array (``bytes``;
  on a card ``staged``: through a pinned slot, or pageable),
  ``executor.launch`` (the chain call; ``graph``: how it ran), ``executor.pack``,
  ``executor.backpressure`` (``submit`` held for a free slot),
  ``executor.event_wait`` and ``executor.d2h`` (``bytes``) on the thread that
  fetches: the worker with async fetch, else the caller.

There is no compile step: ``DevicePipeline.warmup`` just runs the chain once.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core.trace import tracer
from ..ops.cuda import add_launch_counts, launch_counts
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
) -> "PackedFn":
    """The callable ModuleBase dispatches for a @device_fn: runs the
    module's chain and packs ``(result, posts)`` for one fetch, returning
    ``(packed, spec)``; on a CUDA card it replays the call as a CUDA graph
    (:class:`PackedFn`).

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

    return PackedFn(packed_fn)


# ---------------------------------------------------------------------------
# CUDA graphs of a packed call
# ---------------------------------------------------------------------------

# how a packed call ran: the ``graph`` arg of its ``executor.launch`` span and
# the keys of ``PackedFn.graph_counts``
GRAPH_MODES = ("eager", "capture", "replay", "fallback")
MAX_KEYS = 4  # keys (seen, captured, or failed) kept per packed function
CAPTURE_AT = 4  # the call of a key that captures it; the calls before run eagerly


def _frozen(value: Any) -> Any:
    """A tuner value by value: numpy scalars and 0-d arrays as Python
    numbers. Raises TypeError for anything else that is not a Python
    scalar, a string or a tuple of them (a tensor hashes by identity)."""
    if isinstance(value, (np.generic, np.ndarray)):
        if np.ndim(value) != 0:
            raise TypeError(f"a tuner array of shape {np.shape(value)} has no key")
        value = value.item()
    if isinstance(value, tuple):
        return tuple(_frozen(v) for v in value)
    if value is None or isinstance(value, (bool, int, float, str)):
        return type(value), value
    raise TypeError(f"a tuner value of type {type(value).__name__} has no key")


def graph_key(args: Tuple[Any, ...], tuners: Any, want_posts: Any) -> Optional[tuple]:
    """What a packed call's graph depends on besides its input values:
    each argument's shape, dtype and device, the tuner values (frozen),
    and ``want_posts``. None when an argument is not a tensor or a tuner
    has no hashable value: that call runs eagerly."""
    if not all(isinstance(a, torch.Tensor) for a in args):
        return None
    try:
        frozen = tuple(sorted((k, _frozen(v)) for k, v in tuners.items()))
    except (TypeError, AttributeError):
        return None
    return tuple((tuple(a.shape), a.dtype, a.device) for a in args), frozen, bool(want_posts)


def _on_one_card(args: Tuple[Any, ...]) -> bool:
    return bool(args) and all(a.is_cuda for a in args) and len({a.device for a in args}) == 1


class _Graph:
    """One packed call captured as a CUDA graph: the static inputs it
    reads, and the packed vector and spec it writes on each replay.

    The capture runs on a side stream in ``thread_local`` error mode, so the
    async fetch thread may wait on an event or copy a result meanwhile. A
    call that waits for the host (``.item()``, a copy from host memory)
    cannot be captured: the constructor then ends the capture, releases its
    memory pool and raises RuntimeError. ``torch.cuda.graph``'s context is
    not used: it synchronises the card and empties the allocator's cache at
    every capture."""

    def __init__(self, run: Callable, args: Tuple[torch.Tensor, ...]):
        dev = args[0].device
        self.inputs = tuple(a.clone() for a in args)
        self.graph = torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                self.packed, self.spec = run(*self.inputs)
            except BaseException:
                _abandon_capture(self.graph, dev, pool)
                raise
            try:
                self.graph.capture_end()
            except RuntimeError:
                _release_pool(dev, pool)
                raise
        torch.cuda.current_stream(dev).wait_stream(side)

    def matches(self, out: Tuple[torch.Tensor, PackSpec]) -> bool:
        """Replay once on the captured inputs and compare with the eager
        ``out`` of the same call (waits for the card)."""
        packed, spec = out
        self.graph.replay()
        return spec == self.spec and torch.equal(self.packed, packed)

    def replay(self, args: Tuple[torch.Tensor, ...]) -> None:
        """Copy ``args`` into the static inputs and replay: ``packed`` then
        holds this call's result until the next replay."""
        for static, a in zip(self.inputs, args):
            static.copy_(a)
        self.graph.replay()

    def close(self) -> None:
        """Drop the graph once the card has finished its last replay, and
        give its memory pool back to the card: a released pool stays
        reserved until the allocator's cache is emptied, and a capture
        cannot empty it, so without this dropped graphs fill the card."""
        torch.cuda.synchronize(self.inputs[0].device)
        self.graph.reset()
        torch.cuda.empty_cache()


def _abandon_capture(graph: "torch.cuda.CUDAGraph", dev: torch.device, pool: Any) -> None:
    """End a capture whose call raised. One that was not invalidated ends
    as a partial graph, which frees its pool when dropped; an invalidated
    one raises in ``capture_end``, and its pool is released here."""
    try:
        graph.capture_end()
    except RuntimeError:
        _release_pool(dev, pool)


def _release_pool(dev: torch.device, pool: Any) -> None:
    """Stop the allocator routing into the pool of a capture that failed
    to end, and release the pool: a graph whose capture never ended does
    not release it itself."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    for step in (torch._C._cuda_endAllocateToPool, torch._C._cuda_releasePool):
        try:
            step(index, pool)
        except RuntimeError:
            pass  # this torch's capture_end did it before it raised


class PackedFn:
    """A packed call (``run(*args, tuners=..., want_posts=...)`` ->
    ``(packed, spec)``) that replays as a CUDA graph on a card.

    Per :func:`graph_key`: the first ``CAPTURE_AT - 1`` calls of a key run
    eagerly (kernel builds, cached tables, library workspaces: every
    first-use job); the next captures the call, replays it once and runs it
    eagerly on the same inputs, keeping the graph only if the two packed
    vectors are byte-equal; later calls copy their arguments into the
    graph's inputs, replay, and return a copy of the graph's packed vector
    (the next replay overwrites it while the fetch thread may still be
    reading this one). A capture that raises, or a replay that differs,
    marks the key failed: its calls run eagerly while it is kept. At most
    ``MAX_KEYS`` keys are kept, least recently used out (a dropped graph's
    memory goes back to the card); a key dropped and seen again starts
    over. CPU tensors, and keys that do not hash, always run eagerly.

    Each call tags the ``executor.launch`` span it runs in with ``graph``:
    one of ``GRAPH_MODES`` (``fallback``: eager on a failed key), and
    counts it in ``graph_counts``. A replay runs no Python of the chain, so
    the chain's spans do not fire; its ``executor.pack`` span holds the
    copy of the packed vector, and the hand kernels' ``launches`` counters
    gain the launches the capture counted."""

    def __init__(self, run: Callable):
        self._run = run
        # per key: the calls it ran eagerly (an int), its _Graph, or None once failed
        self._keys: "OrderedDict[tuple, Any]" = OrderedDict()
        self.graph_counts = dict.fromkeys(GRAPH_MODES, 0)

    def __call__(self, *args: Any, tuners: Any, want_posts: Any) -> Tuple[torch.Tensor, PackSpec]:
        mode, out = self._call(args, lambda *a: self._run(*a, tuners=tuners, want_posts=want_posts),
                               graph_key(args, tuners, want_posts))
        self.graph_counts[mode] += 1
        tracer.annotate(graph=mode)
        return out

    def _call(self, args: Tuple[Any, ...], run: Callable, key: Optional[tuple]) -> Tuple[str, Any]:
        if key is None or not _on_one_card(args):
            return "eager", run(*args)
        entry = self._keys.get(key, 0)
        if entry is None:
            self._keys.move_to_end(key)
            return "fallback", run(*args)
        if not isinstance(entry, int):
            self._keys.move_to_end(key)
            entry.replay(args)
            add_launch_counts(entry.launches)
            with tracer.span("executor.pack"):
                return "replay", (entry.packed.clone(), entry.spec)
        if entry + 1 < CAPTURE_AT:
            self._keep(key, entry + 1)
            return "eager", run(*args)
        before = launch_counts()
        try:
            graph = _Graph(run, args)
        except RuntimeError:
            # the wrappers counted launches the failed capture never made
            add_launch_counts({name: before[name] - n for name, n in launch_counts().items()})
            self._keep(key, None)
            return "fallback", run(*args)
        # what a replay launches; the capture's own count stands for the
        # check's replay below
        graph.launches = {name: n - before[name] for name, n in launch_counts().items()}
        out = run(*args)
        if not graph.matches(out):
            graph.close()
            self._keep(key, None)
            return "fallback", out
        self._keep(key, graph)
        return "capture", out

    def _keep(self, key: tuple, entry: Any) -> None:
        self._keys[key] = entry
        self._keys.move_to_end(key)
        while len(self._keys) > MAX_KEYS:
            dropped = self._keys.popitem(last=False)[1]
            if isinstance(dropped, _Graph):
                dropped.close()


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


SLOTS = 2  # page-locked staging buffers per argument position


class _Slot:
    """A page-locked staging buffer, grown to the largest array it has
    held, and the event of the last DMA that read it."""

    __slots__ = ("buf", "event")

    def __init__(self) -> None:
        self.buf: Optional[torch.Tensor] = None
        self.event = torch.cuda.Event()


class DevicePipeline:
    """A frame chain bound to one device.

    ``fn`` is any callable over tensors. Call sites pass numpy arrays or
    tensors; numpy arrays are copied to ``device`` first. Results are
    device tensors (launched, not waited for).

    On a CUDA device each numpy array is staged: copied on the host into
    the next of its argument position's ``SLOTS`` page-locked buffers, then
    sent by an async DMA on the pipeline's copy stream, which the current
    (compute) stream waits on. So the copy neither holds the host for the
    DMA nor waits behind the work already queued on the compute stream.
    ``to_device`` returns once the host copy is done: the caller may reuse
    its array at once. A position whose pinned allocation fails copies
    pageable from then on; ``h2d_counts`` counts both kinds. On the CPU the
    tensor shares the array's memory."""

    def __init__(self, fn: Callable, device: torch.device):
        self._fn = fn
        self.device = torch.device(device)
        self.h2d_counts = {"staged": 0, "pageable": 0}
        # per argument position: its slots in the order they are taken, or
        # None once a pinned allocation failed there
        self._slots: "dict[int, Optional[deque[_Slot]]]" = {}
        self.copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def to_device(self, a: Any, position: int = 0) -> Any:
        """``a`` on the device if it is a numpy array (``position``: its
        index among the call's arguments), else ``a`` itself."""
        if not isinstance(a, np.ndarray):
            return a
        with tracer.span("executor.h2d", bytes=a.nbytes) as span:
            src = torch.from_numpy(a)
            if self.device.type != "cuda":
                return src.to(self.device)
            slot = self._slot(position, a.nbytes)
            span.set(staged=slot is not None)
            if slot is None:
                self.h2d_counts["pageable"] += 1
                return src.to(self.device)
            self.h2d_counts["staged"] += 1
            return self._stage(src, slot)

    def _slot(self, position: int, nbytes: int) -> Optional[_Slot]:
        """The next slot of ``position``, free (its last DMA has read it)
        and holding at least ``nbytes``; None if the position copies
        pageable."""
        if position not in self._slots:
            self._slots[position] = deque(_Slot() for _ in range(SLOTS))
        slots = self._slots[position]
        if slots is None:
            return None
        slot = slots[0]
        slots.rotate(-1)
        slot.event.synchronize()
        if slot.buf is None or slot.buf.numel() < nbytes:
            slot.buf = None
            try:
                slot.buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            except RuntimeError:
                self._slots[position] = None
                return None
        return slot

    def _stage(self, src: torch.Tensor, slot: _Slot) -> torch.Tensor:
        staged = slot.buf[: src.numel() * src.element_size()].view(src.dtype).view(src.shape)
        staged.copy_(src)
        compute = torch.cuda.current_stream(self.device)
        # allocated on the copy stream, so the block is not one the compute
        # stream has freed but may still be reading
        with torch.cuda.stream(self.copy_stream):
            dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            dst.copy_(staged, non_blocking=True)
            slot.event.record(self.copy_stream)
        compute.wait_event(slot.event)
        # the allocator must not hand the block back to the copy stream
        # while the compute stream still reads it
        dst.record_stream(compute)
        return dst

    def warmup(self, *args: Any, **kwargs: Any) -> None:
        """Run the chain once and wait for it (there is nothing to compile;
        this takes first-use costs such as a kernel build off the stream)."""
        self(*args, **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        on_device = tuple(self.to_device(a, i) for i, a in enumerate(args))
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
