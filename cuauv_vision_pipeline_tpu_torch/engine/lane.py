"""A module's device lane: which fresh frames form one dispatch, how it goes
to the card, and how its results come back lane by lane.

``ModuleBase`` (core/base.py) reads the bus and offers each tick's frames
to the lane of its one ``@device_fn`` chain. The lane owns the policy:

* the chain's aliases, a ``$N`` placeholder bound to the first alias that
  arrives from the module's N-th video source;
* with ``batch > 1``, the read depth of the batched source and the backlog
  it drained: a dispatch carries the fresh frames only, the newest alone
  past ``latest_only_backlog``, else the last ``batch``, and on the first
  tick (before the source is batch-read) its single frame;
* the dispatch: ``build_packed_fn`` -> ``DevicePipeline`` ->
  ``StreamExecutor`` (engine/executor.py), the same three calls the
  benchmark harness makes, and the idle drain when no bundle is fresh;
* the deliveries: a batched result split per lane, oldest first, each with
  its own acquisition time and only the newest carrying posts
  (``meta.newest``);
* the bounded drain at shutdown, and the log lines that say how the
  dispatches ran.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass
from typing import AbstractSet, Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.tree import tree_map
from .executor import DevicePipeline, StreamExecutor, build_packed_fn, unpack_result

SHUTDOWN_DRAIN_S = 15.0  # a wedged device must not hang exit


@dataclass
class DeviceResultMeta:
    """Provenance of one device-chain result delivered to
    ``on_device_result``."""

    aliases: Tuple[str, ...]
    acquisition_time: int  # ms clock of the newest frame in the bundle
    submit_time: float  # time.monotonic() at submit
    want_posts: bool = True  # which packed-result spec this bundle used
    # batched chains: acquisition time of each FRESH lane (oldest first);
    # None for unbatched chains
    lane_acqs: Optional[List[int]] = None
    # False only for the non-final lanes of a batched delivery: the result
    # is a (drained) stale frame; posts are withheld and consumers that
    # only care about the freshest state may skip work
    newest: bool = True

    def latency_ms(self) -> int:
        """Camera-to-result latency of this bundle, in ms."""
        return int(time.monotonic() * 1000) - self.acquisition_time


# what on_device_result takes for one lane: (result, posts, meta)
Delivery = Tuple[Any, Dict[str, Any], DeviceResultMeta]


class DeviceLane:
    """The dispatch policy of one module's ``@device_fn`` chain ``fn`` (the
    bound method) on ``device``. Made once per module run (:meth:`find`);
    :meth:`open` starts it for each run loop and :meth:`close` ends it."""

    def __init__(self, fn: Callable, device: torch.device):
        target = getattr(fn, "__func__", fn)
        self.fn = fn
        self.device = device
        self.spec_aliases: Tuple[str, ...] = tuple(target._device_fn_aliases)
        self.depth: int = target._device_fn_depth
        self.async_fetch: bool = target._device_fn_async
        self.batch: int = target._device_fn_batch
        self.batch_mode: str = target._device_fn_batch_mode
        self.latest_only: Optional[int] = target._device_fn_latest_only
        if self.batch > 1 and len(self.spec_aliases) != 1:
            raise RuntimeError("@device_fn(batch=N) requires a single source spec")
        self.abandoned = False  # a close left in-flight results behind

    @classmethod
    def find(cls, module: Any, logger: Callable[..., None]) -> Optional["DeviceLane"]:
        """The lane of ``module``'s ``@device_fn`` method on its device, or
        None if it has none; more than one is an error."""
        found: Optional[DeviceLane] = None
        for attr_name in dir(module):
            try:
                maybe = getattr(module, attr_name)
            except Exception:
                continue
            if not getattr(getattr(maybe, "__func__", maybe), "_device_fn_aliases", None):
                continue
            if found is not None:
                raise RuntimeError(
                    f"{module.__class__.__name__} registers more than one "
                    "@device_fn; a module has exactly one device chain"
                )
            found = cls(maybe, module.device)
            logger(
                f"Registered device chain {attr_name} with aliases "
                f"{found.spec_aliases} (pipeline depth {found.depth}"
                f"{', async fetch' if found.async_fetch else ''}"
                f"{f', batch {found.batch}' if found.batch > 1 else ''})",
                True,
            )
        return found

    def open(self, sources: Sequence[str]) -> None:
        """Start a run loop's lane, its placeholders unbound and its
        executor new. ``sources``: the module's video source names, in
        order."""
        self.aliases = self.spec_aliases
        self._source_index = {name: i for i, name in enumerate(sources)}
        self._batch_source: Optional[str] = None
        self._backlog: Optional[Tuple[List[np.ndarray], List[int]]] = None
        # posts ride in the same packed fetch as the result (one
        # device->host copy a dispatch); each packed result carries its
        # own unpack spec
        self.packed = build_packed_fn(self.fn, self.batch, self.batch_mode)
        self.executor = StreamExecutor(
            DevicePipeline(self.packed, self.device), depth=self.depth, async_fetch=self.async_fetch
        )

    def read_request(self) -> Optional[Dict[str, int]]:
        """The batched source and how many unseen frames to drain from it
        this tick, for ``ModuleManager.read_messages``; None until a frame
        of it has arrived. With ``latest_only_backlog=M >= batch`` that is
        M+1, so the backlog check can see past the batch size (the bus ring
        bounds the drain; sources default to 8 slots)."""
        if self._batch_source is None:
            return None
        if self.latest_only is None:
            return {self._batch_source: self.batch}
        return {self._batch_source: max(self.batch, self.latest_only + 1)}

    def note(self, source: str, aliases: Sequence[str], message: Any) -> None:
        """A fresh frame of ``source`` whose planes are named ``aliases``
        (``message``: its ``VideoMessage``). A ``$N`` placeholder of the
        source binds to its first alias; the batched alias's drained
        backlog is kept for this tick's dispatch."""
        placeholder = f"${self._source_index.get(source, -1)}"
        if aliases and placeholder in self.aliases:
            self.aliases = tuple(aliases[0] if a == placeholder else a for a in self.aliases)
        if self.batch == 1 or self.aliases[0] not in aliases:
            return
        self._batch_source = source
        if message.batch_data:
            k = aliases.index(self.aliases[0])
            planes = isinstance(message.data, tuple)
            self._backlog = ([f[k] if planes else f for f in message.batch_data], list(message.batch_acqs))

    def offer(
        self,
        frame_cache: Dict[str, Tuple[np.ndarray, int]],
        updated: AbstractSet[str],
        tuners: Callable[[], Dict[str, Any]],
        want_posts: bool,
    ) -> Iterator[Delivery]:
        """Dispatch the chain if one of its aliases was read this tick
        (``updated``) and all are cached (``frame_cache``: alias -> (frame,
        acquisition time)), else take what the card has finished: it had a
        frame period. ``tuners()`` gives the chain's tuner values. Returns
        the deliveries now ready, oldest first."""
        if not (all(a in frame_cache for a in self.aliases) and any(a in updated for a in self.aliases)):
            return self._deliveries(self._idle_drain())
        if self.batch == 1:
            frames = tuple(frame_cache[a][0] for a in self.aliases)
            acq = max(frame_cache[a][1] for a in self.aliases)
            lane_acqs = None
        else:
            frames, lane_acqs = self._lanes(frame_cache)
            acq = lane_acqs[-1]
        meta = DeviceResultMeta(
            aliases=self.aliases,
            acquisition_time=acq,
            submit_time=time.monotonic(),
            want_posts=want_posts,
            lane_acqs=lane_acqs,
        )
        ready = self.executor.submit(frames, meta=meta, tuners=tuners(), want_posts=want_posts)
        return self._deliveries(ready)

    def _lanes(self, frame_cache: Dict[str, Tuple[np.ndarray, int]]) -> Tuple[Tuple[np.ndarray], List[int]]:
        """A batched dispatch's ``[lanes, ...]`` frames and the lanes'
        acquisition times, oldest first."""
        alias = self.aliases[0]
        # the first tick reads the source unbatched: its single frame
        frames, acqs = self._backlog or ([frame_cache[alias][0]], [frame_cache[alias][1]])
        self._backlog = None
        # latest-wins on demand (reference cmf.cpp:423): past the backlog
        # threshold, stale frames drop instead of batching. Checked on the
        # whole drained backlog, before the batch trim, else M >= batch
        # never fires
        keep = 1 if self.latest_only is not None and len(frames) > self.latest_only else self.batch
        frames, acqs = frames[-keep:], acqs[-keep:]
        # only the fresh lanes transfer and compute: a lone frame is a
        # [1,H,W,C] view, not a copy
        return (frames[0][None] if len(frames) == 1 else np.stack(frames),), acqs

    def _idle_drain(self) -> List[Tuple[Any, Any]]:
        if not self.executor.pending:
            return []
        if self.async_fetch:
            return self.executor.poll()
        done = self.executor.flush_one()
        return [] if done is None else [done]

    @staticmethod
    def _deliveries(ready: List[Tuple[Any, Any]]) -> Iterator[Delivery]:
        for (packed, spec), meta in ready:
            result, posts = unpack_result(packed, spec)
            if meta.lane_acqs is None:
                yield result, posts, meta
                continue
            # every leaf has a leading [lanes] axis. Posts go to the newest
            # lane only: older lanes would overwrite the same post blocks
            # several times a tick with frames no GUI reader will ever see
            last = len(meta.lane_acqs) - 1
            for i, acq in enumerate(meta.lane_acqs):
                yield (
                    tree_map(lambda x: x[i], result),
                    tree_map(lambda x: x[i], posts) if i == last else {},
                    dataclasses.replace(meta, acquisition_time=acq, newest=i == last),
                )

    def close(self, logger: Callable[..., None]) -> List[Delivery]:
        """End the run loop's lane: drain the in-flight results for at most
        ``SHUTDOWN_DRAIN_S``, stop the executor and log how its dispatches
        ran. Returns the drained deliveries, oldest first."""
        done = self.executor.flush(timeout_s=SHUTDOWN_DRAIN_S)
        if self.executor.pending:
            logger(
                f"abandoning {self.executor.pending} in-flight device "
                "result(s) at shutdown (device not delivering)",
                True,
            )
            self.abandoned = True
        self.executor.close()
        # how each dispatch ran: eagerly, or as a CUDA graph
        logger(f"graph calls: {json.dumps(self.packed.graph_counts)}", True)
        # how each camera array reached the card: staged or pageable
        logger(f"h2d copies: {json.dumps(self.executor.pipeline.h2d_counts)}", True)
        return list(self._deliveries(done))
