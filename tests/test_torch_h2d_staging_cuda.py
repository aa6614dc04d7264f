"""Each camera array staged through page-locked slots on a copy stream
(``DevicePipeline.to_device`` on a card), through ``StreamExecutor`` with
the module's depth and async fetch, on the 32 seeded 1080p scenes
(``benchmark/scenes.py``), twice round the ring.

* ``BuoyLAB.buoy_chain`` (4 lanes), ``BuoyStereo.stereo_chain`` and
  ``Yolo.detect_chain``: every packed result byte-equal to the same chain
  fed by ``torch.from_numpy(a).to(dev)``, though each submitted source
  array is overwritten as soon as ``submit`` returns.
* Slots reused while their DMAs are held back on the copy stream, with
  more dispatches in flight (their chains held back on the compute
  stream) than slots per position.
* One position fed ``[1,H,W,C]``, then ``[4,H,W,C]``, then ``[1,H,W,C]``.
* ``h2d_counts``: every array staged and none pageable; a position whose
  pinned allocation fails copies pageable from then on, and its
  ``executor.h2d`` spans say ``staged`` False.

Needs a CUDA card and skips without one. It imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_h2d_staging_cuda.py
"""

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)
from test_torch_executor_graph_cuda import _scenes, _tuners, _yolo

from cuauv_vision_pipeline_tpu_torch.core.trace import tracer
from cuauv_vision_pipeline_tpu_torch.engine.executor import (
    SLOTS,
    DevicePipeline,
    StreamExecutor,
    build_packed_fn,
)
from cuauv_vision_pipeline_tpu_torch.modules.red_buoy import BuoyLAB
from cuauv_vision_pipeline_tpu_torch.modules.red_buoy_stereo import BuoyStereo

pytestmark = pytest.mark.cuda

# ~40 ms of the card's clock: longer than the host takes for two dispatches
# (a fresh 25 MB source copied, submitted, overwritten)
HOLD_CYCLES = 80_000_000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def serve(fn, dispatches, tuners, dev, depth=None, hold=False):
    """Submit each dispatch's arrays (fresh copies, overwritten once
    ``submit`` returns) as ModuleBase does; assert every result byte-equal
    to the eager chain on the unstaged originals. Returns the pipeline and
    the dispatches in flight at each submit. ``hold`` queues a wait before
    each dispatch on the copy stream, so its DMAs are still pending when
    the host comes back to their slots, and a longer one on the compute
    stream, so dispatches pile up in flight."""
    packed_fn = build_packed_fn(fn, fn._device_fn_batch, fn._device_fn_batch_mode)
    pipe = DevicePipeline(packed_fn, dev)
    ex = StreamExecutor(pipe, depth=depth or fn._device_fn_depth, async_fetch=fn._device_fn_async)
    served, inflight = [], []
    try:
        for i, args in enumerate(dispatches):
            sources = tuple(a.copy() for a in args)
            if hold:
                with torch.cuda.stream(pipe.copy_stream):
                    torch.cuda._sleep(HOLD_CYCLES)
                torch.cuda._sleep(2 * HOLD_CYCLES)
            inflight.append(ex.pending)
            served.extend(ex.submit(sources, meta=i, tuners=tuners, want_posts=False))
            for a in sources:
                np.bitwise_not(a, out=a)  # the caller reuses its array at once
        served.extend(ex.flush())
    finally:
        ex.close()
    assert [meta for _, meta in served] == list(range(len(dispatches)))
    bad = []
    for (packed, spec), i in served:
        want, want_spec = packed_fn._run(*(torch.from_numpy(a).to(dev) for a in dispatches[i]),
                                         tuners=tuners, want_posts=False)
        assert spec == want_spec, i
        if not np.array_equal(packed, want.cpu().numpy()):
            bad.append(i)
    assert not bad, f"dispatches {bad} differ from the chain fed pageable copies"
    assert len({packed.tobytes() for (packed, _), _ in served}) > 1  # the dispatches differ
    return pipe, inflight


def _buoy():
    return BuoyLAB.buoy_chain.__get__(BuoyLAB.__new__(BuoyLAB))


def _all_staged(pipe, dispatches):
    assert pipe.h2d_counts == {"staged": sum(len(d) for d in dispatches), "pageable": 0}


def test_buoy_chain_with_4_lanes(dev):
    frames = _scenes("stream", dev)
    batches = [(np.ascontiguousarray(frames[i:i + 4]),) for i in range(0, 32, 4)] * 2
    pipe, _ = serve(_buoy(), batches, _tuners(140), dev)
    _all_staged(pipe, batches)


def test_stereo_chain(dev):
    frames = _scenes("stereo", dev)
    pairs = [(frames[i], frames[i + 1]) for i in range(0, 32, 2)] * 2
    pipe, _ = serve(BuoyStereo.stereo_chain.__get__(BuoyStereo.__new__(BuoyStereo)), pairs,
                    _tuners(140), dev)
    _all_staged(pipe, pairs)


def test_yolo_detect_chain(dev):
    from cuauv_vision_pipeline_tpu_torch.modules.yolo import Yolo

    frames = _scenes("stream", dev)
    singles = [(frames[i],) for i in range(32)] * 2
    pipe, _ = serve(_yolo(Yolo, dev).detect_chain, singles, {}, dev)
    _all_staged(pipe, singles)


def test_slots_are_reused_only_after_their_dma_with_more_dispatches_in_flight_than_slots(dev):
    frames = _scenes("stream", dev)
    batches = [(np.ascontiguousarray(frames[i:i + 4]),) for i in range(0, 32, 4)] * 2
    pipe, inflight = serve(_buoy(), batches, _tuners(140), dev, depth=2 * SLOTS, hold=True)
    assert max(inflight) > SLOTS
    _all_staged(pipe, batches)


def test_one_position_takes_1_then_4_then_1_lanes(dev):
    frames = _scenes("stream", dev)
    lanes = [1, 4, 1] * 6  # three shapes on two slots: each slot holds each size in turn
    batches, at = [], 0
    for n in lanes:
        batches.append((np.ascontiguousarray(frames[at % 32:at % 32 + n]),))
        at += 4
    pipe, _ = serve(_buoy(), batches, _tuners(140), dev)
    _all_staged(pipe, batches)


def test_a_position_whose_pinned_allocation_fails_copies_pageable(dev, monkeypatch):
    empty = torch.empty
    failed = []

    def first_pinned_fails(*args, **kwargs):
        if kwargs.get("pin_memory") and not failed:
            failed.append(args)
            raise RuntimeError("pinned allocation refused")
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", first_pinned_fails)
    frames = _scenes("stereo", dev, n=16)
    pairs = [(frames[i], frames[i + 1]) for i in range(0, 16, 2)]
    was = tracer.enabled
    tracer.clear()
    tracer.enable()
    try:
        pipe, _ = serve(BuoyStereo.stereo_chain.__get__(BuoyStereo.__new__(BuoyStereo)), pairs,
                        _tuners(140), dev)
        h2d = [e.args for e in tracer.events() if e.name == "executor.h2d"]
    finally:
        if not was:
            tracer.disable()
        tracer.clear()
    assert failed
    # the left eye (position 0) met the failure and copies pageable; the right eye stages
    assert pipe.h2d_counts == {"staged": len(pairs), "pageable": len(pairs)}
    assert h2d == [{"bytes": frames[0].nbytes, "staged": False},
                   {"bytes": frames[0].nbytes, "staged": True}] * len(pairs)
